#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each a hard check (any failure exits non-zero and prints no result):

  1. device and build: the card's name and power limit; the CUDA kernels
     built from ``src/repro_torch/csrc/`` into ``build/kernels/``; the
     library's resource usage (``cuobjdump --dump-resource-usage``), gated
     at no local memory (no spill) for the decode and prefill bodies'
     constant-shape 8:16 instantiations, with 16:256 outliers (the fused
     kernel) and without (``nm_spmm``), for ``outlier_spmm``'s two bodies
     and for ``paged_attention``'s decode and prefill-chunk bodies (hd 64,
     80, 128, 192 and 256);
  2. kernels against their plain PyTorch versions at the llama3-8b
     projection shapes ([4096->4096], [4096->1024], [4096->14336],
     [14336->4096]) and M in {1, 8, 37, 512}, both kernels (the fused one on
     8:16+16:256 weights, ``nm_spmm`` on plain 8:16) in both variants (bf16
     N:M values, and int8 values quantized from the same draws), timed with
     CUDA events beside the plain version, one ``F.linear`` on the
     densified weight (the library yardstick, never called by the port) and
     the card's bound.  Each wrapper takes its decode kernel
     (``csrc/fused_sparse_linear.cu``) at M <= T and its prefill kernel
     (``csrc/fused_sparse_linear_prefill.cu``) above, ``nm_spmm`` their
     instances without an outlier stream; two calls must give the same
     bits, and the old tile kernel (``csrc/sparse_linear.cu``) is timed
     beside either (``tile_ms``, reported).  Then the sweep that sets T:
     each wrapper's decode and prefill kernels and the old tile, both
     variants, at w_gate and w_down for M in ``SWEEP_MS``, each case gated
     against the plain version, the times reported; and the same for
     ``outlier_spmm``'s two bodies and its old kernel at 16:256 and 4:256
     for M in ``OUTLIER_SWEEP_MS``;
  3. a small-model reference check: the llama-paper smoke model served one
     step on the card (bf16, kernels), on the slot layout and on shuffled
     paged blocks, against the same weights in f32 on the CPU (plain
     versions, slot layout); and again with int8 weights on int8 KV
     arenas, against the same int8 weights and int8 KV in f32 on the CPU;
  4. the main path: llama3-8b at full width and depth with every projection
     deployed as 8:16+16:256, served through ``ServingEngine`` (8 slots,
     max_len 1024, 8 greedy requests with prompts of 64..768 tokens, token
     budget 512, 32 new tokens each); the fused kernel must launch exactly
     7 x 32 times per model call;
  5. plain 8:16 (no outliers) at 4 layers, full width, which puts
     ``nm_spmm`` on the engine path; then the same with int8 values, which
     puts ``nm_spmm``'s int8 variant there; each gated as the fused serves
     are (decode + prefill launches == the wrapper's, both > 0), with a
     decode and a prefill profile;
  2b. ``paged_attention`` against its plain version at llama3-8b's attention
     shapes (H 32, KV 8, hd 128, block size 16): decode (S=1, B=8, cursors
     up to 1000), chunks (S=512 at cursor 256; S=64 over 4 lanes, with and
     without a 128-token window), shuffled trash-padded block tables, on
     bf16 arenas and on int8 arenas quantized from the same K/V; the plan
     takes the split-KV decode body (``csrc/paged_attention_decode.cu``,
     held row by row at 2^-7 of each row's largest output) at S * n_rep
     <= T and the prefill-chunk body (``csrc/paged_attention_prefill.cu``)
     above; two calls must give the same bits; timed beside the plain
     version, the old kernel
     (``csrc/paged_attention.cu``, forced by ``Plan("tile")``, gated too)
     on the same inputs (``old_ms``), one ``scaled_dot_product_attention``
     on the pre-gathered (dequantized) K/V (the library yardstick, never
     called by the port) and the card's bound.  Then the sweep that sets
     T: the decode body, the prefill-chunk body and the old kernel forced
     at the decode case's lanes and at 8 short lanes through serve-wide
     tables (``ATTN_SWEEP_SHORT``) for S in ``ATTN_SWEEP_S``, bf16 and
     int8, each gated; T from the decode body against the prefill-chunk
     body at the decode case's lanes, the short lanes' count beside it.
     And the same gate and times at hd 256 (gemma-7b: H 16, KV 16), hd
     192 (nemotron-4-340b: H 96, KV 8), hd 80 (zamba2-2.7b's shared
     attention: H 32, KV 32) and hd 128 at llama4-maverick's 5 q heads a
     KV head (H 40, KV 8) for the decode case and the 512-token chunk,
     bf16 and int8 arenas; nemotron's decode rows (12) take the
     prefill-chunk body, so its decode case also runs the decode body
     forced; no old kernel there (it takes hd 64 and 128 only);
  6. the paged layout: the phase-4 model served by
     ``ServingEngine(kv_layout="paged", block_size=16)``, with the paged
     kernel launching once per layer per model call (decode steps on its
     decode body, prefill chunks on its prefill-chunk body, both > 0):
       (a) phase 4's traffic, with decode profile, prefill profile (one
           512-token chunk: device ms and launches by kernel class, busy
           share) and greedy agreement with phase 4's slot streams
           (reported, not gated);
       (b) prefix sharing: 8 requests on one 512-token prefix in two waves of
           4, the second after the first wave's prefills; gates prefix-cache
           hits, hit tokens >= 4 x 512 and a copy-on-write;
       (c) block pressure: (a)'s traffic with half the blocks it needs at
           once; gates preemptions;
  7. int8: llama3-8b at full width and depth with int8 8:16 values and
     bf16 16:256 outliers, served by ``ServingEngine(kv_layout="paged",
     kv_dtype="int8", block_size=16)``, with the int8 weight kernel
     launching 7 x 32 times and the int8 paged kernel 32 times per model
     call:
       (a) phase 4's traffic in 512 blocks, with decode profile and greedy
           agreement with 6(a)'s streams (reported, not gated);
       (b) the same traffic in the device memory of 6(c)'s bf16 arena
           (109 x 2 x 128 / 132 = 211 blocks); gates its arena bytes, scales
           included, at most 6(c)'s; reports peak concurrency and
           preemptions beside 6(c)'s.

 13. the dense family's other members at full width (run after phase 7,
     when the card holds no model), each 8:16+16:256 by magnitude, built
     from seed 0 one layer at a time; each projection shape phase 2 does
     not run goes through phase 2's gate at M 8 and 512 first, then one
     512-token chunk call (the longest prompt's first tokens, at cursor 0)
     is held against the same call through the plain versions on the card
     (``MODEL_TOL_REL`` of the logits' scale, as phase 3); every serve is
     gated on its launches (fused kernel: projections x layers a model
     call, by body; paged attention: layers a model call, by body):
       (a) qwen3-8b (qk_norm), 36 layers: phase 4's traffic paged (blocks
           of 16), then slot; gates the slot and paged streams equal up to
           a divergence at a near-tie (``near_tie_bound``, as phase 11);
       (b) gemma-7b (hd 256, GeGLU, tied head), 28 layers: phase 4's
           traffic in 512 blocks, bf16 then int8 KV (both attention bodies
           at hd 256); the int8 streams' agreement with the bf16 ones
           reported, as phase 7 reports its own;
       (c) nemotron-4-340b (hd 192, squared ReLU), full width cut to 2 of
           its 96 layers: 4 requests of 64..256 tokens, 16 new tokens each,
           paged; the log line gives embed and head, compressed layers and
           one dense layer in transit, in GB.
 14. the recurrent families at full width (run right after phase 13), each
     8:16+16:256 by magnitude from seed 0, built one layer at a time; each
     new projection shape through phase 2's gate at M 8 and 512 (xLSTM's
     8,192-row ``w_slstm``, Zamba2's 10,448-row ``in_proj``), phase 4's
     traffic, every serve gated on its launches a model call (the fused
     kernel: an mLSTM layer's 5 projections, an sLSTM layer's 3, a mamba
     layer's 2 and the shared block's 7 an application; paged attention:
     one an application, by body):
       (a) xlstm-350m (ssm), 12 of its 24 layers (``RECURRENT_LAYERS``,
           a cut for the script's wall; sLSTM every 8th): the slot layout
           with a decode and a prefill profile and one decode step whose
           every kernel launch is held against its plain version on the
           same inputs (``decode_in_context``), then 4 slots with the
           youngest running request preempted every 4 steps while another
           waits (``force_preemption``): gates preemptions > 0, a swap
           resume (prefill tokens at most the prompts' plus one a
           preemption: no recompute) and every stream equal to the
           unpressured run's up to a divergence at a near-tie
           (``near_tie_bound`` over ``residual_roundings``);
       (b) zamba2-2.7b (hybrid), 27 of its 54 mamba layers and 4
           applications of the shared attention (hd 80, H 32, KV 32): one
           512-token chunk call with every kernel launch (82 weight, 4
           attention) held
           against its plain version on the same inputs; at the
           reference's random init the model is ill-conditioned (one bf16
           ulp on one embedding element moves its logits by much of their
           scale), so its end-to-end difference from the plain call is
           reported beside that one-ulp control, not gated; then paged
           (block 16, prefix caching asked for and off: no prefix cache in
           the pool) with profiles and a decode step checked in context,
           then slot; the slot and paged streams compared (identical
           streams, each first divergence with its gaps and the one-ulp
           sensitivity there; reported, not gated, as the model's
           conditioning makes token choices rounding-dependent), and
           ``kv_dtype="int8"`` refused with ValueError.
     Reported: decode step p50, tok/s, TTFT, peak memory, launches and
     device ms a decode step by kernel class, with the card's name and
     power limit (``recurrent.device``).
 15. the moe and encdec families (run right after phase 14), each
     8:16+16:256 by magnitude from seed 0, built one layer at a time (a
     moe layer's routed experts stay dense bf16, drawn one expert at a
     time); each new projection shape through phase 2's gate at M 8 and
     512 (whisper's also at 1,500, its encoder's rows); every serve gated
     on its launches a model call (the fused kernel: 4 attention
     projections a moe layer plus llama4's 3 shared-expert ones, an
     enc-dec decoder layer's 8 a step call and 6 an encoder layer plus 2 a
     decoder layer an encoder call; paged attention: one a layer, by
     body), and reporting decode step p50, tok/s, TTFT p50/p99 and the
     ``"families"`` block of ``summarize``, peak memory and a decode and
     a prefill profile:
       (a) mixtral-8x7b at full width cut to 8 of 32 layers (22.5 GB of
           dense experts): one MoE layer against its per-token f32
           computation (``moe_layer_gate``: the choices against the f64
           router, differing only at near-ties; the outputs within
           ``MOE_TOL_REL``) on a decode batch and a 512-token chunk; one
           512-token chunk call with every kernel launch held against its
           plain version on the same inputs, its end-to-end difference
           reported beside the one-ulp control and the routings that
           differ (a top-2 router at random init turns one rounding into
           another expert: ill-conditioned, as zamba2); phase 4's traffic
           paged (a decode step held in context) then slot, the streams'
           divergences reported with their one-ulp sensitivity; the
           distinct experts a decode call routes to;
       (b) llama4-maverick-400b-a17b at full width cut to 1 of 48 layers
           (128 experts, 32.2 GB): the same layer and chunk checks, 4
           requests of 64..256 tokens, 16 new tokens each, paged;
       (c) whisper-medium at full size (24 + 24 layers), slot, 8 slots of
           448 tokens, 1,500 encoder frames a request: the encoder and a
           224-token chunk call with every launch held in context (192 +
           192) and end to end within ``MODEL_TOL_REL``; 8 requests of
           seeded random frames and 4..224-token prompts, 32 new tokens
           each, with a decode step checked in context; then 4 slots with
           the youngest running request preempted every 4 steps: gates
           preemptions, swap resumes (no recompute, no second encoder
           call) and streams equal to the unpressured run's up to a
           near-tie.

  8. the paper's pipeline on llama3-8b, full width and depth, from seed 0
     (the same dense weights phase 4 compressed by magnitude):
       (a) calibrate: the dense bf16 model's own forward over 4
           ``SyntheticLM`` batches of 4 x 512 tokens (8,192 tokens) collects
           each projection's input statistics; gates 7 x 32 leaves, finite
           values and counts of 8,192;
       (b) compress with the reference's defaults, RIA + SmoothQuant +
           variance correction, to 8:16 + 16:256, one layer at a time on the
           card; gates the containers (bf16 values, 16 distinct outlier
           indices per group, the N:M invariant, W_nm zero at every salient
           slot), layer 0's indices against the same pipeline on the CPU from
           the same bf16 weights and statistics (agreement >= 0.999: only
           reduction orders differ, so only near-ties may flip) and layer 0
           in the unstructured mode (salient density 16/256 within one
           entry);
       (c) serve phase 6(a)'s traffic from the compressed params on the
           paged layout in 512 blocks, with the fused and paged kernels'
           launches gated per model call as in phase 6;
       (d) the ``kernels/ops`` path on layer 0's four projection shapes with
           16:256, 8:256 and 4:256 outliers, M in {1, 8, 37, 512}: each
           ``ops.outlier_matmul`` launches ``outlier_spmm`` (kernel B4:
           its decode body at M <= T, its prefill body above, each
           counted), gated at one bf16 ulp against its plain version, the
           same bits on two calls, and timed beside it, the old kernel
           (``csrc/outlier_spmm_gather8.cu``, ``old_ms``), ``F.linear`` on
           the densified outlier matrix and the bound (the gather ceiling,
           worked out, in the log and the ops section of the JSON);
           at 16:256 the unfused ``ops.nm_matmul + ops.outlier_matmul``
           against the fused ``ops.sparse_linear_apply``, both timed;
       (e) perplexity (reported, not gated: the weights are random) of the
           dense model, of ``sparsify_model``'s dense-effective weights and
           of the compressed params, over 2 batches of 2 x 512 tokens; gates
           the compressed params' forward (fused kernel) against the
           dense-effective params' (``torch.matmul``) on one batch.

  9. trace replay with observability (run after phase 6, on phase 4's
     params): a fixed-seed Poisson trace (16 requests at 4/s, prompts of
     64..768 tokens, 32 new tokens each, greedy) written with
     ``save_trace`` under ``chiprun_out/``, read back with ``load_trace``
     and replayed through the CLI's ``launch/serve.run_trace`` on phase
     6(a)'s paged engine (512 blocks of 16, 8 slots, max_len 1024, token
     budget 512), every run's launches gated per model call as in phase 6:
       (a) at time scale 0, untraced and then traced (``ServingTracer``):
           gates identical greedy streams request by request, 16 finished,
           0 rejected;
       (b) the traced run's Perfetto file (``chiprun_out/phase9_trace.json``
           and its ``.counters.txt``): gates the port's
           ``validate_trace_events``, every ``request_summary`` against its
           request's ``RequestMetrics``, the span names, 512 decoded
           tokens and the prefilled-token counter against the engine's
           count, and the attribution's calls against the model calls;
       (c) at time scale 1.0, traced (reported, not gated): the
           ``format_summary`` line, each model-call variant's calls,
           steady mean wall and issue time (host time until the call
           returned), FLOPs and bytes from ``launch/step_cost.py``, the
           engine spans' host ms per step, the p50 of decode-only steps
           and of steps with a chunk, and (a)'s untraced and traced
           tok/s.

 11. speculative decoding (run right after phase 9, on phase 4's params):
     phase 6(a)'s paged engine (512 blocks of 16, 8 slots, max_len 1024,
     token budget 512), phase 4's 8 greedy prompts of 64..768 tokens (or
     (b)'s), 32 new tokens each, k = 4 adapting up to 8; each speculative
     serve traced (``ServingTracer``) beside the same target served plain
     and traced in the same run, launches gated per model call of the
     target and of the draft model (``spec_launch_check``), and the
     launches of each kernel body in the verify calls counted by their
     [B x S] shape:
       (a) the paper's pair: phase 4's 8:16+16:256 params draft (fused
           kernel) for ``densify_params`` of them (dense bf16,
           ``F.linear``): gates 8/8 finished, acceptance >= 0.9 (the
           reference's bar), more than 1 accepted token a step, the
           fused kernel launched 7 x 32 times a draft call and never by
           the target, and verify calls on paged attention's
           prefill-chunk body;
       (b) n-gram self-drafting on phase 4's compressed target, prompts of
           a random 48-token segment repeated 4 times: gates drafted > 0
           and the verify calls at [8 x 8] (M = 64) launching the fused
           kernel's prefill body 7 x 32 times each;
       (c) the CLI: ``launch/serve.run_engine`` with ``--draft sparse
           --kv-layout paged`` on llama3-8b cut to 4 layers (a dense target
           drafted by its own magnitude compression, ``spec_cli``): gates
           every request finished; acceptance, each step's wall (to a
           synchronize; the decode step's p50) and the collectives a
           model call issues by kind reported (phase 19(a)'s reference);
       and the stream gate on (a) and (b): each speculative stream equals
       the plain one up to its first divergence, where one ``forward`` of
       the common prefix puts both tokens within ``near_tie_bound`` of the
       top logit (bf16 rounding; at f32 the CPU tests hold identity).
       Reported: tok/s against the plain run, steps, model calls and
       steady wall per variant (step, decode, draft_step, draft_decode).

 12. the fleet (run right after phase 11, on phase 4's params):
     ``fleet_trace(n_requests=32, n_tenants=4, sys_len=256, ...)``
     (``FLEET_TRACE``: four tenants, each with its own 256-token system
     prompt, lognormal tails and generations, bursts) written under
     ``chiprun_out/`` and replayed at time scale 0 (routing decided on the
     host alone) through ``serving/fleet.ReplicaSet`` on phase 6(a)'s paged
     settings (blocks of 16, 8 slots a replica, token budget 512, max_len
     544), each run gated on 32 finished and 0 rejected and on the fused
     and paged launches per model call, in (a)-(d) replica by replica
     (``ReplicaLaunches``), in (e) over the fleet:
       (a) a 1-replica set with 2 x 256 blocks (the equal-KV baseline);
       (b) round-robin and (c) prefix routing over 2 replicas of 256
           blocks: gates both replicas finishing work;
       (d) prefix routing stealing at threshold 1: gates steals > 0;
       (a)-(d) run once each, from cold;
       every replica holds phase 4's very tensors (same ``data_ptr``) and
       building a set adds no more than its pools' arena bytes + 5%; each
       cold stream of (b)-(d) equals (a)'s up to its first divergence,
       a near-tie there (``near_tie_bound``, as phase 11);
       (e) the CLI's ``run_trace --replicas 2 --routing prefix
           --trace-out chiprun_out/phase12_trace.json``: gates the
           validator, a "route" instant per request, the router's and
           both replicas' processes, and 32 routing decisions counted.
       Reported: tok/s over the wall and over ``critical_path_s`` (an
       estimate of what a card per replica would see: the replicas step
       one after another here), busy seconds per replica, prefix-cache hit
       tokens over prompt tokens, steals, drains, TTFT p50/p99, model calls
       and (e)'s steady wall per variant and replica.

 10. training and EBFT (run last, after every earlier phase's model is
     dropped): llama3-8b at full width cut to 4 layers, bf16 params, f32
     AdamW moments, ``remat``, ``SyntheticLM(vocab=128256, seq_len=512,
     batch=4, seed=0)``:
       (a) ``eval/harness.train_small_lm``, 20 steps at lr 3e-4: gates
           finite losses and the mean of the last 5 below the first;
           reports the losses, wall per step and peak memory;
       (b) ``launch/steps.make_train_step`` from (a)'s params with a fresh
           AdamW state, one batch against 2 microbatches with and without
           int8 gradient compression: loss and grad_norm gated against the
           one-batch step's (``MICRO_TOL_REL``, ``COMPRESS_TOL_REL``); then
           5 chained one-batch steps timed with CUDA events after a
           warm-up, one more under ``torch.profiler`` (device time by
           kernel class), and ``adamw_step`` alone on one set of
           gradients: median ms per step, the optimizer's share, tokens/s,
           model FLOPs (``model_flops``) and the share of the bf16 peak;
       (c) calibration statistics of (a)'s model over 2 batches,
           ``sparsify_tree`` to 8:16 without outliers (RIA + SmoothQuant +
           VC), ``core/ebft.ebft_block`` on each of the 4 blocks (40 steps,
           lr 2e-4, batches of 4 of 8 calibration sequences of 512 tokens,
           the sparse model's embeddings propagated through the tuned
           blocks): gates each block's last loss below its first and every
           weight off its ``nonsalient_kept_mask`` exactly 0; each tuned
           projection repacked by magnitude (``to_sparse_weight``, no SQ,
           no VC) must decompress to the tuned weight; the packed model's
           ``forward`` against the tuned dense-effective params' on one
           [2, 512] batch (``nm_spmm``'s prefill body) and one [8, 1] batch
           (its decode body), within phase 8(e)'s gate, with ``nm_spmm``
           launched 7 x 4 times a forward on the body the rows select;
           perplexity of the dense, sparsified and tuned models reported.
 16. the training driver and the one-shot serve loop (run after phase
     10), with the card's name and power limit beside the numbers:
       (a) qwen2-vl-72b at full width cut to 6 of 80 layers (8:16+16:256
           by magnitude, built one layer at a time; the down projection's
           in-dim 29,568 is no multiple of 256, so it is plain 8:16 on
           ``nm_spmm``): its new shapes through phase 2's gate at M 8 and
           4,096; one prefill call of 8 x 512 random ``embeds`` at M-RoPE
           positions ``arange(512)`` and one decode step with every launch
           held in context (6 x 12 fused, 12 ``nm_spmm``), the prefill
           call also end to end within ``MODEL_TOL_REL`` of the plain
           versions; then ``launch/serve.run_oneshot``, 32 greedy tokens,
           its launches gated per model call and by body; reports prefill
           s, decode tok/s, peak memory and a decode step's kernels by
           class;
       (b) ``--legacy`` on llama3-8b, 4 layers, 8:16+16:256: the one-shot
           loop then the slot engine on the same 8 prompts of 512 tokens,
           32 new, each run's launches gated per model call, every
           diverging stream within ``near_tie_bound``;
       (c) ``launch/train.run`` on internlm2-1.8b (``DRIVER_ARCH``, full
           width), ``DRIVER_LAYERS`` (1) layer, phase 10's batch and lr, 4 steps, saves at 2 and 4, a failure at step 2 (right
           after the first save), one checkpoint kept, in a temporary
           directory it removes (the disk's free space checked against
           the checkpoint's bytes first): gates 1 restart from step 2, the
           restored state bit for bit equal to the one the driver saved
           and held, one checkpoint left, and the losses within
           ``DRIVER_LOSS_TOL_REL`` of an uninterrupted run's at the same
           steps; reports save and restore seconds and GB/s and ms a
           step;
       (d) ``make_train_step``, 3 steps on one random batch of 4 x 512 at
           phase 10's lr (xlstm-350m's of 4 x 128): xlstm-350m at 12
           of 24 layers, zamba2-2.7b at 27 of 54 (phase 14's depths),
           whisper-medium at full size, mixtral-8x7b cut
           to 2 of 32 layers; gates finite
           losses and gradient norms and the last loss below the first;
           reports ms a step and peak memory.
 17. the serving mesh (A12a; the card here is one H100, so a rank of a
     wider mesh is measured by its shapes and by two processes on it):
       (a) after phase 12 on phase 4's params, and after phase 7 on its
           int8 params: phase 6(a)'s (7(a)'s) paged engine without a
           placement, then ``ServingEngine(mesh=make_serving_mesh("1x1"))``
           on a world-size-1 NCCL group, the same traffic: gates 8/8
           streams bit-identical, ``stats()["placement"]`` and each
           run's launches per model call; reports each run's decode step
           p50 and its kernels a step by class (the gathers' extra
           launches, class ``collective`` for NCCL's);
       (b) after phase 16: every projection shape one rank of a 1x2,
           1x4 and 1x8 llama3-8b mesh launches (``MESH_SHARDS``: 11
           distinct [out / m, in] shapes) through phase 2's gate, the
           fused kernel with bf16 and int8 values at M 8 and 512, and
           its H / m, KV / m attention through phase 2b's (decode case
           and 512-token chunk, bf16 and int8 arenas);
       (c) a 1x2 mesh as two processes on the one card over gloo (its
           collectives take CUDA tensors; NCCL refuses two ranks on one
           device): llama3-8b at full width, 4 layers, phase 6(a)'s
           traffic; gates each rank's placement, its arenas at 4 of 8 KV
           heads, its launches per model call, both ranks' streams
           equal, and each stream equal to the unplaced engine's up to a
           divergence at a near-tie (``near_tie_bound``, as phase 11);
  18. every family on the serving mesh:
       (a) inside phases 14 and 15, while their params live: xlstm-350m's
           slot serve, zamba2-2.7b's paged serve, mixtral-8x7b's paged
           serve and whisper-medium's slot serve again on the 1x1 mesh
           (the same traffic, the same params: a world of one copies no
           block): gates the streams bit-identical to the unplaced
           serve's and the launches per model call; reports the decode
           step p50, the device's busy time, kernels a step by class and
           the collectives a model call issues (``ModelAxis`` gathers and
           sums, counted on the host);
       (b) after phase 17(b): the shard shapes one rank of a 1x2, 1x4 and
           1x8 mesh of xlstm-350m, zamba2-2.7b and whisper-medium
           launches (``FAMILY_MESH_PROJECTIONS``: [out / m, in], bf16
           values, M 8 and 512) through phase 2's gate, and zamba2's
           (hd 80) and mixtral's (window 4,096) attention at a rank's
           heads through phase 2b's (decode case and 512-token chunk);
       (c) after phase 17(c): a 1x2 mesh as two processes over gloo on
           the one card, each family cut to a layer of each kind
           (``MESH_FAMILY_CUTS``): gates each rank's launches per model
           call, its state, expert and arena blocks, both ranks' streams
           equal; xlstm's and whisper's streams against the unplaced
           engine's through ``near_tie_bound``; zamba2 and mixtral
           (ill-conditioned at random init) hold every kernel launch of
           the ranks' serves in context and report their streams.
  19. speculation and the fleet on meshes (A12b part 2):
       (a) right after phase 17(a) (bf16): phase 11(c)'s serve again with
           ``--mesh 1x1`` on the world-size-1 NCCL group (the drafter on
           the target's placement): gates the streams bit-identical to
           11(c)'s, the drafted and accepted counts equal, the placement,
           the launches per model call of target and draft, and a fixed
           count of collectives a call for the draft's chunk and decode
           calls and the target's verify calls; reports those counts
           and the decode step's p50 against 11(c)'s;
       (b) after phase 18(c): a fleet of 2 replicas of 1x1 as two
           processes on the one card (a ``cpu:gloo,cuda:nccl`` world, each
           replica its own NCCL group of one, ``make_replica_meshes``),
           llama3-8b at ``MESH_FLEET_LAYERS`` layers, phase 12(c)'s
           prefix-routed trace (``chiprun_out/phase19_requests.json``) at
           time scale 0 on the fleet's clock, beside a one-process
           ``ReplicaSet`` on the same trace here: gates both processes'
           homes, steals, drains, routing decisions and streams equal,
           each one's launches per its replica's model calls, and the
           streams against the one-process fleet's through
           ``near_tie_bound``; reports ``busy_s`` and ``critical_path_s``
           (one card shared: not a speed-up).
  20. the training mesh (A12c; no kernel of its own: the sharded step's
      products are plain ``torch.matmul``/``bmm``, as the reference's are
      outside any Pallas kernel), after phase 19(b):
       (a) on the 1x1 mesh (phase 17(a)'s world-size-1 NCCL group):
           ``launch/train.build(mesh=)``'s step against ``make_train_step``
           on llama3-8b at full width, 2 layers, batch 8 x 128, 3 steps:
           gates losses, norms and parameters bit-identical and the peak
           device memory equal; mixtral-8x7b at 1 layer: the MoE layer on
           the capacity path, on tokens leaning to expert 0 so that its
           queue overflows, against the exact per-token computation with
           the dropped pairs zeroed (within bf16 rounding of the output
           and of each expert term), the dropped pairs against the
           queue rule counted on the host; one sharded step (loss
           finite);
       (b) a 2x1 mesh as two processes on the one card over gloo: a
           probe of every collective the step issues on CUDA tensors
           (gated: all taken); llama3-8b, 1 step: both ranks' losses
           equal, the loss and gradient norm within rtol 2^-10 of (a)'s
           unplaced step 0 (same params, same global batch), the
           parameters after it within bf16 rounding of (a)'s unplaced
           ones but for at most 2^-8 of them moved by a sign flip of
           Adam's first update; mixtral's MoE layer through the
           all-to-all within 2 bf16 ulps of the plain EP version over 2
           virtual shards with the same dropped pairs, and against the
           exact computation as in (a); the params saved from 2x1
           restored here on the 1x1 mesh, each rank's 2x1 blocks of
           them gated bit-equal to the blocks the rank held (exact
           fingerprints).
      Reports each run's step wall p50, the collectives a step by kind,
      the peak device memory a rank and a save's and a restore's seconds
      under ``train_mesh`` in ``chiprun_out/chip_smoke.json``.
 21. the dry run (``launch/dryrun.py``; run after phase 19(a), on phase
     4's params):
       (a) a prefill step of 8 x 512 tokens and a decode step of 8 lanes
           over a 4,096-position cache, on the card and dry on fake CUDA
           tensors built by ``dryrun.build_step``: gates the dry run's
           FLOPs (``FlopCounterMode`` plus the kernels' recorded FLOPs),
           kernel launches by plan (against the wrappers' counters) and
           argument bytes equal to the card's, its argument + temp within
           ``DRYRUN_PEAK_BAND`` of the real inputs' bytes plus the rise
           of ``max_memory_allocated``, and ``H100_SM_COUNT`` equal to
           the card's SMs;
       (b) ``python -m repro_torch.launch.dryrun --no-probe`` on
           ``DRYRUN_CELLS`` (256 fake ranks, fake CUDA tensors), as
           subprocesses on the host beside (a) and (c): gates ``status
           == "ok"``, reports a rank's argument and temp GiB, FLOPs,
           collective MiB by kind and whether it fits 80 GB;
       (c) ``examples/torch/quickstart.py`` (the fused kernel's error
           gated at ``KERNEL_TOL_REL``) and ``serve_sparse.py --arch
           llama-paper`` on the card, side by side.
      Records under ``dryrun``; the cells' JSON in ``chiprun_out/dryrun``.
Each phase's own wall is under ``phase_seconds`` in the JSON.

Every serve with a decode profile (4, 5, 6(a), 7(a), 8(c), 14, 15) also
profiles one 512-token prefill chunk (whisper's: 447 tokens, its
admission's encoder call in the same step).  Prints the kernels line
``{"kernels": [...]}`` (seven entries: the three serving kernels' bf16
and int8 variants, and ``outlier_spmm``; each entry names its sources
and splits its cases and launches by path, decode and prefill;
``nm_spmm``'s launches are phase 5's, phase 10(c)'s and phase 16(a)'s,
the bf16 fused kernel's phase 4's and paged attention's phase 6(a)'s,
each with phase 11's to 15's, the fused kernel's with phase 16's; the int8 paged attention's phase 7(a)'s with phase
13(b)'s; both paged attention entries carry ``hd80``: the hd 80 cases'
sums and phase 14's launches by body; the fused kernel's and paged
attention's entries, bf16 and int8, carry ``mesh_shards``: phase 17(b)'s
sums for each mesh, and their launches add phase 17(a)'s; the bf16
fused kernel's and paged attention's carry ``family_mesh_shards``: phase
18(b)'s, and their launches add phase 18(a)'s), the serve numbers, the
``nvidia-smi`` name/power-limit line, and last
``{"ok": true, "device": {...}}``.  Run alone (without the checkout) or
without CUDA it fails.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import pathlib
import re
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
BF16_OPS_PER_S = 989e12          # dense bf16 tensor-core peak
PROJECTIONS = [("wq/wo", 4096, 4096), ("wk/wv", 1024, 4096),
               ("w_gate/w_up", 14336, 4096), ("w_down", 4096, 14336)]
MS = [1, 8, 37, 512]
# the sweep that sets the fused kernel's threshold T (w_gate, w_down)
SWEEP_PROJ = [("w_gate/w_up", 14336, 4096), ("w_down", 4096, 14336)]
SWEEP_MS = [1, 2, 4, 8, 12, 16, 24, 32, 37, 48, 64]
# Kernel vs plain: both multiply exact bf16 products and accumulate in f32;
# only the summation order and the final rounding to bf16 differ, so they
# may differ by one bf16 ulp of an output, at most 2**-7 of the largest
# output magnitude.
KERNEL_TOL_REL = 2.0 ** -7
# paged_attention's decode body is held row by row: each output row (a
# lane's query and q head, hd columns) within 2**-7 of that row's largest
# output, so that a long lane, whose outputs average ~1,000 keys and are
# small, is not held at the scale of a short lane's
# Small-model check: bf16 activations through 4 layers against an f32
# reference; a wrong kernel gives errors of the order of the logits.
MODEL_TOL_REL = 5e-2
SERVE_PROMPT_LENS = [64, 160, 256, 352, 448, 544, 640, 768]
# the prefill profile: one chunk of the serves' 512-token budget
PREFILL_PROFILE_TOKENS = 512
SERVE_GEN = 32
# phase 5: the 4-layer plain 8:16 model, bf16 values and int8 values
PLAIN_PROMPT_LENS = [128, 96, 200, 64]
PLAIN_GEN = 8
# phase 2b: (name, lanes' cursors, S, window) at H 32, KV 8, hd 128, bs 16
ATTN_SHAPE = dict(H=32, KV=8, hd=128, bs=16)
ATTN_CASES = [("decode", [63, 200, 500, 700, 767, 1000, 15, 16], 1, None),
              ("chunk512", [256], 512, None),
              ("chunk64", [0, 64, 300, 700], 64, None),
              ("chunk64_window128", [0, 64, 300, 700], 64, 128)]
# phase 2b at head dims 256, 192 and 80: gemma-7b's attention (H 16, KV
# 16), nemotron-4-340b's (H 96, KV 8) and zamba2-2.7b's shared attention
# (H 32, KV 32) at the decode case's lanes and a 512-token chunk, and the
# same at hd 128 for llama4-maverick's 5 q heads a KV head (H 40, KV 8: 5
# decode rows in a tile of R = 8);
# nemotron's decode rows (12 = S x n_rep) exceed T, so its decode case also
# runs the decode body forced (``decode_max_rows`` = 12: 2 tiles of R = 8
# rows)
ATTN_HD_SHAPES = {"gemma-7b": dict(H=16, KV=16, hd=256, bs=16),
                  "nemotron-4-340b": dict(H=96, KV=8, hd=192, bs=16),
                  "zamba2-2.7b": dict(H=32, KV=32, hd=80, bs=16),
                  "llama4-maverick-400b-a17b": dict(H=40, KV=8, hd=128,
                                                    bs=16)}
ATTN_HD_CASES = ATTN_CASES[:2]
# the sweep that sets paged_attention's threshold T: the decode case's 8
# lanes at these S (rows S * n_rep = 4..256), and 8 short lanes at ~64
# tokens through tables as wide as the serves' (64 blocks, 8 splits of
# which one is live), as a serve's early decode steps are
ATTN_SWEEP_S = [1, 2, 4, 8, 16, 32, 64]
ATTN_SWEEP_SHORT = ([64, 60, 70, 64, 50, 64, 80, 63], 64)   # cursors, nb
# phase 6(b): a shared 512-token prefix, 8 distinct suffixes in two waves
# (the last of wave 2 repeats the start of a wave-1 suffix, so its whole
# prompt is cached and its recomputed last token forces a copy-on-write)
PREFIX_LEN = 512
PREFIX_SUFFIX_LENS = [[32, 96, 160, 256], [64, 128, 200]]
PREFIX_REPEAT = (1, 48)          # wave-1 suffix 1, its first 48 tokens
# phase 9: the replayed trace (serving/trace.poisson_trace's arguments)
TRACE = dict(n_requests=16, rate_per_s=4.0, prompt_len=(64, 768),
             max_new_tokens=32, temperature=0.0, seed=0)
TRACE_SPANS = {"step", "plan", "chunk", "decode", "emit", "queued", "prefill",
               "request_summary", "jit:step", "jit:decode"}
# phase 11: speculative decoding: k and its adaptive ceiling, the bar on
# acceptance (the reference's own, tests/test_speculative.py:129-131), the
# n-gram prompts' repeated segment, the CLI run's depth and shape, and the
# near-tie gate's margin (``near_tie_bound``; bf16's unit roundoff)
SPEC_K, SPEC_MAX_K = 4, 8
SPEC_ACCEPT_MIN = 0.9
NGRAM_SEGMENT, NGRAM_REPEATS = 48, 4
SPEC_CLI = dict(n_layers=4, batch=8, prompt_len=256, gen=32)
NEAR_TIE_SIGMAS = 4
BF16_U = 2.0 ** -8
# phase 12: the fleet: ``fleet_trace``'s arguments (the reference fleet
# scenario's tenant mix with shared system prompts, at llama3-8b's
# vocabulary and prompt lengths), R replicas of NB blocks of 16 tokens
# (~0.5 GB of bf16 KV each) with 8 slots, max_len = sys_len + prompt_max +
# gen_max
FLEET_TRACE = dict(n_requests=32, n_tenants=4, sys_len=256, rate_per_s=20.0,
                   burst_mean=4.0, prompt_median=64, prompt_sigma=0.6,
                   prompt_max=256, gen_median=16, gen_sigma=0.8, gen_max=32,
                   seed=11)
FLEET_REPLICAS, FLEET_BLOCKS, FLEET_SLOTS = 2, 256, 8
FLEET_MAX_LEN = 256 + 256 + 32
# phase 13: the dense family's other members at full width, 8:16+16:256,
# on the paged layout with blocks of 16: (a) qwen3-8b (qk_norm), 36 layers,
# phase 4's traffic, then the same on the slot layout; (b) gemma-7b (hd
# 256, GeGLU, tied head), 28 layers, phase 4's traffic in 512 blocks, bf16
# then int8 KV; (c) nemotron-4-340b (hd 192, squared ReLU), full width cut
# to 2 of its 96 layers (all 96 would need ~0.5 TB), 4 requests
FAMILY_ARCHS = ("qwen3-8b", "gemma-7b", "nemotron-4-340b")
NEMOTRON_LAYERS = 2
NEMOTRON_PROMPT_LENS = [64, 128, 192, 256]
NEMOTRON_GEN = 16
# phase 14: the recurrent families at full width, 8:16+16:256, phase 4's
# traffic; xlstm-350m served again on half the slots with a forced
# preemption every PREEMPT_EVERY steps while a request waits
RECURRENT_ARCHS = ("xlstm-350m", "zamba2-2.7b")
# depth cuts for the script's wall: xlstm-350m at 12 of 24 layers (one
# sLSTM layer of three; it paid for phase 19), zamba2-2.7b at 27 of 54
# (4 of its 9 shared-attention applications; with mixtral's cut below it
# paid for phase 20)
RECURRENT_LAYERS = {"xlstm-350m": 12, "zamba2-2.7b": 27}
XLSTM_PRESSURE_SLOTS = 4
PREEMPT_EVERY = 4
# each new projection shape through phase 2's gate at a decode and a
# prefill row count before it serves
FAMILY_MS = (8, 512)
# phase 15: the moe and encdec families.  mixtral-8x7b cut to 8 of 32
# layers (its dense bf16 experts are 2.82 GB a layer: 32 would need ~92 GB;
# 16 until phase 20 needed the wall),
# phase 4's traffic paged then slot; llama4-maverick-400b-a17b cut to 1 of
# 48 layers (one layer's 128 experts are 32.2 GB), 4 requests paged;
# whisper-medium at full size on the slot layout: 8 slots of whisper's
# 448-token text context, 1,500 encoder frames a request (its 30-s window
# after the stride-2 convolution), decoder prompts of 4..224 tokens
MOE_ARCHS = (("mixtral-8x7b", 8), ("llama4-maverick-400b-a17b", 1))
MAVERICK_PROMPT_LENS = [64, 128, 192, 256]
MAVERICK_GEN = 16
WHISPER_FRAMES = 1500
WHISPER_ENGINE = dict(n_slots=8, max_len=448, max_ctx=WHISPER_FRAMES,
                      token_budget=512)
WHISPER_PROMPT_LENS = [4, 32, 64, 96, 128, 160, 192, 224]
WHISPER_PRESSURE_SLOTS = 4
WHISPER_MS = (8, 512, WHISPER_FRAMES)       # the encoder's rows besides
# the MoE layer check: the grouped bf16 path against each token's chosen
# experts in f32.  The path rounds to bf16 (u = 2^-8) the gate and up
# products, their activated product, the down product, its routing-weight
# scaling and the sum over the k choices: ~6 roundings, each at most u of
# the value it rounds; the down product's sum over d_ff carries the hidden
# roundings as a random walk, a relative RMS of ~u.  At 4 standard
# deviations of ~sqrt(6) u against an output RMS about a quarter of its
# largest value, the difference stays under 2^-6 of the largest reference
# output.  A choice may differ from the f64 router's only where the k-th
# and (k+1)-th probabilities lie within ROUTE_TIE (f32 rounding of the
# router's logits and softmax)
MOE_TOL_REL = 2.0 ** -6
ROUTE_TIE = 2.0 ** -20
MOE_DECODE_ROWS = 8
# phase 16: the training driver and the one-shot serve slice.  (a)
# qwen2-vl-72b at full width cut to 6 of 80 layers (~1.18 GB of compressed
# weights a layer; 80 would need ~100 GB; 24 until phase 20 and 12 until
# phase 21 needed the wall), 8 lanes of a 512-token prompt of
# random embeds, 32 greedy tokens through the one-shot loop, its new
# projection shapes gated at a decode step's rows and a prefill call's
# (8 x 512); (b) --legacy on llama3-8b at phase 10's depth; (c) the training
# driver on internlm2-1.8b at full width: 4 steps, saves at 2 and 4, a failure at step
# 2, the first after the first save (the restored state is then the one
# the driver saved, held against it bit for bit), one checkpoint kept;
# (d) 3 train steps a family of 4 sequences, mixtral-8x7b cut to 2 of 32
# layers (its params, grads and f32 moments ~38 GB), xlstm-350m's of 128
# tokens (its sLSTM layers step over time in Python, forward twice under
# remat: several seconds a step at 512).  The resumed losses
# against the uninterrupted run's: the forward is bf16 and the embedding's
# backward accumulates with atomics, so a step's update may round one bf16
# ulp apart; the loss averages 2,048 token losses and stays within one bf16
# ulp of its own value
# qwen2-vl-72b's depth in 16(a): 6 of 80 layers (12 until phase 21 needed
# the wall)
VLM_LAYERS = 6
VLM_LOOP = dict(batch=8, prompt_len=512, gen=32)
VLM_MS = (8, 4096)
LEGACY_LOOP = dict(n_layers=4, batch=8, prompt_len=512, gen=32)
DRIVER = dict(steps=4, save_every=2, fail_at_step=2, keep_last_k=1)
# the training driver's model: internlm2-1.8b at full width (vocab 92,544,
# d 2,048), one of its 24 layers (embedding and head whole), a checkpoint
# of ~4.4 GB; llama3-8b's one layer (12.7 GB, two saves and a restore: ~80
# s of the driver's ~82) until phase 21 needed the wall
DRIVER_ARCH = "internlm2-1.8b"
DRIVER_LAYERS = 1
DRIVER_LOSS_TOL_REL = 2.0 ** -7
# xlstm-350m and zamba2-2.7b at phase 14's depths (12 of 24, 27 of 54;
# whole until phase 20 needed the wall)
FAMILY_TRAIN = (("xlstm-350m", 12, 128), ("zamba2-2.7b", 27, 512),
                ("whisper-medium", None, 512), ("mixtral-8x7b", 2, 512))
# steps a family trains in 16(d): 3 (8 until phase 21 needed the wall;
# every family's loss falls by its third step)
FAMILY_TRAIN_STEPS = 3
FAMILY_TRAIN_BATCH = 4
# phase 20: the training mesh.  (a) llama3-8b at full width and 2 layers,
# batch 8 x 128, 3 steps, unplaced and on the 1x1 mesh; mixtral-8x7b at 1
# layer for the capacity path, its tokens leaning to expert 0 by
# ``moe_lean`` (in units of the router row's norm); (b) the same on a 2x1
# mesh as two processes over gloo, 1 step, its params saved from 2x1
TRAIN_MESH = dict(layers=2, batch=8, seq_len=128, steps=3, rank_steps=1,
                  lr=3e-4, moe_layers=1, state_dtype="bfloat16",
                  moe_lean=1.5)
# 20(b)'s gates against 20(a)'s unplaced step: the loss and norm of the
# same global batch summed in another order over the two shards; and the
# share of parameters Adam's sign-like first update may move by a flip
# (a bf16 gradient element is known to about 2^-8 of its size, so a share
# of that order lies within rounding of zero)
# phase 21: the dry run (``launch/dryrun.py``).  (a) phase 4's llama3-8b
# (32 layers, 8:16+16:256, bf16, unplaced): a prefill step of 8 x 512
# tokens and a decode step of 8 lanes over a 4,096-position cache, run on
# the card and dry on fake CUDA tensors from the dry run's own builder;
# (b) the CLI on two production cells as subprocesses of 256 fake ranks,
# run beside (a) and (c) (they use the host only); (c) the examples.
DRYRUN_STEPS = (("prefill", 8, 512), ("decode", 8, 4096))
DRYRUN_CELLS = (("qwen3-8b", "train_4k", ()),
                ("qwen3-8b", "decode_32k", ("--sparse",)))
# the dry run's argument + temp against the card's arguments + the rise of
# max_memory_allocated over the step: the same ops free the same storages,
# so they differ by the caching allocator's rounding (512 B a block) and
# what it allocates beside the ops' outputs (cuBLAS's workspace, warmed
# before the measured step)
DRYRUN_PEAK_BAND = dict(rel=0.01, abs_bytes=64 * 2 ** 20)
DRYRUN_CELL_TIMEOUT_S = 300
DEVICE_GB = 80
TRAIN_MESH_RTOL = 2.0 ** -10
TRAIN_MESH_FLIP_SHARE = 2.0 ** -8
TRAIN_MESH_DEADLINE_S = 300
# the probe's collectives on CUDA tensors over gloo, as the step issues
# them (tensor_parallel.gather_blocks and all_to_all, policy.global_sum,
# the clip's norm, the checkpoint's barrier and broadcast)
GLOO_PROBES = ("all_gather", "reduce_scatter", "all_reduce",
               "all_to_all_single", "barrier", "broadcast_object_list")
# phase 8: the paper's pipeline
# phase 17: the serving mesh.  (b) the shard shapes of one rank of a 1x2,
# 1x4 and 1x8 llama3-8b mesh at these M; (c) a 1x2 mesh as two processes
# on the one card over gloo, at full width and 4 layers
MESH_SHARDS = (2, 4, 8)
MESH_MS = (8, 512)
MESH_TWO_RANK_LAYERS = 4
MESH_TWO_RANK_DEADLINE_S = 300
MESH_FLEET_LAYERS = 4           # phase 19(b)'s fleet of two processes
# phase 18: every family on the serving mesh.  (b) the compressed
# projections' [out, in] shapes of these models (xlstm-350m's w_gates and
# r_gates stay dense, as the reference keeps them), sliced to a rank's
# out / m rows, and the paged attention of zamba2's shared block (hd 80,
# MHA) and of mixtral (GQA, window 4,096) at a rank's H / m, KV / m heads;
# (c) a 1x2 mesh as two processes over gloo, each model cut to a layer of
# each kind (xlstm's sLSTM layer, zamba2's shared-attention applications,
# whisper's encoder), the cut models' traffic
FAMILY_MESH_PROJECTIONS = [
    ("xlstm-350m/w_up", 4096, 1024), ("xlstm-350m/w_q,w_k,w_v", 2048, 2048),
    ("xlstm-350m/w_slstm", 8192, 2048), ("xlstm-350m/w_down", 1024, 2048),
    ("zamba2-2.7b/in_proj", 10448, 2560), ("zamba2-2.7b/out_proj", 2560, 5120),
    ("zamba2-2.7b/wq,wk,wv,wo", 2560, 2560),
    ("zamba2-2.7b/w_gate,w_up", 10240, 2560),
    ("zamba2-2.7b/w_down", 2560, 10240),
    ("whisper-medium/wq..c_wo", 1024, 1024),
    ("whisper-medium/w_up", 4096, 1024), ("whisper-medium/w_down", 1024, 4096)]
FAMILY_MESH_ATTN = {"zamba2-2.7b": (dict(H=32, KV=32, hd=80, bs=16), None),
                    "mixtral-8x7b": (dict(H=32, KV=8, hd=128, bs=16), 4096)}
MESH_FAMILY_CUTS = {"xlstm-350m": dict(n_layers=4, slstm_every=4),
                    "zamba2-2.7b": dict(n_layers=4, attn_every=2),
                    "mixtral-8x7b": dict(n_layers=2),
                    "whisper-medium": dict(n_layers=2, enc_layers=2)}
# ill-conditioned at random init (ROADMAP C): kernels held in context
MESH_FAMILY_IN_CONTEXT = ("zamba2-2.7b", "mixtral-8x7b")
MESH_FAMILY_PROMPT_LENS = [64, 160, 256, 352]
MESH_FAMILY_GEN = 8
MESH_FAMILY_ENGINE = dict(n_slots=4, max_len=512, token_budget=512)
PROJ_NAMES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
CALIB = dict(n_batches=4, batch=4, seq_len=512)          # 8,192 tokens
PPL = dict(n_batches=2, batch=2, seq_len=512)
OPS_PROJ = ("wq", "wk", "w_gate", "w_down")              # the four shapes
OPS_PATTERNS = ("16:256", "8:256", "4:256")
# the sweep that sets outlier_spmm's threshold T (w_gate, w_down; n 16, 4)
OUTLIER_SWEEP_MS = [1, 2, 4, 8, 12, 16, 24, 37, 64]
OUTLIER_SWEEP_N = (16, 4)
# The gather ceiling of an outlier product on the CUDA cores: each
# multiply-add reads 2 B of x from shared memory at 128 B a clock an SM, 64
# a clock an SM, at the SM clock of the data sheet's bf16 peak (989e12 / (132
# SMs x 4096 operations a clock) = 1.83 GHz), over 132 SMs: 15.5e12/s.
GATHER_FMA_PER_S = BF16_OPS_PER_S / 4096 * 64
# The card's pipeline against the CPU's: the same f32 arithmetic in another
# reduction order, so only indices whose scores are within an ulp or so of
# a neighbour's may differ.
PIPELINE_AGREE = 0.999
# ops.nm_matmul(x) + ops.outlier_matmul(x) against the fused
# ops.sparse_linear_apply(x): W_nm is exactly zero at the salient slots, so
# the two differ only by the rounding of each partial product to bf16 and of
# their bf16 sum (half an ulp each), besides the fused product's own
# rounding: one bf16 ulp of each of the three magnitudes bounds it.
UNFUSED_TOL_REL = 2.0 ** -7
# phase 10: training and EBFT at full width, cut to 4 layers (AdamW's f32
# moments of all 32 would not fit one card beside the weights)
TRAIN = dict(n_layers=4, seq_len=512, batch=4, steps=20,
             lr=3e-4)                    # launch/train.py's default lr
TRAIN_TIMED_STEPS = 5
EBFT_CFG = dict(steps=40, lr=2e-4, batch_size=4)
EBFT_CALIB_BATCHES = 2                   # 2 x 4 sequences of 512 tokens
# Microbatched train steps against the one-batch step.  The forward runs in
# bf16: a half batch's products may round a bf16 output one ulp (2^-8
# relative) apart from the full batch's; the loss averages 2,048 token
# losses and the norm sums the f32 squares of 1.9e9 gradients, so either
# stays well inside one bf16 ulp of its own value, while a microbatch lost
# or not divided by mb moves them by 1.4x-2x.
MICRO_TOL_REL = 2.0 ** -7
# With int8 compression each gradient moves by at most half a step of its
# stacked leaf's absmax / 127, and the norm by the rms of those moves over
# the gradients' rms: under a percent unless a leaf's largest element is
# ~100x its rms (5e-5 on a 2-layer bf16 model on the CPU).
COMPRESS_TOL_REL = 2.0 ** -5


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------- timing
class Timer:
    """CUDA-event timing of one call at a time with L2 flushed before each
    (the serving path finds weights cold: 10 GB stream through a 50 MB L2)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(256 * 2**20, dtype=torch.uint8,
                                 device="cuda")

    def ms(self, fn, reps: int) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / reps


def bound(M, N, K, n, m, o_n, sw):
    """Least time for y = x @ W^T on this work: every input byte read once
    and the output written once at the HBM rate, or the multiply-adds of the
    stored entries at the bf16 tensor-core peak, whichever is larger."""
    bytes_moved = M * K * 2 + sw.deployed_bytes() + M * N * 2
    stored_per_row = K * n // m + (K // 256) * o_n
    ops = 2 * M * N * stored_per_row
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def weight_case(timer, log, name, proj, x, sw, kernel_fn, plain_fn):
    """One (projection, M) case of a weight kernel: the kernel against its
    plain version on ``sw``'s buffers, gated at one bf16 ulp of the largest
    output, and timed beside the plain version, one ``F.linear`` on the
    densified (dequantized) weight and the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import unpack_metadata, unpack_outlier_meta
    from repro_torch.kernels.ref import decompress_nm, dequantize

    M, K = x.shape
    N = sw.nm_values.shape[0]
    bufs = ((sw.nm_values, sw.nm_meta) if sw.o_values is None else
            (sw.nm_values, sw.nm_meta, sw.o_values, sw.o_meta))
    kw = dict(n=sw.n, m=sw.m, scale=sw.v_scale)
    if sw.o_values is not None:
        kw["o_n"] = sw.o_n

    def kern():
        return kernel_fn(x, *bufs, **kw)

    def plain():
        return plain_fn(x, *bufs, **kw)
    y, y_plain = kern(), plain()
    torch.cuda.synchronize()
    check(y.shape == (M, N) and y.dtype == torch.bfloat16,
          f"{name} {proj} M={M}: shape {tuple(y.shape)} {y.dtype}")
    check(bool(torch.isfinite(y).all()),
          f"{name} {proj} M={M}: non-finite output")
    err = float((y.float() - y_plain.float()).abs().max())
    tol = KERNEL_TOL_REL * float(y_plain.float().abs().max())
    check(err <= tol, f"{name} {proj} M={M}: max|kernel-plain| "
                      f"{err:.3e} > tol {tol:.3e}")
    dense = decompress_nm(dequantize(sw.nm_values, sw.v_scale, x.dtype),
                          unpack_metadata(sw.nm_meta, sw.n), sw.m,
                          dtype=torch.float32)
    if sw.o_values is not None:
        dense += decompress_nm(sw.o_values.reshape(N, -1),
                               unpack_outlier_meta(sw.o_meta, sw.o_n), 256,
                               dtype=torch.float32)
    dense = dense.to(torch.bfloat16)
    b_ms, b_by = bound(M, N, K, sw.n, sw.m, sw.o_n, sw)
    case = {"proj": proj, "N": N, "K": K, "M": M,
            "max_abs_err": err, "tol": tol,
            "ms": timer.ms(kern, 20), "plain_ms": timer.ms(plain, 5),
            "library_ms": timer.ms(lambda: F.linear(x, dense), 20),
            "bound_ms": b_ms, "bound_by": b_by}
    # the wrapper's path (decode at M <= T, prefill above; o_n = 0 is
    # nm_spmm's plan): the same inputs twice give the same bits, and the old
    # tile kernel is timed beside it on the same inputs
    from repro_torch.kernels import fused_sparse_linear as fsl
    p = fsl.plan(M, K, N, sw.n, sw.m, sw.o_n, sm_count(torch))
    case["path"] = p.path
    again = kern()
    torch.cuda.synchronize()
    check(torch.equal(y, again),
          f"{name} {proj} M={M}: two calls give different bits")
    forced = fsl.tile_plan(M, K, N)
    case.update(splits=p.splits, rows=p.rows, cols=p.cols,
                tile_ms=timer.ms(lambda: kernel_fn(
                    x, *bufs, force_plan=forced, **kw), 20))
    tile = (f"  {p.path} {p.rows}x{p.cols} S={p.splits}  tile "
            f"{case['tile_ms']:.4f}")
    log(f"  {name:25s} {proj:12s} M={M:4d}: err {err:.2e} "
        f"(tol {tol:.2e})  kernel {case['ms']:.4f} ms  plain "
        f"{case['plain_ms']:.4f}  F.linear "
        f"{case['library_ms']:.4f}  bound {b_ms:.4f} ({b_by}){tile}")
    return case


def sm_count(torch) -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


def sweep_phase(torch, timer, log):
    """Each weight wrapper's decode kernel, prefill kernel and old tile
    kernel side by side, each forced by its plan, bf16 and int8 values, at
    w_gate and w_down for every M of ``SWEEP_MS``: ``fused_sparse_linear``
    on 8:16 + 16:256 weights, ``nm_spmm`` on plain 8:16 ones; every case is
    gated against the plain version.  A kernel's T is the largest M at
    which its decode kernel was no slower than its prefill kernel in all
    four (projection, variant) cases; the tile kernel is reported only."""
    from repro_torch.core import SparsifyConfig
    from repro_torch.kernels import fused_sparse_linear as fsl
    from repro_torch.kernels import nm_spmm as nms
    from repro_torch.models.sparse_serving import to_sparse_weight

    g = torch.Generator(device="cuda").manual_seed(4)
    out = {"T_in_module": fsl.DECODE_MAX_M}
    for kernel, outlier, mod, fn in (
            ("fused_sparse_linear", "16:256", fsl, fsl.fused_sparse_linear),
            ("nm_spmm", None, nms, nms.nm_spmm)):
        scfg = SparsifyConfig(weight_pattern="8:16", outlier_pattern=outlier,
                              scorer="magnitude", use_smoothquant=False)
        cases = []
        for proj, N, K in SWEEP_PROJ:
            w = (torch.randn((N, K), generator=g, device="cuda")
                 / math.sqrt(K)).to(torch.bfloat16)
            for variant, sw in (("bf16", to_sparse_weight(w, scfg)),
                                ("int8", to_sparse_weight(w, scfg,
                                                          quantize=True))):
                bufs = (sw.nm_values, sw.nm_meta) + (
                    () if outlier is None else (sw.o_values, sw.o_meta))
                kw = dict(n=sw.n, m=sw.m, scale=sw.v_scale)
                if outlier is not None:
                    kw["o_n"] = sw.o_n
                for M in SWEEP_MS:
                    x = torch.randn((M, K), generator=g, device="cuda").to(
                        torch.bfloat16)
                    plans = {path: fsl.plan(M, K, N, sw.n, sw.m, sw.o_n,
                                            sm_count(torch),
                                            decode_max_m=limit)
                             for path, limit in (("decode", max(SWEEP_MS)),
                                                 ("prefill", 0))}
                    plans["tile"] = fsl.tile_plan(M, K, N)
                    y_plain = mod.plain(x, *bufs, **kw)
                    tol = KERNEL_TOL_REL * float(y_plain.float().abs().max())
                    case = {"proj": proj, "variant": variant, "M": M,
                            "splits": plans["decode"].splits,
                            "rows": plans["decode"].rows,
                            "prefill_tiles": [plans["prefill"].rows,
                                              plans["prefill"].cols,
                                              plans["prefill"].splits]}
                    for path, pl in plans.items():
                        def run(pl=pl):
                            return fn(x, *bufs, force_plan=pl, **kw)
                        y = run()
                        torch.cuda.synchronize()
                        err = float((y.float() - y_plain.float()).abs().max())
                        check(bool(torch.isfinite(y).all()) and err <= tol,
                              f"sweep {kernel} {proj} {variant} M={M} {path}:"
                              f" max|kernel-plain| {err:.3e} > tol {tol:.3e}")
                        case[f"{path}_ms"] = timer.ms(run, 20)
                        case[f"{path}_err"] = err
                    cases.append(case)
                    log(f"  sweep {kernel:19s} {proj:12s} {variant} M={M:3d}:"
                        f" decode {case['decode_ms']:.4f} ms (S="
                        f"{case['splits']}, R={case['rows']})  prefill "
                        f"{case['prefill_ms']:.4f} (BMxBN,S="
                        f"{case['prefill_tiles']})  tile "
                        f"{case['tile_ms']:.4f}")
                del sw, bufs
            del w
        faster = [M for M in SWEEP_MS
                  if all(c["decode_ms"] <= c["prefill_ms"] for c in cases
                         if c["M"] == M)]
        out[kernel] = {"T_measured": max(faster) if faster else 0,
                       "decode_no_slower_at": faster, "cases": cases}
        log(f"  sweep {kernel}: decode no slower than prefill at M in "
            f"{faster}; T measured {out[kernel]['T_measured']}, module T "
            f"{fsl.DECODE_MAX_M}")
    return out


def resource_usage(lib_path, log):
    """Registers, stack, shared and local memory of every kernel of the
    built library (``cuobjdump --dump-resource-usage``); gates no local
    memory and no stack (no spill) for the constant-shape instantiations of
    the two weight kernels' bodies, with 16:256 outliers (the fused kernel)
    and without (``nm_spmm``), 8:16 each: six of each decode body (three
    row counts, bf16 and int8) and ten of each prefill body (BM x BN of
    64 x 64, 64 x 128, 128 x 64, 128 x 128 and 256 x 128, bf16 and
    int8); and ``outlier_spmm``'s two bodies: three decode instances (R =
    2, 4, 8) and six prefill instances (BM 64 and 128, n 4, 8, 16); and
    ``paged_attention``'s two bodies: twenty decode instances (hd 64, 80,
    128, 192 and 256, R 4 and 8 rows, bf16 and int8 arenas) and eighteen
    prefill-chunk instances (hd 64, 80, 128 and 192 at BM 64 and 128, hd
    256 at BM 64, bf16 and int8 arenas)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "--dump-resource-usage", str(lib_path)],
                         capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr[-2000:]}")
    found = re.findall(r"Function\s+(\S+?):\s*REG:(\d+)\s+STACK:(\d+)\s+"
                       r"SHARED:(\d+)\s+LOCAL:(\d+)", out.stdout)
    kernels = {name: dict(zip(("reg", "stack", "shared", "local"),
                              map(int, vals))) for name, *vals in found}
    result = {"kernels": len(kernels)}
    for key, tag, want in (("fused_decode", "fused_decode_816_kernel", 6),
                           ("fused_prefill", "fused_prefill_816_kernel", 10),
                           ("nm_decode", "nm_decode_816_kernel", 6),
                           ("nm_prefill", "nm_prefill_816_kernel", 10),
                           ("outlier_decode", "outlier_decode_kernel", 3),
                           ("outlier_prefill", "outlier_prefill_kernel", 6),
                           ("paged_decode", "paged_decode_kernel", 20),
                           ("paged_prefill", "paged_prefill_kernel", 18)):
        main = {k: v for k, v in kernels.items() if tag in k}
        check(len(main) == want, f"cuobjdump shows {len(main)} {tag} "
                                 f"kernels, want {want}:\n"
                                 f"{out.stdout[-3000:]}")
        for name, use in main.items():
            check(use["local"] == 0 and use["stack"] == 0,
                  f"{name} uses local memory (spills): {use}")
        result[key] = {k: v for k, v in kernels.items() if key in k}
        log(f"  resource usage, {key}: " + json.dumps(result[key]))
    log(f"  resource usage of {len(kernels)} kernels")
    return result


def kernel_phase(torch, timer, log):
    """Each weight kernel, bf16 and int8, against its plain version at the
    main path's shapes; the int8 weights are quantized from the same
    draws."""
    from repro_torch.core import SparsifyConfig
    from repro_torch.kernels import fused_sparse_linear as fsl
    from repro_torch.kernels import nm_spmm as nms
    from repro_torch.models.sparse_serving import to_sparse_weight

    g = torch.Generator(device="cuda").manual_seed(1)
    results = {}
    for name, outlier, mod, fn in (
            ("fused_sparse_linear", "16:256", fsl, fsl.fused_sparse_linear),
            ("nm_spmm", None, nms, nms.nm_spmm)):
        scfg = SparsifyConfig(weight_pattern="8:16", outlier_pattern=outlier,
                              scorer="magnitude", use_smoothquant=False)
        cases, cases8 = [], []
        for proj, N, K in PROJECTIONS:
            w = (torch.randn((N, K), generator=g, device="cuda")
                 / math.sqrt(K)).to(torch.bfloat16)
            sw = to_sparse_weight(w, scfg)
            sw8 = to_sparse_weight(w, scfg, quantize=True)
            del w
            for M in MS:
                x = torch.randn((M, K), generator=g, device="cuda").to(
                    torch.bfloat16)
                cases.append(weight_case(timer, log, name, proj, x, sw, fn,
                                         mod.plain))
                cases8.append(weight_case(timer, log, f"{name}_int8", proj, x,
                                          sw8, fn, mod.plain))
            del sw, sw8
        results[name] = cases
        results[f"{name}_int8"] = cases8
    return results


# the fused wrapper's kernels: decode (M <= T) and prefill (M > T); the old
# tile kernel is timed beside them only
FUSED_SOURCES = ("src/repro_torch/csrc/fused_sparse_linear.cu (M <= T) + "
                 "src/repro_torch/csrc/fused_sparse_linear_prefill.cu "
                 "(M > T); src/repro_torch/csrc/sparse_linear.cu (old tile, "
                 "timed only)")
# nm_spmm: the same two bodies without an outlier stream
NM_SOURCES = ("src/repro_torch/csrc/fused_sparse_linear.cu (M <= T, "
              "nm_decode_*) + src/repro_torch/csrc/fused_sparse_linear_"
              "prefill.cu (M > T, nm_prefill_*); src/repro_torch/csrc/"
              "sparse_linear.cu (old tile, timed only)")
# paged attention: the decode body (rows S * n_rep <= T) and the
# prefill-chunk body (rows > T); the old kernel is timed beside them only
ATTN_SOURCES = ("src/repro_torch/csrc/paged_attention_decode.cu (rows <= T)"
                " + src/repro_torch/csrc/paged_attention_prefill.cu (rows > "
                "T); src/repro_torch/csrc/paged_attention.cu (old, timed "
                "only)")
KERNELS = {        # name: (TPU kernel it replaces, CUDA source)
    "fused_sparse_linear": ("src/repro/kernels/fused_sparse_linear.py:75",
                            FUSED_SOURCES),
    "nm_spmm": ("src/repro/kernels/nm_spmm.py:86", NM_SOURCES),
    "paged_attention": ("src/repro/serving/paged/paged_attention.py:180",
                        ATTN_SOURCES),
    "fused_sparse_linear_int8": (
        "src/repro/kernels/fused_sparse_linear.py:50", FUSED_SOURCES),
    "nm_spmm_int8": ("src/repro/kernels/nm_spmm.py:63", NM_SOURCES),
    "paged_attention_int8": (
        "src/repro/serving/paged/paged_attention.py:124",
        ATTN_SOURCES),
    "outlier_spmm": ("src/repro/kernels/outlier_spmm.py:74",
                     "src/repro_torch/csrc/outlier_spmm.cu (decode body at "
                     "M <= T, prefill body above); src/repro_torch/csrc/"
                     "outlier_spmm_gather8.cu (old kernel, timed only)")}


def outlier_bound(M, N, K, n):
    """Least time for y = x @ O^T at N:256: each outlier's 2-byte value and
    1-byte index, x and y moved once at the HBM rate, or the 2*M*N*K*n/256
    multiply-adds at the bf16 peak, whichever is larger."""
    bytes_moved = N * (K // 256) * n * 3 + M * K * 2 + M * N * 2
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * M * N * K * n / 256 / BF16_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def outlier_gather_ceiling(M, N, K, n):
    """Least time for the M*N*K*n/256 multiply-adds of y = x @ O^T as
    gathers of x from shared memory on the CUDA cores (``GATHER_FMA_PER_S``),
    which no body that reads x per outlier can beat; worked out, not
    measured, so it goes to the log and to phase 8's ops section, not to
    the kernels line."""
    return M * N * (K // 256) * n / GATHER_FMA_PER_S * 1e3


def random_outliers(torch, N, K, n, g):
    """Random N:256 outliers on the card: distinct ascending indices per
    group, index 255 in the last slot of every seventh row."""
    from repro_torch.core import pack_outlier_meta
    idx = torch.rand((N, K // 256, 256), generator=g, device="cuda")
    idx = torch.sort(idx.argsort(-1)[..., :n], dim=-1).values.int()
    idx[::7, :, -1] = 255
    vals = torch.randn((N, K // 256, n), generator=g, device="cuda")
    return vals.to(torch.bfloat16), pack_outlier_meta(idx)


def outlier_sweep_phase(torch, timer, log):
    """``outlier_spmm``'s decode body, prefill body and old kernel side by
    side, each forced, at w_gate and w_down with 16:256 and 4:256 outliers,
    for every M of ``OUTLIER_SWEEP_MS``; every case is gated against the
    plain version.  T is the largest M at which the decode body was no
    slower than the prefill body in all four (projection, n) rows."""
    from repro_torch.kernels import outlier_spmm as osp

    g = torch.Generator(device="cuda").manual_seed(9)
    cases = []
    for proj, N, K in SWEEP_PROJ:
        for n in OUTLIER_SWEEP_N:
            vals, meta = random_outliers(torch, N, K, n, g)
            for M in OUTLIER_SWEEP_MS:
                x = torch.randn((M, K), generator=g, device="cuda").to(
                    torch.bfloat16)
                plans = {path: osp.plan(M, K, N, n, sm_count(torch),
                                        decode_max_m=limit)
                         for path, limit in (("decode", max(OUTLIER_SWEEP_MS)),
                                             ("prefill", 0))}
                plans["old"] = osp.gather8_plan(M, K, N)
                y_plain = osp.plain(x, vals, meta, n=n)
                tol = KERNEL_TOL_REL * float(y_plain.float().abs().max())
                case = {"proj": proj, "n": n, "M": M}
                for path, pl in plans.items():
                    def run(pl=pl):
                        return osp.outlier_spmm(x, vals, meta, n=n,
                                                force_plan=pl)
                    y = run()
                    torch.cuda.synchronize()
                    err = float((y.float() - y_plain.float()).abs().max())
                    check(bool(torch.isfinite(y).all()) and err <= tol,
                          f"outlier sweep {proj} n={n} M={M} {path}: "
                          f"max|kernel-plain| {err:.3e} > tol {tol:.3e}")
                    case[f"{path}_ms"] = timer.ms(run, 20)
                    case[f"{path}_plan"] = [pl.rows, pl.cols, pl.splits]
                cases.append(case)
                log(f"  sweep outlier_spmm {proj:12s} {n:2d}:256 M={M:3d}: "
                    f"decode {case['decode_ms']:.4f} ms {case['decode_plan']}"
                    f"  prefill {case['prefill_ms']:.4f} "
                    f"{case['prefill_plan']}  old {case['old_ms']:.4f}")
            del vals, meta
    faster = [M for M in OUTLIER_SWEEP_MS
              if all(c["decode_ms"] <= c["prefill_ms"] for c in cases
                     if c["M"] == M)]
    out = {"T_in_module": osp.DECODE_MAX_M,
           "T_measured": max(faster) if faster else 0,
           "decode_no_slower_at": faster, "cases": cases}
    log(f"  sweep outlier_spmm: decode no slower than prefill at M in "
        f"{faster}; T measured {out['T_measured']}, module T "
        f"{osp.DECODE_MAX_M}")
    return out


def case_sums(cases):
    """Times summed over ``cases``; the bound is bytes-bound if most of its
    time is."""
    b_bytes = sum(c["bound_ms"] for c in cases if c["bound_by"] == "bytes")
    b_ops = sum(c["bound_ms"] for c in cases if c["bound_by"] != "bytes")
    out = {"ms": sum(c["ms"] for c in cases),
           "plain_ms": sum(c["plain_ms"] for c in cases),
           "bound_ms": b_bytes + b_ops,
           "bound_by": "bytes" if b_bytes >= b_ops else "operations",
           "library_ms": sum(c["library_ms"] for c in cases)}
    if cases and all("tile_ms" in c for c in cases):
        out["tile_ms"] = sum(c["tile_ms"] for c in cases)
    # the old paged kernel runs hd 64 and 128 only: its sum covers those
    old = [c for c in cases if "old_ms" in c]
    if old:
        out["old_ms"] = sum(c["old_ms"] for c in old)
        out["old_cases"] = len(old)
    return out


def paths(launches, kernel):
    """A serve's launches of a kernel with a decode and a prefill body
    (``fused_sparse_linear``, ``nm_spmm``, ``paged_attention``, with
    ``_int8`` for that variant) by path, for ``kernel_entry``."""
    name, int8, _ = kernel.partition("_int8")
    return {path: launches[f"{name}_{path}{int8}"]
            for path in ("decode", "prefill")}


def kernel_entry(name, cases, launches, by_path=None, by_hd=None):
    """One entry of the kernels line; times are sums over the cases (16
    (projection, M) cases of a weight kernel, the 4 phase-2b cases of paged
    attention, for each variant; 48 (projection, pattern, M) cases of
    outlier_spmm in phase 8(d)).  A weight kernel's entry, outlier_spmm's
    and paged_attention's also split their cases and main-path launches by
    path (``by_path``: decode at M <= T, or rows S * n_rep <= T for paged
    attention; prefill above), each with the old kernel's time on the same
    cases (``tile_ms`` for the weight kernels; ``old_ms`` for outlier_spmm
    and for paged_attention, its old kernel forced on each case)."""
    replaces, source = KERNELS[name]
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches,
             "max_abs_err": max(c["max_abs_err"] for c in cases),
             **case_sums(cases), "cases": cases}
    for path, n in (by_path or {}).items():
        part = [c for c in cases if c.get("path") == path]
        entry[path] = dict(case_sums(part), launches=n, cases=len(part))
    # paged attention at a head dim of its own (``by_hd``: hd -> the
    # launches of the serves at that width): its cases' sums, and its
    # launches split by body
    for hd, runs in (by_hd or {}).items():
        part = [c for c in cases if c.get("hd") == hd]
        entry[f"hd{hd}"] = dict(
            case_sums(part), cases=len(part), launches=runs[name],
            **{f"launches_{path}": n for path, n in paths(runs, name).items()})
    return entry


# ------------------------------------------------------------------ model
def small_model_phase(torch, log):
    """One prefill step of a small sparse model on the card, on the slot
    layout and on shuffled paged blocks, against the same weights in f32 on
    the CPU: bf16 weights and KV, and int8 weights (quantized from the same
    draws) on int8 KV arenas."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm
    from repro_torch.models.sparse_serving import SparseWeight
    from repro_torch.serving.cache_pool import SlotPoolView, kv_arenas
    from repro_torch.serving.paged import PagedPoolView

    cfg = get_smoke("llama-paper")
    args = serve.parse_args(["--arch", "llama-paper", "--smoke-arch",
                             "--sparse"])
    g = torch.Generator(device="cuda").manual_seed(2)
    params, _ = serve.build_params(cfg, args, "cuda", g)
    params8, _ = serve.build_params(
        cfg, args, "cuda", torch.Generator(device="cuda").manual_seed(2),
        quantize=True)

    def to_cpu_f32(leaf):
        if isinstance(leaf, SparseWeight):
            return leaf.map(lambda t: t.to("cpu", torch.float32)
                            if t.is_floating_point() else t.to("cpu"))
        return leaf.to("cpu", torch.float32)

    def ref(ps):
        return {k: ([{n: to_cpu_f32(v) for n, v in lp.items()} for lp in p]
                    if k == "layers" else to_cpu_f32(p))
                for k, p in ps.items()}

    for ps, dtype in ((params, torch.bfloat16), (params8, torch.int8)):
        check(all(isinstance(lp[n], SparseWeight)
                  and lp[n].o_values is not None
                  and lp[n].nm_values.dtype == dtype
                  for lp in ps["layers"] for n in ("wq", "w_down")),
              f"small model: projections not deployed as {dtype} with "
              f"outliers")
    B, S, max_len = 2, 48, 64
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=g, device="cuda")
    bs, per_lane = 16, max_len // 16
    tables = 1 + torch.randperm(B * per_lane + 3, generator=torch.Generator()
                                .manual_seed(2))[:B * per_lane]
    tables = tables.reshape(B, per_lane).numpy()        # block 0: trash
    outs = {}
    # name: (device, params, dtype, kv_dtype, paged)
    runs = {"cuda": ("cuda", params, torch.bfloat16, "bf16", False),
            "cuda_paged": ("cuda", params, torch.bfloat16, "bf16", True),
            "cpu": ("cpu", ref(params), torch.float32, "bf16", False),
            "cuda_int8": ("cuda", params8, torch.bfloat16, "int8", False),
            "cuda_int8_paged": ("cuda", params8, torch.bfloat16, "int8", True),
            "cpu_int8": ("cpu", ref(params8), torch.float32, "int8", False)}
    for name, (dev, p, dtype, kv_dtype, paged) in runs.items():
        c = dataclasses.replace(cfg, dtype=dtype)
        if paged:
            shape = (c.n_layers, B * per_lane + 4, bs, c.n_kv_heads, c.hd)
        else:
            shape = (c.n_layers, B, max_len, c.n_kv_heads, c.hd)
        k, v, ks, vs = kv_arenas(shape, kv_dtype, dtype, dev)
        if paged:
            view = PagedPoolView.build(k, v, tables, [0, 0], [S, S - 5], S,
                                       trash=0, k_scale=ks, v_scale=vs)
        else:
            view = SlotPoolView.build(k, v, [0, 1], [0, 0], [S, S - 5], S,
                                      k_scale=ks, v_scale=vs)
        with torch.no_grad():
            logits, _ = tfm.unified_step(p, view, {"tokens": tokens.to(dev)},
                                         c)
        outs[name] = logits.float().cpu()
    result = {}
    for name, ref_name, key in (("cuda", "cpu", ""),
                                ("cuda_paged", "cpu", "paged_"),
                                ("cuda_int8", "cpu_int8", "int8_"),
                                ("cuda_int8_paged", "cpu_int8",
                                 "int8_paged_")):
        scale = float(outs[ref_name].abs().max())
        err = float((outs[name] - outs[ref_name]).abs().max())
        agree = float((outs[name].argmax(-1) == outs[ref_name].argmax(-1))
                      .float().mean())
        log(f"  small model ({name}): max|card-{ref_name}_f32| {err:.3e} of "
            f"scale {scale:.3e}, greedy agreement {agree:.3f}")
        check(bool(torch.isfinite(outs[name]).all()),
              f"small model ({name}): non-finite")
        check(err <= MODEL_TOL_REL * scale,
              f"small model ({name}): error {err:.3e} > {MODEL_TOL_REL} x "
              f"{scale:.3e}")
        result.update({f"{key}scale": scale, f"{key}max_abs_err": err,
                       f"{key}greedy_agreement": agree})
    return result


def attention_case(torch, g, cursors, S, window, H, KV, hd, bs, nb=0):
    """bf16 q and arenas for one phase-2b case, with shuffled,
    non-contiguous block tables padded with the trash block (id 0) to two
    entries past the longest lane, or to ``nb`` entries if that is more."""
    B = len(cursors)
    need = [-(-(c + S) // bs) for c in cursors]
    nb = max(max(need) + 2, nb)
    n_blocks = 1 + sum(need) + 8
    perm = (torch.randperm(n_blocks - 1, generator=g) + 1).tolist()
    tables = torch.zeros((B, nb), dtype=torch.int32)
    for b, n in enumerate(need):
        tables[b, :n] = torch.tensor(perm[:n], dtype=torch.int32)
        perm = perm[n:]
    q = torch.randn((B, S, H, hd), generator=g)
    k = torch.randn((n_blocks, bs, KV, hd), generator=g)
    v = torch.randn((n_blocks, bs, KV, hd), generator=g)
    cur = torch.tensor(cursors, dtype=torch.int32)
    return ([t.to(torch.bfloat16).cuda() for t in (q, k, v)]
            + [tables.cuda(), cur.cuda()])


def attention_bound(cursors, S, window, H, KV, hd, bs, int8=False):
    """Least time for the case: the KV blocks its queries can see read once
    (bf16, or int8 values plus a 4-byte scale per position and KV head)
    plus q read and out written at the HBM rate, or the multiply-adds of
    the visible (query, key) pairs (QK^T and PV) at the bf16 peak."""
    kv_bytes = ops = 0
    per_row = hd + 4 if int8 else 2 * hd     # bytes per (position, KV head)
    for c in cursors:
        lo = 0 if window is None else max(0, c - window + 1)
        blocks = -(-(c + S) // bs) - lo // bs
        kv_bytes += blocks * bs * KV * per_row * 2
        for i in range(S):
            keys = c + i + 1 if window is None else min(c + i + 1, window)
            ops += 4 * H * hd * keys
    qo_bytes = 2 * len(cursors) * S * H * hd * 2
    t_bytes = (kv_bytes + qo_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def row_ratio(out, ref):
    """The worst of paged_attention's output rows (a lane's query and q
    head): max|out - ref| over the row's columns over ``KERNEL_TOL_REL``
    times the row's max|ref| (0 where both are 0, inf where only the
    error is).  The decode body passes at <= 1."""
    err = (out.float() - ref.float()).abs().amax(-1)
    tol = KERNEL_TOL_REL * ref.float().abs().amax(-1)
    ratio = err / tol
    ratio[err == 0] = 0.0
    return float(ratio.max())


def attention_run(torch, timer, log, label, case_args, q, k, v, tables, cur,
                  scales, shape=None, decode_max_rows=None):
    """One phase-2b case of one variant: kernel against plain version, gated
    at one bf16 ulp of the largest output (the decode body: of each row's
    largest output, ``row_ratio``), timed beside the plain version,
    SDPA on the pre-gathered (dequantized) K/V with the same boolean mask
    (the library yardstick, never called by the port) and the bound.
    ``shape`` is the case's H, KV, hd and bs (``ATTN_SHAPE`` by default);
    ``decode_max_rows`` forces ``plan``'s threshold (the decode body where
    the rows exceed T); the old kernel, built for hd 64 and 128, is timed
    beside those only."""
    old_hd = (64, 128)
    import torch.nn.functional as F
    from repro_torch.serving.paged import paged_attention as pa

    shape = shape or ATTN_SHAPE
    name, cursors, S, window = case_args
    kw = dict(window=window)
    if scales is not None:
        kw.update(k_scale=scales[0], v_scale=scales[1])
    B, nb = tables.shape
    bs, KV, hd = k.shape[1], k.shape[2], k.shape[3]
    p = pa.plan(B, S, q.shape[2], KV, hd, bs, sm_count(torch), nb=nb,
                decode_max_rows=decode_max_rows or pa.DECODE_MAX_ROWS)
    forced = p if decode_max_rows else None

    def kern():
        return pa.paged_attention(q, k, v, tables, cur, force_plan=forced,
                                  **kw)

    def plain():
        return pa.plain(q, k, v, tables, cur, **kw)
    out, ref = kern(), plain()
    torch.cuda.synchronize()
    check(out.shape == q.shape and out.dtype == torch.bfloat16,
          f"{label} {name}: {tuple(out.shape)} {out.dtype}")
    check(bool(torch.isfinite(out).all()),
          f"{label} {name}: non-finite output")
    err = float((out.float() - ref.float()).abs().max())
    tol = KERNEL_TOL_REL * float(ref.float().abs().max())
    check(err <= tol, f"{label} {name}: max|kernel-plain| {err:.3e} > tol "
                      f"{tol:.3e}")
    worst = row_ratio(out, ref)
    check(p.path != "decode" or worst <= 1,
          f"{label} {name}: a row's max|kernel-plain| is {worst:.3f} x "
          f"2^-7 of its largest output")
    again = kern()
    torch.cuda.synchronize()
    check(torch.equal(out, again),
          f"{label} {name}: two calls give different bits")

    # the old kernel, which ran every case before the two bodies, forced on
    # the same inputs (hd 64 and 128 only)
    def old():
        return pa.paged_attention(q, k, v, tables, cur,
                                  force_plan=pa.Plan("tile"), **kw)
    if hd in old_hd:
        o = old()
        torch.cuda.synchronize()
        e = float((o.float() - ref.float()).abs().max())
        check(e <= tol, f"{label} {name}: old kernel max|kernel-plain| "
                        f"{e:.3e} > tol {tol:.3e}")
    idx = tables.long()
    kc, vc = k[idx], v[idx]
    if scales is not None:
        kc = (kc.float() * scales[0][idx][..., None]).to(torch.bfloat16)
        vc = (vc.float() * scales[1][idx][..., None]).to(torch.bfloat16)
    kc = kc.reshape(B, nb * bs, KV, hd).transpose(1, 2)
    vc = vc.reshape(B, nb * bs, KV, hd).transpose(1, 2)
    qt = q.transpose(1, 2)
    qpos = cur[:, None] + torch.arange(S, device="cuda")[None]
    kpos = torch.arange(nb * bs, device="cuda")
    mask = kpos[None, None] <= qpos[..., None]
    if window is not None:
        mask &= kpos[None, None] > qpos[..., None] - window
    mask = mask[:, None]

    def library():
        return F.scaled_dot_product_attention(qt, kc, vc, attn_mask=mask,
                                              enable_gqa=True)
    b_ms, b_by = attention_bound(cursors, S, window, **shape,
                                 int8=scales is not None)
    case = {"case": name, "B": B, "S": S, "cursors": cursors,
            "window": window, "max_abs_err": err, "tol": tol,
            "row_ratio": worst, "H": q.shape[2], "KV": KV, "hd": hd,
            "path": p.path, "rows": p.rows, "splits": p.splits,
            "ms": timer.ms(kern, 20), "plain_ms": timer.ms(plain, 5),
            "library_ms": timer.ms(library, 20),
            "bound_ms": b_ms, "bound_by": b_by}
    old_txt = ""
    if hd in old_hd:
        case["old_ms"] = timer.ms(old, 20)
        old_txt = f"  old kernel {case['old_ms']:.4f}"
    log(f"  {label:20s} {name:18s}: err {err:.2e} (tol {tol:.2e}, worst "
        f"row {worst:.3f})  "
        f"{p.path} {'R' if p.path == 'decode' else 'BM'} {p.rows} kernel "
        f"{case['ms']:.4f} ms{old_txt}  plain "
        f"{case['plain_ms']:.4f}  "
        f"sdpa {case['library_ms']:.4f}  bound {b_ms:.4f} ({b_by})")
    return case


def paged_attention_phase(torch, timer, log):
    """``paged_attention`` against its plain version at llama3-8b's
    attention shapes, on bf16 arenas and on int8 arenas quantized from the
    same K/V by ``quantize_kv``."""
    from repro_torch.serving.cache_pool import quantize_kv

    g = torch.Generator().manual_seed(3)
    cases, cases8 = [], []
    for case_args in ATTN_CASES:
        _, cursors, S, window = case_args
        q, k, v, tables, cur = attention_case(torch, g, cursors, S, window,
                                              **ATTN_SHAPE)
        cases.append(attention_run(torch, timer, log, "paged_attention",
                                   case_args, q, k, v, tables, cur, None))
        (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
        del k, v
        cases8.append(attention_run(torch, timer, log, "paged_attention_int8",
                                    case_args, q, k8, v8, tables, cur,
                                    (ks, vs)))
        del q, k8, v8, ks, vs
    return cases, cases8


def paged_attention_hd_phase(torch, timer, log):
    """``paged_attention`` at head dims 256 (gemma-7b), 192
    (nemotron-4-340b) and 80 (zamba2-2.7b) against its plain version, on
    bf16 arenas and on int8 arenas quantized from the same K/V, as
    ``paged_attention_phase``; the decode body forced where the model's
    decode rows exceed T."""
    from repro_torch.serving.cache_pool import quantize_kv
    from repro_torch.serving.paged import paged_attention as pa

    g = torch.Generator().manual_seed(4)
    cases, cases8 = [], []
    for arch, shape in ATTN_HD_SHAPES.items():
        n_rep = shape["H"] // shape["KV"]
        for case_args in ATTN_HD_CASES:
            name, cursors, S, window = case_args
            q, k, v, tables, cur = attention_case(torch, g, cursors, S,
                                                  window, **shape)
            (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
            limits = [None]
            if S * n_rep > pa.DECODE_MAX_ROWS and S == 1:
                limits.append(S * n_rep)
            for limit in limits:
                args = (f"{name}_{arch}" + ("_decode_body" if limit else ""),
                        cursors, S, window)
                for out, label, kv, sc in (
                        (cases, "paged_attention", (k, v), None),
                        (cases8, "paged_attention_int8", (k8, v8), (ks, vs))):
                    out.append(attention_run(
                        torch, timer, log, label, args, q, *kv, tables, cur,
                        sc, shape=shape, decode_max_rows=limit))
            del q, k, v, k8, v8, ks, vs
    return cases, cases8


def attention_sweep_phase(torch, timer, log):
    """``paged_attention``'s decode body against its prefill-chunk body,
    and the old kernel beside them, each forced by its plan, bf16 and int8
    arenas, for every S of ``ATTN_SWEEP_S`` (rows S * n_rep = 4..256) at
    two sets of 8 lanes: the decode case's (``long``, cursors 15..1000) and
    ``ATTN_SWEEP_SHORT``'s (``short``, ~64 tokens through 64-entry
    tables); each gated against the plain version (the decode body row by
    row).  T is the largest row count at which the decode body was no
    slower than the prefill-chunk body in both variants at the decode
    case's lanes (0 where it was slower at every row count); the same
    count at the short lanes is reported beside it."""
    from repro_torch.serving.cache_pool import quantize_kv
    from repro_torch.serving.paged import paged_attention as pa

    g = torch.Generator().manual_seed(5)
    H, KV, hd, bs = (ATTN_SHAPE[k] for k in ("H", "KV", "hd", "bs"))
    cases = []
    for lanes, (cursors, nb) in (("long", (ATTN_CASES[0][1], 0)),
                                 ("short", ATTN_SWEEP_SHORT)):
        for S in ATTN_SWEEP_S:
            q, k, v, tables, cur = attention_case(torch, g, cursors, S, None,
                                                  **ATTN_SHAPE, nb=nb)
            (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
            rows = S * H // KV
            plans = {path: pa.plan(len(cursors), S, H, KV, hd, bs,
                                   sm_count(torch), nb=tables.shape[1],
                                   decode_max_rows=limit)
                     for path, limit in (("decode", rows), ("prefill", 0))}
            plans["old"] = pa.Plan("tile")
            for variant, args, kw in (
                    ("bf16", (k, v), {}),
                    ("int8", (k8, v8), dict(k_scale=ks, v_scale=vs))):
                ref = pa.plain(q, *args, tables, cur, **kw)
                tol = KERNEL_TOL_REL * float(ref.float().abs().max())
                case = {"lanes": lanes, "S": S, "rows": rows,
                        "variant": variant, "nb": tables.shape[1],
                        "decode_rows": plans["decode"].rows,
                        "decode_splits": plans["decode"].splits,
                        "prefill_rows": plans["prefill"].rows}
                for path, p in plans.items():
                    def run(p=p):
                        return pa.paged_attention(q, *args, tables, cur,
                                                  force_plan=p, **kw)
                    out = run()
                    torch.cuda.synchronize()
                    err = float((out.float() - ref.float()).abs().max())
                    check(bool(torch.isfinite(out).all()) and err <= tol,
                          f"attention sweep {lanes} {variant} S={S} {path}: "
                          f"max|kernel-plain| {err:.3e} > tol {tol:.3e}")
                    if path == "decode":
                        worst = row_ratio(out, ref)
                        check(worst <= 1,
                              f"attention sweep {lanes} {variant} S={S} "
                              f"decode: a row's max|kernel-plain| is "
                              f"{worst:.3f} x 2^-7 of its largest output")
                        case["decode_row_ratio"] = worst
                    case[f"{path}_ms"] = timer.ms(run, 20)
                    case[f"{path}_err"] = err
                cases.append(case)
                log(f"  attention sweep {lanes:5s} {variant} S={S:3d} "
                    f"rows={rows:4d}: decode {case['decode_ms']:.4f} ms (R "
                    f"{case['decode_rows']}, {case['decode_splits']} splits)"
                    f"  prefill {case['prefill_ms']:.4f} (BM "
                    f"{case['prefill_rows']})  old {case['old_ms']:.4f}")
            del q, k, v, k8, v8, ks, vs

    def no_slower(cs):
        return [r for r in sorted({c["rows"] for c in cs})
                if all(c["decode_ms"] <= c["prefill_ms"] for c in cs
                       if c["rows"] == r)]
    faster, short = (no_slower([c for c in cases if c["lanes"] == lanes])
                     for lanes in ("long", "short"))
    T, T_short = (max(f) if f else 0 for f in (faster, short))
    log(f"  attention sweep: decode body no slower at rows {faster} at the "
        f"decode case's lanes, {short} at short lanes; T measured {T} "
        f"(short lanes {T_short}), module T (DECODE_MAX_ROWS) "
        f"{pa.DECODE_MAX_ROWS}")
    return {"T_measured": T, "T_short_lanes": T_short,
            "T_in_module": pa.DECODE_MAX_ROWS, "decode_no_slower_at": faster,
            "decode_no_slower_at_short_lanes": short, "cases": cases}


def _kernel_class(name: str) -> str:
    for cls in ("fused_decode", "fused_prefill", "nm_decode", "nm_prefill"):
        if cls in name:
            return cls
    if "sparse_linear_kernel" in name:
        return "sparse_linear"
    if any(k in name for k in ("paged_attention_kernel",
                               "paged_decode_kernel",
                               "paged_prefill_kernel")):
        return "paged_attention"
    if any(s in name.lower() for s in ("gemm", "cutlass", "xmma", "cublas",
                                       "nvjet")):
        return "dense_gemm"
    if "softmax" in name.lower():
        return "softmax"
    if "nccl" in name.lower():
        return "collective"
    return "other"


def family_kw(torch, engine, g) -> dict:
    """The ``submit`` keywords an engine's family needs beside the prompt:
    an enc-dec request's encoder features (``max_ctx`` frames of bf16
    N(0, 1) from ``g``), nothing for the others."""
    if engine.cfg.family != "encdec":
        return {}
    return {"embeds": torch.randn(
        (engine.adapter.ctx.max_ctx, engine.cfg.d_model), generator=g,
        device="cuda").to(torch.bfloat16)}


def profile_decode(torch, engine, g, n_steps=2):
    """Device time by kernel class over ``n_steps`` fused decode steps of
    all 8 lanes (torch.profiler; the profiler's own host cost lengthens the
    wall time it sees, so the idle share is also given against the
    unprofiled decode step).  None when the profiler records no device
    kernels."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import SamplingParams, Status

    reqs = [engine.submit(torch.randint(0, engine.cfg.vocab, (64,),
                                        generator=g, device="cuda").tolist(),
                          SamplingParams(max_new_tokens=n_steps + 2),
                          **family_kw(torch, engine, g))
            for _ in range(engine.pool.n_slots)]
    while not all(r.status is Status.RUNNING for r in reqs):
        engine.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            st = engine.step()
            check(st["prefill_tokens"] == 0 and st["decoded"] == len(reqs),
                  f"profiled step was not a pure decode step: {st}")
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    engine.run()
    got = _device_time(prof, n_steps)
    if got is None:
        return None
    busy, by_class, count_by_class, top, count = got
    return {"steps": n_steps, "profiled_step_ms": wall_us / n_steps / 1e3,
            "device_busy_ms_per_step": busy,
            "idle_share_profiled": 1.0 - busy * 1e3 * n_steps / wall_us,
            "device_ms_per_step_by_class": by_class,
            "launches_per_step_by_class": count_by_class,
            "kernels_per_step": count, "top_kernels_ms_per_step": top}


def _device_time(prof, n_steps):
    """From a profile over ``n_steps`` steps: device-busy ms per step (the
    union of the kernels' spans), ms and launches per step by kernel class,
    the six costliest kernels' ms per step, and kernels per step; None when
    the profiler recorded no device kernels."""
    from torch.autograd import DeviceType
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return None
    by_class, count_by_class, by_name = {}, {}, {}
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    for e in kernels:
        us, cls = e.time_range.elapsed_us(), _kernel_class(e.name)
        by_class[cls] = by_class.get(cls, 0.0) + us / n_steps / 1e3
        count_by_class[cls] = count_by_class.get(cls, 0) + 1 / n_steps
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return (busy / n_steps / 1e3, by_class, count_by_class,
            {k: v / n_steps / 1e3 for k, v in top}, len(kernels) / n_steps)


def profile_prefill(torch, engine, g, tokens=PREFILL_PROFILE_TOKENS):
    """Device time by kernel class over one model call that prefills one
    ``tokens``-long prompt as a single chunk on an idle engine
    (torch.profiler), with its launches by class and the device's busy
    share of the profiled call's wall time (an enc-dec request's step also
    holds its admission's encoder call).  None when the profiler records
    no device kernels."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import SamplingParams

    engine.submit(torch.randint(0, engine.cfg.vocab, (tokens,), generator=g,
                                device="cuda").tolist(),
                  SamplingParams(max_new_tokens=1),
                  **family_kw(torch, engine, g))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st = engine.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    check(st["prefill_tokens"] == tokens and st["decoded"] == 0,
          f"profiled prefill call was not one {tokens}-token chunk: {st}")
    engine.run()
    got = _device_time(prof, 1)
    if got is None:
        return None
    busy, by_class, count_by_class, top, count = got
    return {"chunk_tokens": tokens, "profiled_call_ms": wall_ms,
            "device_busy_ms": busy, "busy_share_profiled": busy / wall_ms,
            "device_ms_by_class": by_class,
            "launches_by_class": count_by_class, "kernels": count,
            "top_kernels_ms": top}


# the leaves ``sparsify_for_serving`` compresses beside the dense family's
# PROJ_NAMES, as JAX's ``_leaf_cfg`` picks them: xLSTM's projections
# (``w_gates`` and ``r_gates`` stay dense) and Zamba2's mamba projections
# (``A_log``, ``D``, ``dt_bias`` stay dense; its shared block takes
# PROJ_NAMES)
XLSTM_SPARSE = ("w_up", "w_q", "w_k", "w_v", "w_down", "w_slstm")
MAMBA_SPARSE = ("in_proj", "out_proj")
# a moe layer compresses its attention and its shared expert (the routed
# experts ``we_*`` are 3-D and the router is skipped by name: both dense);
# an enc-dec model every attention, cross-attention and MLP projection
ATTN_PROJ = ("wq", "wk", "wv", "wo")
MOE_SHARED_SPARSE = ("ws_gate", "ws_up", "ws_down")


def sparse_names(cfg) -> set:
    """The paths of every projection a compressed ``cfg`` model deploys as
    a SparseWeight."""
    dense = [n for n in PROJ_NAMES if n != "w_gate" or cfg.glu]
    L = range(cfg.n_layers)
    if cfg.family == "ssm":
        return {f"layers/{i}/{n}" for i in L for n in XLSTM_SPARSE}
    if cfg.family == "hybrid":
        return ({f"mamba/{i}/{n}" for i in L for n in MAMBA_SPARSE}
                | {f"shared_attn/{n}" for n in dense})
    if cfg.family == "moe":
        shared = MOE_SHARED_SPARSE if cfg.moe.shared_expert else ()
        return {f"layers/{i}/{n}" for i in L
                for n in ATTN_PROJ + tuple(f"moe/{m}" for m in shared)}
    if cfg.family == "encdec":
        enc = ATTN_PROJ + ("w_up", "w_down")
        return ({f"enc/{i}/{n}" for i in range(cfg.enc_layers) for n in enc}
                | {f"dec/{i}/{n}" for i in L
                   for n in enc + tuple(f"c_{a}" for a in ATTN_PROJ)})
    return {f"layers/{i}/{n}" for i in L for n in dense}


def sparse_leaves(params) -> dict:
    """path: SparseWeight of every compressed leaf of a params tree (a mesh
    rank's rows of it where a placement split it)."""
    from repro_torch.core.pipeline import map_leaves
    from repro_torch.models.sparse_serving import SparseWeight
    from repro_torch.parallel import RowShard
    out = {}

    def one(name, leaf):
        leaf = leaf.local if isinstance(leaf, RowShard) else leaf
        if isinstance(leaf, SparseWeight):
            out[name] = leaf
    map_leaves(params, one)
    return out


def launches_per_call(cfg) -> tuple[int, int]:
    """(weight kernel launches, paged attention launches on the paged
    layout) of one model call: every projection the call reads (an mLSTM
    layer's 5, an sLSTM layer's 3; a mamba layer's 2 and the shared block's
    projections once per application; a moe layer's 4 attention
    projections and 3 shared-expert ones; an enc-dec decoder layer's 8,
    its cross-attention's K/V projections being the encoder call's), and
    one attention launch per attention layer or application (the enc-dec
    family is slot-only: none)."""
    if cfg.family == "moe":
        return (len(ATTN_PROJ) + 3 * cfg.moe.shared_expert) * cfg.n_layers, \
            cfg.n_layers
    if cfg.family == "encdec":
        return 8 * cfg.n_layers, 0
    proj = sum(1 for n in PROJ_NAMES if n != "w_gate" or cfg.glu)
    if cfg.family == "ssm":
        k = cfg.slstm_every
        n_s = sum(1 for i in range(cfg.n_layers) if k and i % k == k - 1)
        return 3 * n_s + 5 * (cfg.n_layers - n_s), 0
    if cfg.family == "hybrid":
        apps = cfg.n_layers // cfg.attn_every
        return 2 * cfg.n_layers + proj * apps, apps
    return proj * cfg.n_layers, cfg.n_layers


def encode_launches(cfg) -> int:
    """Weight kernel launches of one enc-dec encoder call: an encoder
    layer's 6 projections and every decoder layer's ``c_wk``/``c_wv``."""
    return 6 * cfg.enc_layers + 2 * cfg.n_layers


def build_model(torch, log, *, arch="llama3-8b", n_layers=None,
                outlier="16:256", quantize=False, **cut):
    """``arch`` (llama3-8b by default) at full width (``n_layers`` deep;
    ``cut`` replaces other depth fields: ``enc_layers``, ``slstm_every``,
    ``attn_every``), every projection a SparseWeight (int8 N:M values when
    ``quantize``), drawn from seed 0; returns (cfg, params, build
    numbers)."""
    from repro_torch.configs import get
    from repro_torch.launch import serve

    cfg = dataclasses.replace(get(arch), **cut)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    args = serve.parse_args(["--arch", arch, "--sparse",
                             "--outlier-pattern", outlier or "none"])
    g = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params, report = serve.build_params(cfg, args, "cuda", g,
                                        quantize=quantize)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    found = sparse_leaves(params)
    check(set(found) == sparse_names(cfg)
          and isinstance(params["embed"], torch.Tensor),
          "not every projection is a SparseWeight (or a leaf that stays "
          f"dense is one): {sorted(set(found) ^ sparse_names(cfg))[:8]}")
    sws = list(found.values())
    # a projection whose in-dim is not a multiple of 256 keeps no outliers
    # (``sparse_serving.leaf_cfg``: qwen2-vl-72b's down projection)
    check(all((s.o_values is not None)
              == (outlier is not None and s.in_dim % 256 == 0) for s in sws),
          "outlier buffers do not match the pattern")
    want = torch.int8 if quantize else torch.bfloat16
    check(all(s.nm_values.dtype == want and (s.v_scale is not None) == quantize
              for s in sws), f"N:M values are not {want}")
    log(f"  built {cfg.n_layers} layers in {build_s:.1f}s: "
        f"{report['n_layers_sparsified']} matrices, "
        f"{report['compressed_bytes'] / 1e9:.2f} GB compressed "
        f"({report['ratio']:.4f} of dense)")
    return cfg, params, {"build_s": build_s, "outliers": outlier,
                         "values": "int8" if quantize else "bf16",
                         "compressed_gb": report["compressed_bytes"] / 1e9,
                         "dense_gb": report["dense_bytes"] / 1e9}


def prompts_for(torch, cfg, lens, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randint(0, cfg.vocab, (n,), generator=g,
                          device="cuda").tolist() for n in lens]


def _counters():
    """(kernel name, module, counter attribute) of every kernel variant."""
    from repro_torch.kernels import fused_sparse_linear as fsl
    from repro_torch.kernels import nm_spmm as nms
    from repro_torch.kernels import outlier_spmm as osp
    from repro_torch.serving.paged import paged_attention as pa
    return [(name + suffix, mod, "launches" + suffix)
            for name, mod in (("fused_sparse_linear", fsl), ("nm_spmm", nms),
                              ("paged_attention", pa))
            for suffix in ("", "_int8")] + [
        (f"paged_attention_tile{suffix}", pa, f"launches_tile{suffix}")
        for suffix in ("", "_int8")] + [
        (f"{name}_{path}{suffix}", mod, f"launches_{path}{suffix}")
        for name, mod in (("fused_sparse_linear", fsl), ("nm_spmm", nms),
                          ("paged_attention", pa))
        for path in ("decode", "prefill") for suffix in ("", "_int8")] + [
        ("outlier_spmm", osp, "launches"),
        ("outlier_spmm_decode", osp, "launches_decode"),
        ("outlier_spmm_prefill", osp, "launches_prefill")]


def reset_launches():
    for _, mod, attr in _counters():
        setattr(mod, attr, 0)


def read_launches() -> dict:
    return {name: getattr(mod, attr) for name, mod, attr in _counters()}


def drive(torch, engine, waves, gen, embeds=None):
    """Serve ``waves`` of prompts greedily, each wave submitted once every
    request of the earlier waves has finished its prefill, with every
    kernel's launch count set to 0 just before and read just after; an
    enc-dec engine's requests carry ``embeds`` (one list a wave, parallel
    to its prompts).  Returns (requests, wall seconds, decode-only step
    seconds, launches)."""
    from repro_torch.serving import SamplingParams, Status
    sp = SamplingParams(max_new_tokens=gen)
    reqs, decode_only = [], []
    pending = [list(zip(w, e)) for w, e in
               zip(waves, embeds or [[None] * len(w) for w in waves])]
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    while pending or engine.has_work:
        if pending and all(r.status not in (Status.QUEUED, Status.PREFILLING)
                           for r in reqs):
            reqs += [engine.submit(p, sp, embeds=e)
                     for p, e in pending.pop(0)]
        s0 = time.perf_counter()
        st = engine.step()
        torch.cuda.synchronize()
        if st["prefill_tokens"] == 0 and st["decoded"] > 0:
            decode_only.append(time.perf_counter() - s0)
        check(bool(torch.isfinite(engine._slot_logits).all()),
              f"non-finite logits at step {engine.n_steps}")
    wall = time.perf_counter() - t0
    launches = read_launches()
    for r in reqs:
        check(r.status is Status.FINISHED and len(r.tokens) == gen,
              f"request {r.request_id}: {r.status}, {len(r.tokens)} tokens")
        check(all(0 <= t < engine.cfg.vocab for t in r.tokens),
              f"request {r.request_id}: token outside the vocab")
        check(all(math.isfinite(lp) for lp in r.logprobs),
              f"request {r.request_id}: non-finite logprob")
    return reqs, wall, decode_only, launches


def serve_numbers(torch, engine, reqs, wall, decode_only, launches):
    """Check each kernel's launches against the model calls of the run and
    summarise it."""
    import numpy as np
    from repro_torch.runtime.metrics import summarize
    cfg, st = engine.cfg, engine.stats()
    calls = st["n_model_calls"]
    sw = next(iter(sparse_leaves(engine.params).values()))
    suffix = "" if sw.v_scale is None else "_int8"
    weight_key = ("fused_sparse_linear" if sw.o_values is not None
                  else "nm_spmm") + suffix
    # every projection a model call reads, once (``launches_per_call``);
    # an enc-dec engine's encoder calls besides
    per_call, attn_per_call = launches_per_call(cfg)
    encodes = getattr(engine.adapter, "n_encode_calls", 0)
    want = {weight_key: per_call * calls + encode_launches(cfg) * encodes}
    attn_key = None
    if engine.kv_layout == "paged":
        attn_key = "paged_attention" + (
            "_int8" if engine.kv_dtype == "int8" else "")
        want[attn_key] = attn_per_call * calls
    check_launch_counts(launches, want,
                        f"{cfg.name}, {cfg.n_layers} layers, {calls} model "
                        f"calls, {engine.kv_layout} layout, "
                        f"{engine.kv_dtype} KV")
    # each weight wrapper's calls split by path: every call is a decode
    # kernel launch (M <= T, decode steps) or a prefill kernel launch
    # (chunks longer than T); both run in a serve while T >= 1.  The paged
    # kernel's calls split by body the same way: decode steps (S * n_rep
    # <= T) take the decode body, longer prefill chunks the prefill-chunk
    # body; where a decode step's rows n_rep exceed T (nemotron-4-340b's
    # 12) the decode steps take the prefill-chunk body too
    from repro_torch.kernels import fused_sparse_linear as fsl
    from repro_torch.serving.paged import paged_attention as pa
    n_rep = cfg.n_heads // cfg.n_kv_heads
    attn_t = pa.DECODE_MAX_ROWS if n_rep <= pa.DECODE_MAX_ROWS else 0
    for key, t in ((weight_key, fsl.DECODE_MAX_M), (attn_key, attn_t)):
        if key is None:
            continue
        name, int8, _ = key.partition("_int8")
        dec = launches[f"{name}_decode{int8}"]
        pre = launches[f"{name}_prefill{int8}"]
        check(pre > 0 and (dec > 0 or t == 0),
              f"{key}: decode body launched {dec}, prefill body {pre} of "
              f"the wrapper's {launches[key]}")
    s = summarize([r.metrics for r in reqs], wall)
    return {"arch": cfg.name, "layers": cfg.n_layers,
            "kv_layout": engine.kv_layout,
            "kv_dtype": engine.kv_dtype,
            "requests": len(reqs), "tokens": s["total_tokens"],
            "wall_s": wall, "tok_per_s": s["tok_per_s"],
            "ttft_ms": {k: v * 1e3 for k, v in s["ttft"].items()},
            "itl_ms": {k: v * 1e3 for k, v in s["itl"].items()},
            "decode_step_ms": {
                "p50": float(np.percentile(decode_only, 50)) * 1e3,
                "mean": float(np.mean(decode_only)) * 1e3,
                "n": len(decode_only)} if decode_only else None,
            "families": s.get("families"),
            "steps": st["n_steps"], "model_calls": calls,
            "encode_calls": encodes,
            "max_running": st["max_running"],
            "n_preemptions": st["n_preemptions"], "launches": launches,
            "pool": st["pool"],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def check_launch_counts(launches, want, label):
    """Every counter but the body splits equals ``want`` (0 where absent),
    and each wrapper's decode and prefill launches sum to its total."""
    names = ("fused_sparse_linear", "nm_spmm", "paged_attention")
    split = tuple(f"{name}_{path}" for name in names
                  for path in ("decode", "prefill"))
    for key, n in launches.items():
        if key.startswith(split):
            continue
        check(n == want.get(key, 0),
              f"{key} launched {n} times, want {want.get(key, 0)} ({label})")
    for name in names:
        for suffix in ("", "_int8"):
            dec = launches[f"{name}_decode{suffix}"]
            pre = launches[f"{name}_prefill{suffix}"]
            total = launches[name + suffix]
            check(dec + pre == total,
                  f"{name}{suffix}: decode {dec} + prefill {pre} launches "
                  f"!= the wrapper's {total} ({label})")


def add_profile(torch, engine, out, seed, prefill=True):
    g = torch.Generator(device="cuda").manual_seed(seed)
    prof = profile_decode(torch, engine, g)
    if prof is not None and out["decode_step_ms"]:
        prof["idle_share_vs_unprofiled_step"] = 1.0 - (
            prof["device_busy_ms_per_step"] / out["decode_step_ms"]["p50"])
    out["decode_profile"] = prof
    if prefill:
        out["prefill_profile"] = profile_prefill(
            torch, engine, g, min(PREFILL_PROFILE_TOKENS,
                                  engine.pool.max_request_tokens - 1))


class counted_collectives:
    """Within the block, every collective a placed step issues (a
    ``ModelAxis`` gather or sum) is counted on the host: ``n``."""

    def __enter__(self):
        from repro_torch.parallel import ModelAxis
        self.n, self.saved = 0, (ModelAxis.gather, ModelAxis.sum)

        def counted(fn):
            def call(axis, *args, **kw):
                self.n += 1
                return fn(axis, *args, **kw)
            return call
        ModelAxis.gather, ModelAxis.sum = (counted(f) for f in self.saved)
        return self

    def __exit__(self, *exc):
        from repro_torch.parallel import ModelAxis
        ModelAxis.gather, ModelAxis.sum = self.saved
        return False


def serve_phase(torch, log, cfg, params, build, *, prompt_lens=SERVE_PROMPT_LENS,
                gen=SERVE_GEN, alone=True):
    """Serve ``prompt_lens`` through the slot engine; returns its numbers,
    the requests' token streams and the launches."""
    from repro_torch.serving import ServingEngine

    engine = ServingEngine(cfg, params, device="cuda", n_slots=8,
                           max_len=1024, token_budget=512)
    prompts = prompts_for(torch, cfg, prompt_lens, seed=10)
    torch.cuda.reset_peak_memory_stats()
    reqs, wall, decode_only, launches = drive(torch, engine, [prompts], gen)
    out = dict(build, **serve_numbers(torch, engine, reqs, wall, decode_only,
                                      launches))
    if alone:
        # each prompt served alone through the same engine, against its
        # stream in the batch (reported, not gated: a batch changes the
        # dense products' and the attention's bf16 rounding)
        match = 0
        for p, r in zip(prompts, reqs):
            solo, *_ = drive(torch, engine, [[p]], gen)
            match += solo[0].tokens == r.tokens
        out["alone_matches_batch"] = f"{match}/{len(reqs)}"
    add_profile(torch, engine, out, seed=11)
    log("  " + json.dumps(out))
    del engine
    torch.cuda.empty_cache()
    return out, [r.tokens for r in reqs], launches


def paged_serve_phase(torch, log, cfg, params, slot_streams):
    """Phase 6: the paged layout, three traffic shapes."""
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.paged import blocks_needed

    bs = ATTN_SHAPE["bs"]
    base = dict(device="cuda", n_slots=8, max_len=1024, token_budget=512,
                kv_layout="paged", block_size=bs)
    results = {}

    # (a) phase 4's traffic
    engine = ServingEngine(cfg, params, **base)
    prompts = prompts_for(torch, cfg, SERVE_PROMPT_LENS, seed=10)
    torch.cuda.reset_peak_memory_stats()
    reqs_a, wall, decode_only, launches_a = drive(torch, engine, [prompts],
                                                  SERVE_GEN)
    out = serve_numbers(torch, engine, reqs_a, wall, decode_only, launches_a)
    same = [r.tokens == s for r, s in zip(reqs_a, slot_streams)]
    agree = [a == b for r, s in zip(reqs_a, slot_streams)
             for a, b in zip(r.tokens, s)]
    out["slot_streams_identical"] = f"{sum(same)}/{len(same)}"
    out["slot_token_agreement"] = sum(agree) / len(agree)
    add_profile(torch, engine, out, seed=11)
    results["a_phase4_traffic"] = out
    log("  (a) " + json.dumps(out))
    del engine
    torch.cuda.empty_cache()

    # (b) prefix sharing, two waves of 4
    engine = ServingEngine(cfg, params, **base)
    cows = [0]
    copy_on_write = engine.pool.blocks.copy_on_write

    def counted(block):
        cows[0] += 1
        return copy_on_write(block)
    engine.pool.blocks.copy_on_write = counted
    prefix = prompts_for(torch, cfg, [PREFIX_LEN], seed=12)[0]
    wave1 = [prefix + s for s in
             prompts_for(torch, cfg, PREFIX_SUFFIX_LENS[0], seed=13)]
    wave2 = [prefix + s for s in
             prompts_for(torch, cfg, PREFIX_SUFFIX_LENS[1], seed=14)]
    i, n = PREFIX_REPEAT
    wave2.append(wave1[i][:PREFIX_LEN + n])
    torch.cuda.reset_peak_memory_stats()
    reqs, wall, decode_only, launches = drive(torch, engine, [wave1, wave2],
                                              SERVE_GEN)
    out = serve_numbers(torch, engine, reqs, wall, decode_only, launches)
    pc = out["pool"]["prefix_cache"]
    out["copy_on_write"] = cows[0]
    check(pc["hits"] > 0 and pc["hit_tokens"] >= 4 * PREFIX_LEN,
          f"prefix sharing: hits {pc['hits']}, hit tokens "
          f"{pc['hit_tokens']} < {4 * PREFIX_LEN}")
    check(cows[0] >= 1, "prefix sharing: no copy-on-write")
    results["b_prefix_sharing"] = out
    log("  (b) " + json.dumps(out))
    del engine
    torch.cuda.empty_cache()

    # (c) block pressure: half the blocks (a)'s 8 requests need at once
    need = sum(blocks_needed(n + SERVE_GEN, bs) for n in SERVE_PROMPT_LENS)
    engine = ServingEngine(cfg, params, n_blocks=need // 2, **base)
    torch.cuda.reset_peak_memory_stats()
    reqs, wall, decode_only, launches = drive(torch, engine, [prompts],
                                              SERVE_GEN)
    out = serve_numbers(torch, engine, reqs, wall, decode_only, launches)
    out["n_blocks"] = need // 2
    out["blocks_needed_at_once"] = need
    check(out["n_preemptions"] > 0, "block pressure: no preemption")
    results["c_block_pressure"] = out
    log("  (c) " + json.dumps(out))
    del engine
    torch.cuda.empty_cache()
    return results, launches_a, [r.tokens for r in reqs_a]


def int8_serve_phase(torch, log, cfg, params, paged_streams, pressure):
    """Phase 7: int8 weights on int8 paged KV arenas, (a) phase 4's traffic
    and (b) phase 6(c)'s traffic in the bytes of 6(c)'s bf16 arena."""
    from repro_torch.serving import ServingEngine

    base = dict(device="cuda", n_slots=8, max_len=1024, token_budget=512,
                kv_layout="paged", kv_dtype="int8",
                block_size=ATTN_SHAPE["bs"])
    prompts = prompts_for(torch, cfg, SERVE_PROMPT_LENS, seed=10)
    results = {}

    # (a) phase 4's traffic, 512 blocks as in 6(a)
    engine = ServingEngine(cfg, params, **base)
    torch.cuda.reset_peak_memory_stats()
    reqs, wall, decode_only, launches_a = drive(torch, engine, [prompts],
                                                SERVE_GEN)
    out = serve_numbers(torch, engine, reqs, wall, decode_only, launches_a)
    same = [r.tokens == s for r, s in zip(reqs, paged_streams)]
    agree = [a == b for r, s in zip(reqs, paged_streams)
             for a, b in zip(r.tokens, s)]
    out["bf16_paged_streams_identical"] = f"{sum(same)}/{len(same)}"
    out["bf16_paged_token_agreement"] = sum(agree) / len(agree)
    add_profile(torch, engine, out, seed=11)
    results["a_phase4_traffic"] = out
    log("  (a) " + json.dumps(out))
    del engine
    torch.cuda.empty_cache()

    # (b) equal device memory with 6(c): a bf16 position of one KV head
    # takes 2 x hd bytes in each of K and V, an int8 one hd + 4 (its scale)
    n_blocks = pressure["n_blocks"] * 2 * cfg.hd // (cfg.hd + 4)
    engine = ServingEngine(cfg, params, n_blocks=n_blocks, **base)
    torch.cuda.reset_peak_memory_stats()
    reqs, wall, decode_only, launches = drive(torch, engine, [prompts],
                                              SERVE_GEN)
    out = serve_numbers(torch, engine, reqs, wall, decode_only, launches)
    out["n_blocks"] = n_blocks
    bf16_bytes = pressure["pool"]["arena_bytes"]
    check(out["pool"]["arena_bytes"] <= bf16_bytes,
          f"equal memory: int8 arena {out['pool']['arena_bytes']} bytes > "
          f"6(c)'s bf16 arena {bf16_bytes}")
    out["vs_6c"] = {"arena_bytes": [out["pool"]["arena_bytes"], bf16_bytes],
                    "n_blocks": [n_blocks, pressure["n_blocks"]],
                    "max_running": [out["max_running"],
                                    pressure["max_running"]],
                    "n_preemptions": [out["n_preemptions"],
                                      pressure["n_preemptions"]]}
    results["b_equal_memory_6c"] = out
    log("  (b) " + json.dumps(out))
    del engine
    torch.cuda.empty_cache()
    return results, launches_a


# ------------------------------------------- phase 13: the dense family
class plain_versions:
    """Within the block, the serving path's kernel wrappers are their plain
    versions, on the card: ``sparse_serving``'s fused and N:M products and
    ``paged_attention``."""

    def __enter__(self):
        from repro_torch.kernels import fused_sparse_linear as fsl
        from repro_torch.kernels import nm_spmm as nms
        from repro_torch.models import sparse_serving as ss
        from repro_torch.serving.paged import paged_attention as pa
        self.saved = (ss.fused_sparse_linear, ss.nm_spmm, pa.paged_attention)
        ss.fused_sparse_linear, ss.nm_spmm = fsl.plain, nms.plain
        pa.paged_attention = pa.plain
        return self

    def __exit__(self, *exc):
        from repro_torch.models import sparse_serving as ss
        from repro_torch.serving.paged import paged_attention as pa
        ss.fused_sparse_linear, ss.nm_spmm, pa.paged_attention = self.saved
        return False


class nudged_embedding:
    """Within the block, ``params["embed"]`` is a copy with the first
    element of ``token``'s row moved to the next bf16 value (one ulp): the
    conditioning control of an ill-conditioned model."""

    def __init__(self, torch, params, token: int):
        self.torch, self.params, self.token = torch, params, token

    def __enter__(self):
        self.saved = self.params["embed"]
        moved = self.saved.clone()
        moved.view(self.torch.int16)[self.token, 0] += 1
        self.params["embed"] = moved
        return self

    def __exit__(self, *exc):
        self.params["embed"] = self.saved
        return False


class in_context_checks:
    """Within the block, every launch of the serving path's kernels (the
    fused and N:M products, ``paged_attention``) is also computed by its
    plain version on the same inputs and held at one bf16 ulp of the
    largest plain output (``KERNEL_TOL_REL``, as phases 2 and 2b hold
    them); the kernel's output goes on.  ``cases`` lists each launch's
    (kernel, input shape, max error, tolerance)."""

    def __init__(self, torch):
        self.torch, self.cases = torch, []

    def _checked(self, name, kernel, plain):
        def call(*args, **kw):
            out = kernel(*args, **kw)
            ref = plain(*args, **kw)
            err = float((out.float() - ref.float()).abs().max())
            tol = KERNEL_TOL_REL * float(ref.float().abs().max())
            self.cases.append((name, tuple(args[0].shape), err, tol))
            check(bool(self.torch.isfinite(out).all()) and err <= tol,
                  f"{name} on a {tuple(args[0].shape)} input of the chunk "
                  f"call: max|kernel-plain| {err:.3e} > tol {tol:.3e}")
            return out
        return call

    def __enter__(self):
        from repro_torch.kernels import fused_sparse_linear as fsl
        from repro_torch.kernels import nm_spmm as nms
        from repro_torch.models import sparse_serving as ss
        from repro_torch.serving.paged import paged_attention as pa
        self.saved = (ss.fused_sparse_linear, ss.nm_spmm, pa.paged_attention)
        ss.fused_sparse_linear = self._checked(
            "fused_sparse_linear", fsl.fused_sparse_linear, fsl.plain)
        ss.nm_spmm = self._checked("nm_spmm", nms.nm_spmm, nms.plain)
        pa.paged_attention = self._checked("paged_attention",
                                           pa.paged_attention, pa.plain)
        return self

    def __exit__(self, *exc):
        from repro_torch.models import sparse_serving as ss
        from repro_torch.serving.paged import paged_attention as pa
        ss.fused_sparse_linear, ss.nm_spmm, pa.paged_attention = self.saved
        return False


def first_layers(params) -> list:
    """The layer dicts holding one of each of a model's compressed
    projection shapes: layer 0 (with a moe layer's ``moe`` dict), a hybrid's
    first mamba layer and shared block, an enc-dec model's first encoder
    and decoder layers."""
    if "layers" in params:
        lp = params["layers"][0]
        return [lp] + ([lp["moe"]] if "moe" in lp else [])
    if "enc" in params:
        return [params["enc"][0], params["dec"][0]]
    return [params["mamba"][0], params["shared_attn"]]


def family_weight_gate(torch, log, cfg, params, ms=FAMILY_MS):
    """The first layers' projections (``first_layers``) whose (out, in)
    shape phase 2 does not run, each through ``weight_case`` at ``ms``
    rows: the fused kernel's decode and prefill bodies at the model's
    in-dims (``nm_spmm``'s for a projection without outliers), gated at one
    bf16 ulp against the plain version."""
    from repro_torch.kernels import fused_sparse_linear as fsl
    from repro_torch.kernels import nm_spmm as nms
    from repro_torch.models.sparse_serving import SparseWeight

    seen = {(n, k) for _, n, k in PROJECTIONS}
    timer = Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(6)
    cases = []
    for name, sw in [kv for lp in first_layers(params) for kv in lp.items()]:
        if not isinstance(sw, SparseWeight):
            continue
        shape = (sw.nm_values.shape[0], sw.in_dim)
        if shape in seen:
            continue
        seen.add(shape)
        for M in ms:
            x = torch.randn((M, sw.in_dim), generator=g, device="cuda").to(
                torch.bfloat16)
            kernel = (("fused_sparse_linear", fsl.fused_sparse_linear,
                       fsl.plain) if sw.o_values is not None else
                      ("nm_spmm", nms.nm_spmm, nms.plain))
            cases.append(weight_case(timer, log, kernel[0],
                                     f"{cfg.name}/{name}", x, sw,
                                     *kernel[1:]))
    del timer
    torch.cuda.empty_cache()
    return cases


def plain_call_gate(torch, log, cfg, params, prompt, kv_dtype):
    """One 512-token chunk call (the longest prompt's first tokens, or all
    of a shorter one, at cursor 0 of a fresh paged arena; a hybrid model's
    mamba layers on fresh state) through the kernels and through their
    plain versions on the card, and no kernel launched by the plain call.

    A dense model's logits must lie within ``MODEL_TOL_REL`` of their
    scale, as phase 3 holds them.  Zamba2 at the reference's random init is
    ill-conditioned: one bf16 ulp on one embedding element moves its logits
    by a sizeable part of their scale (54 Mamba2 blocks whose output is
    cubic in their input), so two computations that round differently
    cannot agree end to end.  Its gate holds every kernel launch of the
    call against its plain version on the same inputs instead
    (``in_context_checks``), and reports the logits' difference beside
    that of the plain call with one embedding element moved by one ulp
    (``conditioning_err``).  A moe model is gated the same way: where a
    token's k-th and (k+1)-th router probabilities nearly tie, one bf16
    rounding upstream picks another expert and replaces that token's FFN
    output wholesale, so the two calls part by much of the logits' scale
    at those tokens; ``routing_flips`` counts the (layer, token) choices
    the kernel call and the plain call make differently."""
    import numpy as np
    from repro_torch.launch.step_cost import attention_layers
    from repro_torch.models import transformer as tfm
    from repro_torch.models import zamba as zam
    from repro_torch.serving.cache_pool import kv_arenas
    from repro_torch.serving.paged import PagedPoolView
    from repro_torch.serving.state_pool import (HybridPoolView,
                                                RecurrentStateView)

    S, bs = min(len(prompt), PREFILL_PROFILE_TOKENS), ATTN_SHAPE["bs"]
    nblk = -(-S // bs)
    tokens = torch.tensor([prompt[:S]], device="cuda")
    tables = np.arange(1, nblk + 1)[None]                # block 0: trash

    def call():
        k, v, ks, vs = kv_arenas(
            (attention_layers(cfg), nblk + 1, bs, cfg.n_kv_heads, cfg.hd),
            kv_dtype, cfg.dtype, "cuda")
        view = PagedPoolView.build(k, v, tables, [0], [S], S, trash=0,
                                   k_scale=ks, v_scale=vs)
        with torch.no_grad():
            if cfg.family == "hybrid":
                states = [zam.lane_init(cfg, i, 1, "cuda")
                          for i in range(cfg.n_layers)]
                sview = RecurrentStateView.build(states, None, [0], [S])
                logits, _, _ = zam.unified_step(
                    params, HybridPoolView(view, sview), {"tokens": tokens},
                    cfg)
            else:
                logits, _ = tfm.unified_step(params, view,
                                             {"tokens": tokens}, cfg)
        torch.cuda.synchronize()
        return logits.float()
    reset_launches()
    checks = None
    routes = (routed_experts(torch, decode_only=False),
              routed_experts(torch, decode_only=False))
    if cfg.family in ("hybrid", "moe"):
        with in_context_checks(torch) as checks, routes[0]:
            out = call()
    else:
        out = call()
    kernels = read_launches()
    with plain_versions(), routes[1]:
        ref = call()
    after = read_launches()
    check(after == kernels, f"{cfg.name}: the plain call launched kernels")
    scale = float(ref.abs().max())
    err = float((out - ref).abs().max())
    agree = float((out.argmax(-1) == ref.argmax(-1)).float().mean())
    check(bool(torch.isfinite(out).all()), f"{cfg.name}: non-finite logits")
    res = {"S": S, "max_abs_err": err, "scale": scale,
           "greedy_agreement": agree}
    if checks is None:
        check(err <= MODEL_TOL_REL * scale,
              f"{cfg.name} ({kv_dtype} KV): chunk call max|kernels-plain| "
              f"{err:.3e} > {MODEL_TOL_REL} x {scale:.3e}")
        res["tol_rel"] = MODEL_TOL_REL
        log(f"  {cfg.name} {kv_dtype} KV: a {S}-token chunk call, max|"
            f"kernels-plain| {err:.3e} of scale {scale:.3e}, greedy "
            f"agreement {agree:.4f}")
        return res
    # the conditioning control: the plain call again with one embedding
    # element of the first token moved by one bf16 ulp
    with nudged_embedding(torch, params, int(tokens[0, 0])), \
            plain_versions():
        nudged = call()
    by_kernel = {}
    for name, _, e, tol in checks.cases:
        k = by_kernel.setdefault(name, {"launches": 0, "worst_err_over_tol":
                                        0.0})
        k["launches"] += 1
        k["worst_err_over_tol"] = max(k["worst_err_over_tol"],
                                      e / tol if tol else 0.0)
    per_call, attn_per_call = launches_per_call(cfg)
    check(by_kernel.get("fused_sparse_linear", {}).get("launches") == per_call
          and by_kernel.get("paged_attention", {}).get("launches")
          == attn_per_call,
          f"{cfg.name}: in-context checks {by_kernel}, want {per_call} "
          f"weight and {attn_per_call} attention launches")
    res.update(in_context=by_kernel,
               conditioning_err=float((nudged - ref).abs().max()))
    if cfg.family == "moe":
        res["routing_decisions"] = sum(e.shape[0] for e in routes[0].picks)
        res["routing_flips"] = sum(
            int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
            for a, b in zip(routes[0].picks, routes[1].picks))
    log(f"  {cfg.name} {kv_dtype} KV: a {S}-token chunk call, every kernel "
        f"launch within one bf16 ulp of its plain version on the same "
        f"inputs ({json.dumps(by_kernel)}); end to end max|kernels-plain| "
        f"{err:.3e} of scale {scale:.3e} (greedy agreement {agree:.4f}), "
        f"the plain call against itself with one embedding element moved "
        f"one ulp {res['conditioning_err']:.3e}"
        + (f"; {res['routing_flips']} of {res['routing_decisions']} "
           f"(layer, token) routings differ" if "routing_flips" in res
           else ""))
    return res


def decode_in_context(torch, engine, g) -> dict:
    """One fused decode step of all lanes (each lane fed a 64-token prompt
    first) with every kernel launch held against its plain version on the
    same inputs (``in_context_checks``); returns launches and the worst
    error over tolerance by kernel."""
    from repro_torch.serving import SamplingParams, Status
    reqs = [engine.submit(torch.randint(0, engine.cfg.vocab, (64,),
                                        generator=g, device="cuda").tolist(),
                          SamplingParams(max_new_tokens=3),
                          **family_kw(torch, engine, g))
            for _ in range(engine.pool.n_slots)]
    while not all(r.status is Status.RUNNING for r in reqs):
        engine.step()
    with in_context_checks(torch) as checks:
        st = engine.step()
    check(st["prefill_tokens"] == 0 and st["decoded"] == len(reqs),
          f"the checked step was not a pure decode step: {st}")
    engine.run()
    out = {}
    for name, _, e, tol in checks.cases:
        k = out.setdefault(name, {"launches": 0, "worst_err_over_tol": 0.0})
        k["launches"] += 1
        k["worst_err_over_tol"] = max(k["worst_err_over_tol"],
                                      e / tol if tol else 0.0)
    return out


def family_serve(torch, log, cfg, params, build, label, prompts, gen, *,
                 profile=False, preempt_every=None, decode_checks=False,
                 embeds=None, **kw):
    """Serve ``prompts`` greedily through ``ServingEngine(**kw)`` (8 slots,
    token budget 512 unless ``kw`` says otherwise), launches gated per
    model call by ``serve_numbers``; with ``profile`` a decode and a
    prefill profile (``add_profile``); with ``preempt_every`` the youngest
    running request preempted every that many steps while another waits
    (``force_preemption``); with ``decode_checks`` one decode step held
    kernel by kernel in context (``decode_in_context``); ``embeds`` are an
    enc-dec model's requests' encoder features.  ``profile="decode"``
    profiles the decode step alone; on a mesh (``kw["mesh"]``) the
    collectives the serve issued are counted (``counted_collectives``)
    and the placement described.  Returns (numbers, streams,
    launches)."""
    from repro_torch.serving import ServingEngine

    engine = ServingEngine(cfg, params, **{
        "device": "cuda", "n_slots": 8, "max_len": 1024,
        "token_budget": 512, **kw})
    if preempt_every:
        force_preemption(engine, preempt_every)
    torch.cuda.reset_peak_memory_stats()
    with counted_collectives() as coll:
        reqs, wall, decode_only, launches = drive(
            torch, engine, [prompts], gen,
            None if embeds is None else [embeds])
    out = dict(build, **serve_numbers(torch, engine, reqs, wall, decode_only,
                                      launches))
    out["label"] = label
    if kw.get("mesh") is not None:
        calls = out["model_calls"] + out["encode_calls"]
        out.update(placement=engine.stats()["placement"],
                   collectives=coll.n,
                   collectives_per_model_call=coll.n / calls)
    if preempt_every:
        out["preempted_requests"] = sum(r.n_preempted > 0 for r in reqs)
        out["prompt_tokens"] = sum(len(p) for p in prompts)
        out["prefill_tokens"] = engine.n_prefill_tokens
    engine.__dict__.pop("step", None)          # the class's step again
    if profile:
        add_profile(torch, engine, out, seed=11,
                    prefill=profile != "decode")
    if decode_checks:
        out["decode_in_context"] = decode_in_context(
            torch, engine, torch.Generator(device="cuda").manual_seed(12))
    log(f"  ({label}) " + json.dumps({k: v for k, v in out.items()
                                      if k != "launches"}))
    del engine
    torch.cuda.empty_cache()
    return out, [r.tokens for r in reqs], launches


def family_phase(torch, log):
    """Phase 13: qwen3-8b, gemma-7b and nemotron-4-340b (2 layers) at full
    width, 8:16+16:256, each built from seed 0 one layer at a time, its new
    projection shapes gated (``family_weight_gate``), one chunk call held
    against the plain versions (``plain_call_gate``), then served; returns
    (results, launches summed over the serves)."""
    bs = ATTN_SHAPE["bs"]
    paged = dict(kv_layout="paged", block_size=bs)
    results, runs = {}, []
    for arch in FAMILY_ARCHS:
        n_layers = NEMOTRON_LAYERS if arch == "nemotron-4-340b" else None
        torch.cuda.reset_peak_memory_stats()
        cfg, params, build = build_model(torch, log, arch=arch,
                                         n_layers=n_layers)
        res = {"weight_cases": family_weight_gate(torch, log, cfg, params)}
        head = params["embed"].numel() * params["embed"].element_size()
        if "lm_head" in params:
            head += params["lm_head"].numel() * 2
        res["memory"] = {
            "embed_and_head_gb": head / 1e9,
            "compressed_gb": build["compressed_gb"],
            "dense_layer_gb": build["dense_gb"] / cfg.n_layers,
            "peak_build_gb": torch.cuda.max_memory_allocated() / 1e9}
        log(f"  {arch}: {cfg.n_layers} layers, d {cfg.d_model}, hd "
            f"{cfg.hd}, H {cfg.n_heads}/{cfg.n_kv_heads}; embed and head "
            f"{head / 1e9:.2f} GB, compressed layers "
            f"{build['compressed_gb']:.2f} GB, one dense layer in transit "
            f"{build['dense_gb'] / cfg.n_layers:.2f} GB, peak "
            f"{res['memory']['peak_build_gb']:.2f} GB while building")
        if arch == "nemotron-4-340b":
            prompts = prompts_for(torch, cfg, NEMOTRON_PROMPT_LENS, seed=10)
            gen = NEMOTRON_GEN
            serves = [("c_paged_bf16", dict(paged, n_slots=4, max_len=512))]
        else:
            prompts = prompts_for(torch, cfg, SERVE_PROMPT_LENS, seed=10)
            gen = SERVE_GEN
            if arch == "qwen3-8b":
                serves = [("a_paged_bf16", dict(paged)),
                          ("a_slot_bf16", {})]
            else:
                serves = [("b_paged_bf16", dict(paged, n_blocks=512)),
                          ("b_paged_int8", dict(paged, n_blocks=512,
                                                kv_dtype="int8"))]
        longest = max(prompts, key=len)
        res["plain_call"] = {
            kv: plain_call_gate(torch, log, cfg, params, longest, kv)
            for kv in sorted({kw.get("kv_dtype", "bf16")
                              for _, kw in serves})}
        streams = {}
        for label, kw in serves:
            out, streams[label], launches = family_serve(
                torch, log, cfg, params, build, label, prompts, gen, **kw)
            res[label] = out
            runs.append(launches)
        if arch == "qwen3-8b":
            # the slot and paged streams: equal, or parting at a near-tie
            res["slot_vs_paged"] = stream_gate(
                torch, "qwen3-8b slot vs paged", cfg, params, prompts,
                streams["a_slot_bf16"], streams["a_paged_bf16"])
        if arch == "gemma-7b":
            # int8 KV against bf16 KV, reported as phase 7 reports its own
            same = [a == b for a, b in zip(streams["b_paged_int8"],
                                           streams["b_paged_bf16"])]
            agree = [x == y for a, b in zip(streams["b_paged_int8"],
                                            streams["b_paged_bf16"])
                     for x, y in zip(a, b)]
            res["b_paged_int8"]["bf16_paged_streams_identical"] = \
                f"{sum(same)}/{len(same)}"
            res["b_paged_int8"]["bf16_paged_token_agreement"] = \
                sum(agree) / len(agree)
        results[arch] = res
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return results, add_launches(*runs)


# ------------------------------------- phase 14: the recurrent families
def force_preemption(engine, every: int) -> None:
    """Every ``every``-th step of ``engine`` that leaves a request queued
    and one decoding preempts the youngest running request, as the
    reference's ``test_preempt_resume_exact`` does by hand: the slot layout
    never preempts on its own, and a stateful family swaps the request's
    state out (``save_for_preempt``) and back at its re-admission
    (``on_admit``)."""
    step, count = engine.step, [0]

    def forced():
        st = step()
        count[0] += 1
        if (count[0] % every == 0 and len(engine.queue)
                and any(r.tokens for r in engine.running.values())):
            engine._preempt_one(st)
        return st
    engine.step = forced


def mesh_family_serve(torch, log, cfg, params, build, label, prompts, gen,
                      base, base_streams, mesh, embeds=None, **kw):
    """Phase 18(a): the unplaced serve ``label`` of phase 14 or 15 (its
    numbers ``base``, its streams ``base_streams``) again on the 1x1 mesh
    ``mesh``, on the same params and traffic: the streams must be
    bit-identical (the same kernels at the same shapes; a world of one's
    gathers copy) and the launches per model call are gated
    (``family_serve``).  Returns (the pair's numbers, the mesh run's
    launches)."""
    t0 = time.perf_counter()
    out, streams, launches = family_serve(
        torch, log, cfg, params, build, f"{label}_mesh_1x1", prompts, gen,
        profile="decode", embeds=embeds, mesh=mesh, **kw)
    check(out["placement"] == {"devices": 1,
                               "mesh": {"data": 1, "model": 1}},
          f"18(a) {cfg.name}: placement {out['placement']}")
    same = sum(a == b for a, b in zip(base_streams, streams))
    check(same == len(prompts),
          f"18(a) {cfg.name} on the 1x1 mesh: {same} of {len(prompts)} "
          f"streams bit-identical to the unplaced serve's")
    profs = [base.get("decode_profile"), out.get("decode_profile")]
    res = {"serve": label, "streams_identical": f"{same}/{len(prompts)}",
           "decode_step_ms_p50": [r["decode_step_ms"]["p50"]
                                  for r in (base, out)],
           "collectives": out["collectives"],
           "collectives_per_model_call": out["collectives_per_model_call"],
           "seconds": time.perf_counter() - t0, "run": out}
    if all(p is not None for p in profs):
        res.update(
            device_busy_ms_per_step=[p["device_busy_ms_per_step"]
                                     for p in profs],
            kernels_per_step=[p["kernels_per_step"] for p in profs],
            launches_per_step_by_class=[p["launches_per_step_by_class"]
                                        for p in profs],
            device_ms_per_step_by_class=[p["device_ms_per_step_by_class"]
                                         for p in profs])
    log(f"  (18a) {cfg.name} {label}: unplaced vs 1x1 mesh: decode step "
        f"{res['decode_step_ms_p50'][0]:.2f} vs "
        f"{res['decode_step_ms_p50'][1]:.2f} ms, busy "
        f"{res.get('device_busy_ms_per_step')} ms, kernels a step "
        f"{res.get('kernels_per_step')}, "
        f"{res['collectives_per_model_call']:.1f} collectives a call")
    return res, launches


def recurrent_phase(torch, log, smi, mesh=None):
    """Phase 14: xlstm-350m (ssm, 12 of 24 layers: ``RECURRENT_LAYERS``)
    and zamba2-2.7b (hybrid, 27 of 54 mamba layers and 4 shared-attention
    applications) at full width,
    8:16+16:256 by magnitude from seed 0, each served with phase 4's
    traffic; with ``mesh`` (the 1x1 serving mesh) phase 18(a)'s serves of
    each beside the unplaced one; returns (results, launches summed over
    the serves)."""
    from repro_torch.serving import ServingEngine

    results, runs = {"device": smi}, []
    bs = ATTN_SHAPE["bs"]
    for arch in RECURRENT_ARCHS:
        torch.cuda.reset_peak_memory_stats()
        cfg, params, build = build_model(torch, log, arch=arch,
                                         n_layers=RECURRENT_LAYERS.get(arch))
        res = {"weight_cases": family_weight_gate(torch, log, cfg, params),
               "peak_build_gb": torch.cuda.max_memory_allocated() / 1e9}
        prompts = prompts_for(torch, cfg, SERVE_PROMPT_LENS, seed=10)
        log(f"  {arch}: {cfg.n_layers} layers, d {cfg.d_model}, "
            f"{build['compressed_gb']:.2f} GB compressed, peak "
            f"{res['peak_build_gb']:.2f} GB while building")
        if cfg.family == "ssm":
            # (a) the slot layout, then half the slots with forced swap
            # preemptions
            out, base, launches = family_serve(
                torch, log, cfg, params, build, "a_slot", prompts,
                SERVE_GEN, profile=True, decode_checks=True)
            res["a_slot"] = out
            runs.append(launches)
            if mesh is not None:
                res["mesh_1x1"], launches = mesh_family_serve(
                    torch, log, cfg, params, build, "a_slot", prompts,
                    SERVE_GEN, out, base, mesh)
                runs.append(launches)
            out, pressed, launches = family_serve(
                torch, log, cfg, params, build, "a_slot_swap", prompts,
                SERVE_GEN, n_slots=XLSTM_PRESSURE_SLOTS,
                preempt_every=PREEMPT_EVERY)
            check(out["n_preemptions"] > 0 and out["preempted_requests"] > 0,
                  f"{arch}: no request was preempted at "
                  f"{XLSTM_PRESSURE_SLOTS} slots")
            # a swap resume prefills at most the one token its last decode
            # had not fed; a recompute would prefill its whole sequence
            check(out["prefill_tokens"] <= out["prompt_tokens"]
                  + out["n_preemptions"],
                  f"{arch}: {out['prefill_tokens']} prefill tokens for "
                  f"{out['prompt_tokens']} prompt tokens and "
                  f"{out['n_preemptions']} preemptions: a resume recomputed")
            res["a_slot_swap"] = out
            runs.append(launches)
            res["swap_vs_slot"] = stream_gate(
                torch, f"{arch} swap-preempted vs unpressured", cfg, params,
                prompts, base, pressed)
        else:
            # (b) paged (prefix caching asked for: the adapter turns it
            # off), then slot; int8 KV refused
            res["plain_call"] = plain_call_gate(
                torch, log, cfg, params, max(prompts, key=len), "bf16")
            out, paged, launches = family_serve(
                torch, log, cfg, params, build, "b_paged", prompts,
                SERVE_GEN, profile=True, decode_checks=True,
                kv_layout="paged", block_size=bs, prefix_caching=True)
            # no prefix cache in the pool: no lookup, no hit
            check("prefix_cache" not in out["pool"],
                  f"{arch}: the paged hybrid pool kept a prefix cache")
            res["b_paged"] = out
            runs.append(launches)
            if mesh is not None:
                res["mesh_1x1"], launches = mesh_family_serve(
                    torch, log, cfg, params, build, "b_paged", prompts,
                    SERVE_GEN, out, paged, mesh, kv_layout="paged",
                    block_size=bs, prefix_caching=True)
                runs.append(launches)
            out, slot, launches = family_serve(
                torch, log, cfg, params, build, "b_slot", prompts, SERVE_GEN)
            res["b_slot"] = out
            runs.append(launches)
            # ill-conditioned at random init (``plain_call_gate``): the
            # streams' divergences are measured beside the effect of one
            # ulp, not gated; the kernels are held in context instead
            res["slot_vs_paged"] = stream_gate(
                torch, f"{arch} slot vs paged", cfg, params, prompts, slot,
                paged, gated=False)
            res["slot_vs_paged_identical"] = \
                f"{sum(a == b for a, b in zip(slot, paged))}/{len(slot)}"
            try:
                ServingEngine(cfg, params, device="cuda", n_slots=8,
                              max_len=1024, kv_layout="paged",
                              kv_dtype="int8")
                refused = None
            except ValueError as e:
                refused = str(e)
            check(refused is not None and "kv_dtype" in refused,
                  f"{arch}: int8 KV was not refused ({refused})")
            res["int8_kv_refused"] = refused
        results[arch] = res
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return results, add_launches(*runs)


# ------------------------------------------- phase 15: moe and encdec
def moe_layer_gate(torch, log, cfg, p, x, label) -> dict:
    """One MoE layer (``moe.moe_apply``: the grouped bf16 path, the shared
    expert through the fused kernel) on tokens ``x`` [T, d] against the
    plain per-token computation (``tests/test_models_smoke.py``'s manual
    reference): each token's chosen experts in f32 (one expert's rows
    batched; a row's product does not depend on the other rows), weighted
    and summed, plus the shared expert through the plain versions.  The
    choices are held against the router in f64, differing only at
    near-ties (``ROUTE_TIE``); the outputs within ``MOE_TOL_REL`` of the
    largest reference output."""
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.layers import activation, linear

    k = cfg.moe.top_k
    with torch.no_grad():
        y = moe_lib.moe_apply(p, x, cfg).float()
        w, e = moe_lib.route(p, x, cfg)
        probs = torch.softmax(x.double() @ p["router"].double().T, dim=-1)
        top = torch.topk(probs, k + 1, dim=-1)
        margin = top.values[:, k - 1] - top.values[:, k]
        differ = (e.sort(-1).values
                  != top.indices[:, :k].sort(-1).values).any(-1)
        near = margin <= ROUTE_TIE
        ref = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        for ex in e.unique().tolist():
            tok, j = (e == ex).nonzero(as_tuple=True)
            xt = x[tok].float()
            wu = p["we_up"][ex].float()
            if cfg.glu:
                h = activation(cfg.act, xt @ p["we_gate"][ex].float()) \
                    * (xt @ wu)
            else:
                h = activation(cfg.act, xt @ wu)
            del wu
            ref.index_add_(0, tok, w[tok, j][:, None]
                           * (h @ p["we_down"][ex].float()))
        if cfg.moe.shared_expert:
            with plain_versions():
                hidden = activation(cfg.act, linear(p["ws_gate"], x)) \
                    * linear(p["ws_up"], x)
                ref += linear(p["ws_down"], hidden).float()
        torch.cuda.synchronize()
    scale = float(ref.abs().max())
    err = float((y - ref).abs().max())
    res = {"tokens": x.shape[0], "max_abs_err": err, "scale": scale,
           "tol_rel": MOE_TOL_REL, "experts_used": int(e.unique().numel()),
           "choices_differing_from_f64": int(differ.sum()),
           "near_ties": int(near.sum())}
    check(bool(torch.isfinite(y).all()) and not bool((differ & ~near).any()),
          f"{cfg.name} MoE layer ({label}): {int((differ & ~near).sum())} "
          f"tokens chose other experts than the f64 router away from a "
          f"near-tie")
    check(err <= MOE_TOL_REL * scale,
          f"{cfg.name} MoE layer ({label}): max|grouped-per-token| {err:.3e}"
          f" > {MOE_TOL_REL} x {scale:.3e}")
    log(f"  {cfg.name} MoE layer, {label} ({x.shape[0]} tokens): "
        f"{res['experts_used']} experts, max|grouped bf16 - per-token f32| "
        f"{err:.3e} of {scale:.3e}; {res['choices_differing_from_f64']} "
        f"choices differ from the f64 router, {res['near_ties']} near-ties")
    return res


class routed_experts:
    """Within the block, the experts every decode call of a transformer
    adapter routes to (every ``moe.route`` call with ``decode_only``
    False), a layer at a time (``moe.route`` and
    ``TransformerAdapter.step_decode`` wrapped; the chosen ids are kept on
    the card and counted after the block, so no step waits on them)."""

    def __init__(self, torch, decode_only=True):
        self.torch, self.picks, self.decode_only = torch, [], decode_only

    def __enter__(self):
        from repro_torch.models import moe as moe_lib
        from repro_torch.serving.families import TransformerAdapter
        self.saved = (moe_lib.route, TransformerAdapter.step_decode)
        route, step_decode = self.saved
        decoding = [not self.decode_only]

        def routed(p, x2, cfg):
            w, e = route(p, x2, cfg)
            if decoding[0]:
                self.picks.append(e.detach())
            return w, e

        def decode(adapter, *args, **kw):
            decoding[0] = True
            try:
                return step_decode(adapter, *args, **kw)
            finally:
                decoding[0] = False
        moe_lib.route = routed
        if self.decode_only:
            TransformerAdapter.step_decode = decode
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe as moe_lib
        from repro_torch.serving.families import TransformerAdapter
        moe_lib.route, TransformerAdapter.step_decode = self.saved
        return False

    def summary(self) -> dict:
        n = [int(self.torch.unique(e).numel()) for e in self.picks]
        return {"layer_calls": len(n),
                "rows": int(self.picks[0].shape[0]) if self.picks else 0,
                "distinct_min": min(n, default=0),
                "distinct_mean": sum(n) / len(n) if n else 0.0,
                "distinct_max": max(n, default=0)}


def expert_bytes(params) -> int:
    """Bytes of a moe model's routed experts (dense bf16)."""
    return sum(lp["moe"][n].numel() * lp["moe"][n].element_size()
               for lp in params["layers"]
               for n in ("we_gate", "we_up", "we_down"))


def encdec_call_gate(torch, log, cfg, params, prompt, frames) -> dict:
    """One enc-dec admission and chunk, as the engine runs them: the
    encoder over ``frames`` [S_enc, d] at their true length
    (``whisper.encode_ctx``) and one chunk call of ``prompt`` at cursor 0
    of a fresh slot over that context, with every kernel launch held
    against its plain version on the same inputs (``in_context_checks``:
    192 + 192 at whisper-medium), then end to end against the same two
    calls through the plain versions at ``MODEL_TOL_REL`` of the logits'
    scale, beside the plain calls' own change when one element of the
    first token's embedding moves one bf16 ulp (``conditioning_err``)."""
    from repro_torch.models import whisper as whi
    from repro_torch.serving.state_pool import EncDecPoolView

    S = len(prompt)
    tokens = torch.tensor([prompt], device="cuda")
    shape = (cfg.n_layers, 1, S, cfg.n_kv_heads, cfg.hd)

    def call():
        with torch.no_grad():
            ck, cv = whi.encode_ctx(params, frames[None], cfg)
            k = torch.zeros(shape, dtype=cfg.dtype, device="cuda")
            view = EncDecPoolView.build(k, torch.zeros_like(k), None, [0],
                                        [S], S, ck=ck, cv=cv,
                                        ctx_len=[frames.shape[0]])
            logits, _ = whi.unified_step(params, view, {"tokens": tokens},
                                         cfg)
        torch.cuda.synchronize()
        return logits.float()
    reset_launches()
    with in_context_checks(torch) as checks:
        out = call()
    kernels = read_launches()
    with plain_versions():
        ref = call()
        with nudged_embedding(torch, params, prompt[0]):
            nudged = call()
    check(read_launches() == kernels,
          f"{cfg.name}: the plain call launched kernels")
    want = encode_launches(cfg) + launches_per_call(cfg)[0]
    check(len(checks.cases) == want
          and kernels["fused_sparse_linear"] == want,
          f"{cfg.name}: {len(checks.cases)} launches checked in context, "
          f"want {want}")
    scale = float(ref.abs().max())
    err = float((out - ref).abs().max())
    worst = max(e / tol if tol else 0.0 for _, _, e, tol in checks.cases)
    res = {"S": S, "frames": frames.shape[0], "max_abs_err": err,
           "scale": scale, "tol_rel": MODEL_TOL_REL,
           "conditioning_err": float((nudged - ref).abs().max()),
           "greedy_agreement": float((out.argmax(-1) == ref.argmax(-1))
                                     .float().mean()),
           "in_context": {"launches": len(checks.cases),
                          "worst_err_over_tol": worst}}
    check(bool(torch.isfinite(out).all()) and err <= MODEL_TOL_REL * scale,
          f"{cfg.name}: encoder + chunk call max|kernels-plain| {err:.3e} > "
          f"{MODEL_TOL_REL} x {scale:.3e} (one ulp moves the plain call "
          f"{res['conditioning_err']:.3e})")
    log(f"  {cfg.name}: encoder over {frames.shape[0]} frames + a {S}-token "
        f"chunk call, {len(checks.cases)} kernel launches each within "
        f"{worst:.2f} of one bf16 ulp of its plain version; end to end "
        f"max|kernels-plain| {err:.3e} of scale {scale:.3e} (greedy "
        f"agreement {res['greedy_agreement']:.4f}; one ulp on one "
        f"embedding element moves the plain call "
        f"{res['conditioning_err']:.3e})")
    return res


def moe_encdec_phase(torch, log, smi, mesh=None):
    """Phase 15: mixtral-8x7b (8 of 32 layers) and llama4-maverick-400b-
    a17b (1 of 48) at full width, whisper-medium at full size, each
    8:16+16:256 by magnitude from seed 0 built one layer at a time (the
    routed experts stay dense, drawn an expert at a time); new projection
    shapes through phase 2's gate; the MoE layer against its per-token
    computation; whisper's encoder and a chunk call in context and end to
    end; then served, launches gated per model call; with ``mesh`` (the
    1x1 serving mesh) phase 18(a)'s serves of mixtral's paged and
    whisper's slot serve beside the unplaced ones; returns (results,
    launches summed over the serves)."""
    bs = ATTN_SHAPE["bs"]
    paged = dict(kv_layout="paged", block_size=bs)
    results, runs = {"device": smi}, []
    for arch, n_layers in MOE_ARCHS:
        torch.cuda.reset_peak_memory_stats()
        cfg, params, build = build_model(torch, log, arch=arch,
                                         n_layers=n_layers)
        res = {"weight_cases": family_weight_gate(torch, log, cfg, params)}
        head = sum(params[n].numel() * params[n].element_size()
                   for n in ("embed", "lm_head"))
        res["memory"] = {"experts_gb": expert_bytes(params) / 1e9,
                         "compressed_gb": build["compressed_gb"],
                         "embed_and_head_gb": head / 1e9,
                         "peak_build_gb":
                             torch.cuda.max_memory_allocated() / 1e9}
        log(f"  {arch}: {cfg.n_layers} layers, d {cfg.d_model}, "
            f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k}"
            f"{' + shared' if cfg.moe.shared_expert else ''}; dense experts "
            f"{res['memory']['experts_gb']:.2f} GB, compressed "
            f"{build['compressed_gb']:.2f} GB, embed and head "
            f"{head / 1e9:.2f} GB, peak {res['memory']['peak_build_gb']:.2f}"
            f" GB while building")
        g = torch.Generator(device="cuda").manual_seed(13)
        lp = params["layers"][0]["moe"]
        res["moe_layer"] = {
            label: moe_layer_gate(
                torch, log, cfg, lp,
                torch.randn((n, cfg.d_model), generator=g,
                            device="cuda").to(cfg.dtype), label)
            for label, n in (("decode", MOE_DECODE_ROWS),
                             ("chunk512", PREFILL_PROFILE_TOKENS))}
        if arch == "mixtral-8x7b":
            prompts = prompts_for(torch, cfg, SERVE_PROMPT_LENS, seed=10)
            gen = SERVE_GEN
            serves = [("a_paged", dict(paged, decode_checks=True)),
                      ("a_slot", {})]
        else:
            prompts = prompts_for(torch, cfg, MAVERICK_PROMPT_LENS, seed=10)
            gen = MAVERICK_GEN
            serves = [("b_paged", dict(paged, n_slots=4, max_len=512))]
        res["plain_call"] = plain_call_gate(torch, log, cfg, params,
                                            max(prompts, key=len), "bf16")
        streams = {}
        for label, kw in serves:
            # the experts each decode step (the profile's included) routes
            # its lanes to, free lanes too
            with routed_experts(torch) as picks:
                out, streams[label], launches = family_serve(
                    torch, log, cfg, params, build, label, prompts, gen,
                    profile=True, **kw)
            out["decode_experts"] = picks.summary()
            log(f"  ({label}) distinct experts a decode call routes to, a "
                f"layer: {json.dumps(out['decode_experts'])}")
            res[label] = out
            runs.append(launches)
            if mesh is not None and label == "a_paged":
                res["mesh_1x1"], launches = mesh_family_serve(
                    torch, log, cfg, params, build, label, prompts, gen,
                    out, streams[label], mesh, **paged)
                runs.append(launches)
        if arch == "mixtral-8x7b":
            # ill-conditioned at random init through its routing
            # (``plain_call_gate``): the streams' divergences are measured
            # beside the effect of one ulp, not gated; the kernels are held
            # in context instead
            res["slot_vs_paged"] = stream_gate(
                torch, f"{arch} slot vs paged", cfg, params, prompts,
                streams["a_slot"], streams["a_paged"], gated=False)
            same = sum(a == b for a, b in zip(streams["a_slot"],
                                              streams["a_paged"]))
            res["slot_vs_paged_identical"] = f"{same}/{len(prompts)}"
        results[arch] = res
        del params, lp
        gc.collect()
        torch.cuda.empty_cache()

    # (c) whisper-medium: the encoder at its true length at admission,
    # decoder slots over the context rows
    torch.cuda.reset_peak_memory_stats()
    cfg, params, build = build_model(torch, log, arch="whisper-medium")
    res = {"weight_cases": family_weight_gate(torch, log, cfg, params,
                                              ms=WHISPER_MS),
           "peak_build_gb": torch.cuda.max_memory_allocated() / 1e9}
    prompts = prompts_for(torch, cfg, WHISPER_PROMPT_LENS, seed=10)
    g = torch.Generator(device="cuda").manual_seed(14)
    frames = [torch.randn((WHISPER_FRAMES, cfg.d_model), generator=g,
                          device="cuda").to(cfg.dtype) for _ in prompts]
    log(f"  whisper-medium: {cfg.enc_layers} + {cfg.n_layers} layers, d "
        f"{cfg.d_model}, {build['compressed_gb']:.2f} GB compressed, peak "
        f"{res['peak_build_gb']:.2f} GB while building")
    res["call"] = encdec_call_gate(torch, log, cfg, params,
                                   max(prompts, key=len), frames[0])
    out, base, launches = family_serve(
        torch, log, cfg, params, build, "c_slot", prompts, SERVE_GEN,
        profile=True, decode_checks=True, embeds=frames, **WHISPER_ENGINE)
    res["c_slot"] = out
    runs.append(launches)
    if mesh is not None:
        res["mesh_1x1"], launches = mesh_family_serve(
            torch, log, cfg, params, build, "c_slot", prompts, SERVE_GEN,
            out, base, mesh, embeds=frames, **WHISPER_ENGINE)
        runs.append(launches)
    out, pressed, launches = family_serve(
        torch, log, cfg, params, build, "c_slot_swap", prompts, SERVE_GEN,
        preempt_every=PREEMPT_EVERY, embeds=frames,
        **dict(WHISPER_ENGINE, n_slots=WHISPER_PRESSURE_SLOTS))
    check(out["n_preemptions"] > 0 and out["preempted_requests"] > 0,
          f"whisper-medium: no request was preempted at "
          f"{WHISPER_PRESSURE_SLOTS} slots")
    # a swap resume prefills at most the one token its last decode had not
    # fed and runs no second encoder call
    check(out["prefill_tokens"] <= out["prompt_tokens"]
          + out["n_preemptions"] and out["encode_calls"] == len(prompts),
          f"whisper-medium: {out['prefill_tokens']} prefill tokens for "
          f"{out['prompt_tokens']} prompt tokens and {out['n_preemptions']}"
          f" preemptions, {out['encode_calls']} encoder calls: a resume "
          f"recomputed")
    res["c_slot_swap"] = out
    runs.append(launches)
    res["swap_vs_slot"] = stream_gate(
        torch, "whisper-medium swap-preempted vs unpressured", cfg, params,
        prompts, base, pressed, embeds=frames)
    results["whisper-medium"] = res
    del params, frames
    gc.collect()
    torch.cuda.empty_cache()
    return results, add_launches(*runs)


# ------------------------------------------------- phase 9: trace replay
def replay_run(torch, cfg, params, trace_path, time_scale, trace_out=None):
    """One replay of the trace file through the CLI's ``run_trace`` on phase
    6(a)'s paged engine, every kernel's launch count set to 0 just before
    and read just after; returns (run_trace's result, launches)."""
    from repro_torch.launch import serve

    argv = ["--arch", "llama3-8b", "--sparse", "--slots", "8",
            "--max-len", "1024", "--token-budget", "512",
            "--kv-layout", "paged", "--block-size", str(ATTN_SHAPE["bs"]),
            "--n-blocks", "512", "--trace", str(trace_path),
            "--time-scale", str(time_scale)]
    if trace_out is not None:
        argv += ["--trace-out", str(trace_out)]
    args = serve.parse_args(argv)
    torch.cuda.synchronize()
    reset_launches()
    res = serve.run_trace(cfg, params, args, "cuda")
    torch.cuda.synchronize()
    launches = read_launches()
    gen = TRACE["max_new_tokens"]
    for r in res["finished"]:
        check(r.status.value == "finished" and len(r.tokens) == gen,
              f"replay: request {r.request_id}: {r.status}, "
              f"{len(r.tokens)} tokens")
        check(all(0 <= t < cfg.vocab for t in r.tokens),
              f"replay: request {r.request_id}: token outside the vocab")
    return res, launches


def phase_ms_per_step(tracer, n_steps):
    """Host ms per step of each engine span (step, plan, chunk, decode,
    emit, jit:*) of a traced run: the sum of the span's durations over the
    steps."""
    out = {}
    for e in tracer.buffer.events:
        if e["ph"] == "X" and e["pid"] == tracer._pid_engine:
            out[e["name"]] = out.get(e["name"], 0.0) + e["dur"] / 1e3
    return {k: v / max(n_steps, 1) for k, v in sorted(out.items())}


def step_ms(tracer):
    """p50 and count of the traced run's step spans, decode-only steps
    apart from steps that ran a prefill chunk."""
    import numpy as np
    out = {}
    for kind, want in (("decode_only", False), ("with_chunk", True)):
        durs = [e["dur"] / 1e3 for e in tracer.buffer.events
                if e["ph"] == "X" and e["name"] == "step"
                and (e["args"]["prefill_tokens"] > 0) == want]
        out[kind] = {"p50": float(np.percentile(durs, 50)) if durs else None,
                     "n": len(durs)}
    return out


def check_lifecycles(tracer, reqs):
    """Every request's request_summary restates its RequestMetrics
    (tests/test_observe.py's check)."""
    summaries = {e["args"]["id"]: e["args"] for e in tracer.buffer.events
                 if e.get("name") == "request_summary"}
    check(len(summaries) == len(reqs),
          f"trace: {len(summaries)} request summaries, {len(reqs)} requests")
    for r in reqs:
        m, s = r.metrics, summaries[r.request_id]
        got = (s["status"], s["admitted"], s["first_token"], s["finished"],
               s["n_tokens"], s["prefill_chunks"], s["n_preemptions"],
               s["last_preempt_reason"])
        want = (r.status.value, m.admitted, m.first_token, m.finished,
                m.n_tokens, m.prefill_chunks, m.n_preemptions,
                m.last_preempt_reason)
        check(got == want and m.n_tokens == len(r.tokens),
              f"trace: request {r.request_id}'s summary {got} != its "
              f"metrics {want}")


def kind_walls(attr):
    """A tracer's attribution pooled by kind (step, decode, draft_step,
    draft_decode): variants, calls, and the steady mean wall and issue ms
    of a call, first calls left out."""
    by_kind = {}
    for v in attr.values():
        k = by_kind.setdefault(v["kind"], {"variants": 0, "calls": 0,
                                           "steady_calls": 0, "wall_s": 0.0,
                                           "issue_s": 0.0})
        k["variants"] += 1
        k["calls"] += v["calls"]
        if v["steady_mean_s"] is not None:
            k["steady_calls"] += v["calls"] - 1
            k["wall_s"] += v["steady_mean_s"] * (v["calls"] - 1)
            k["issue_s"] += v["steady_issue_mean_s"] * (v["calls"] - 1)

    def ms(total, n):
        return total / n * 1e3 if n else None
    return {kind: {"variants": k["variants"], "calls": k["calls"],
                   "steady_calls": k["steady_calls"],
                   "steady_wall_ms": ms(k["wall_s"], k["steady_calls"]),
                   "steady_issue_ms": ms(k["issue_s"], k["steady_calls"])}
            for kind, k in by_kind.items()}


def trace_phase(torch, log, cfg, params):
    """Phase 9: the trace written, read back and replayed through the CLI's
    ``run_trace``, (a) untraced and traced at time scale 0, (b) the traced
    run's trace and counters gated, (c) traced at time scale 1.0."""
    from repro_torch.runtime.metrics import format_summary
    from repro_torch.runtime.telemetry import validate_trace_events
    from repro_torch.serving import load_trace, poisson_trace, save_trace

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    trace_path = out_dir / "phase9_requests.json"
    made = poisson_trace(vocab=cfg.vocab, **TRACE)
    save_trace(str(trace_path), made)
    check(load_trace(str(trace_path)) == made,
          "trace: load_trace did not return the saved requests")
    n_req, gen = TRACE["n_requests"], TRACE["max_new_tokens"]
    out = {"trace": dict(TRACE, file=str(trace_path.relative_to(ROOT)),
                         prompt_tokens=sum(len(t.prompt) for t in made))}

    # (a) untraced, then traced, at time scale 0
    runs = {}
    for name, trace_out in (("untraced", None),
                            ("traced", out_dir / "phase9_trace.json")):
        res, launches = replay_run(torch, cfg, params, trace_path, 0.0,
                                   trace_out)
        engine = res["engine"]
        check(len(res["finished"]) == n_req and res["rejected"] == 0,
              f"replay ({name}): {len(res['finished'])} finished, "
              f"{res['rejected']} rejected")
        nums = serve_numbers(torch, engine, res["finished"], res["wall_s"],
                             [], launches)
        runs[name] = (res, nums)
    (res_u, nums_u), (res_t, nums_t) = runs["untraced"], runs["traced"]
    streams_u = {r.request_id: r.tokens for r in res_u["finished"]}
    streams_t = {r.request_id: r.tokens for r in res_t["finished"]}
    check(streams_t == streams_u,
          "replay: the traced run's greedy streams differ from the "
          "untraced run's")

    # (b) the traced run's trace and counters
    engine, tracer = res_t["engine"], res_t["tracer"]
    events = validate_trace_events(json.loads(
        (out_dir / "phase9_trace.json").read_text()))
    names = {e["name"] for e in events}
    check(TRACE_SPANS <= names,
          f"trace: spans missing: {sorted(TRACE_SPANS - names)}")
    check_lifecycles(tracer, res_t["finished"])
    lb = {"engine": tracer.name, "family": cfg.family}
    reg = tracer.registry
    decoded = reg.counter("serving_tokens_decoded_total").get(**lb)
    prefilled = reg.counter("serving_tokens_prefilled_total").get(**lb)
    st = engine.stats()
    check(decoded == n_req * gen,
          f"trace: serving_tokens_decoded_total {decoded} != {n_req * gen}")
    check(prefilled == st["n_prefill_tokens"],
          f"trace: serving_tokens_prefilled_total {prefilled} != the "
          f"engine's {st['n_prefill_tokens']}")
    attr = tracer.attribution()
    calls = sum(v["calls"] for v in attr.values())
    check(calls == st["n_model_calls"],
          f"trace: attribution counts {calls} calls, the adapter "
          f"{st['n_model_calls']}")
    out["identity"] = {
        "streams_identical": f"{len(streams_u)}/{n_req}",
        "untraced": nums_u, "traced": nums_t,
        "untraced_tok_per_s": nums_u["tok_per_s"],
        "traced_tok_per_s": nums_t["tok_per_s"],
        "trace_events": len(events),
        "trace_file": "chiprun_out/phase9_trace.json",
        "counters_file": "chiprun_out/phase9_trace.json.counters.txt",
        "prefilled_tokens": prefilled, "decoded_tokens": decoded}
    log(f"  (a) streams identical {len(streams_u)}/{n_req}; tok/s untraced "
        f"{nums_u['tok_per_s']:.2f}, traced {nums_t['tok_per_s']:.2f}")
    log(f"  (b) {len(events)} events, prefilled {prefilled:g}, decoded "
        f"{decoded:g}, {calls} model calls")
    del runs, res_u, res_t, engine, tracer
    torch.cuda.empty_cache()

    # (c) traced at time scale 1.0
    res, launches = replay_run(torch, cfg, params, trace_path, 1.0,
                               out_dir / "phase9_trace_t1.json")
    engine, tracer = res["engine"], res["tracer"]
    nums = serve_numbers(torch, engine, res["finished"], res["wall_s"], [],
                         launches)
    attr = tracer.attribution()

    def ms(x):
        return None if x is None else x * 1e3
    variants = {
        k: {"kind": v["kind"], "shapes": v["shapes"], "calls": v["calls"],
            "first_call_ms": ms(v["first_call_s"]),
            "steady_wall_ms": ms(v["steady_mean_s"]),
            "steady_issue_ms": ms(v["steady_issue_mean_s"]),
            "flops": v["flops"], "bytes_accessed": v["bytes_accessed"]}
        for k, v in attr.items()}
    by_kind = kind_walls(attr)
    out["timed"] = {
        "time_scale": 1.0, "summary_line": format_summary("trace",
                                                          res["summary"]),
        "rejected": res["rejected"], "serve": nums, "by_kind": by_kind,
        "variants": variants,
        "phase_ms_per_step": phase_ms_per_step(tracer, engine.n_steps),
        "step_ms": step_ms(tracer), "steps": engine.n_steps,
        "trace_file": "chiprun_out/phase9_trace_t1.json"}
    log(f"  (c) {out['timed']['summary_line']}")

    def fmt(x):
        return "-" if x is None else f"{x:.3f}"
    for k, v in sorted(by_kind.items()):
        log(f"  (c) {k}: {v['variants']} variants, {v['calls']} calls, "
            f"steady wall {fmt(v['steady_wall_ms'])} ms, issue "
            f"{fmt(v['steady_issue_ms'])} ms")
    for k, v in variants.items():
        log(f"  (c) {k:10s} {str(v['shapes'][-1]):10s} calls {v['calls']:4d}"
            f"  steady wall {fmt(v['steady_wall_ms'])} ms  issue "
            f"{fmt(v['steady_issue_ms'])} ms  flops {v['flops']:.4g}  "
            f"bytes {v['bytes_accessed']:.4g}")
    log("  (c) host ms per step: " + json.dumps(
        out["timed"]["phase_ms_per_step"]))
    log("  (c) step spans: " + json.dumps(out["timed"]["step_ms"]))
    del res, engine, tracer
    torch.cuda.empty_cache()
    return out


# ------------------------------------------- phase 11: speculative decoding
def near_tie_bound(z, n_layers: int, roundings: int | None = None
                   ) -> float:
    """How far below the largest logit ``z`` [V] (one position of one
    forward) a token of either stream may lie when a speculative and a
    plain stream diverge there: the NEAR_TIE bound.

    The two engines compute the same bf16 function in different orders (a
    verify row goes through paged attention's prefill-chunk body and
    B x S-row products, a decode row through the decode body and B-row
    products; the prompts are chunked differently under the verify
    reserve).  Every difference is a rounding: each of the 2L + 1 bf16
    roundings on the residual path into the lm_head (one per attention
    and per MLP add, one for the final norm) moves an element by at most
    u = 2^-8 of itself, and independent roundings add in quadrature, so
    the final hidden states of two computations differ by a relative RMS
    of at most u sqrt(2 (2L + 1)), which the lm_head carries onto each
    logit in units of the logits' RMS.  The forward that judges the flip
    is a third computation.  At ``NEAR_TIE_SIGMAS`` standard deviations,
    plus one bf16 ulp of the largest logit for the logits' own rounding,
    both tokens must lie that close to the top: a flip of a near-tie
    passes, a wrong token (a draft accepted against the target) does not.
    At L = 32 that is 0.18 RMS + 1 ulp; a random token of llama3-8b's
    vocabulary lies ~4.5 RMS below the top.  ``roundings`` replaces 2L + 1
    for a stack of another shape (``residual_roundings``)."""
    zf = z.float()
    rms = float(zf.pow(2).mean().sqrt())
    top = float(zf.abs().max())
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0
    n = 2 * n_layers + 1 if roundings is None else roundings
    return NEAR_TIE_SIGMAS * BF16_U * math.sqrt(2 * n) * rms + ulp


def residual_roundings(cfg) -> int:
    """The bf16 roundings on a model's residual path into the lm_head: one
    per residual add and one for the final norm: 2L + 1 for a dense stack,
    L + 1 for xLSTM (one add a block), L + 2 x applications + 1 for Zamba2
    (a mamba block's add, the shared block's attention and MLP adds), and
    for an enc-dec model 3L + 1 in the decoder (self-attention, cross-
    attention and MLP adds) plus 2 L_enc + 1 in the encoder, whose output
    the cross-attention reads."""
    if cfg.family == "encdec":
        return 3 * cfg.n_layers + 1 + 2 * cfg.enc_layers + 1
    if cfg.family == "ssm":
        return cfg.n_layers + 1
    if cfg.family == "hybrid":
        return cfg.n_layers + 2 * (cfg.n_layers // cfg.attn_every) + 1
    return 2 * cfg.n_layers + 1


def last_logits(torch, cfg, params, tokens, embeds=None):
    """Logits [V] of the last of ``tokens`` (a list) from one computation
    of the whole sequence: the family's full-sequence ``forward`` (dense,
    moe, hybrid; an enc-dec model's encoder over ``embeds`` and decoder
    over the tokens), or for ssm one ``unified_step`` chunk from fresh
    state with the padding masked.  The recurrent families' chunkwise
    recurrence takes whole chunks, so their sequence is padded at the end
    to a multiple of 128 tokens, which the causal model's earlier positions never see; the
    mLSTM normalizer's intra-chunk sum would meet unmasked pad tokens'
    gates (exp of a large decay times 0 is NaN in f32, in the reference's
    formula too), so ssm masks them as the engine does."""
    from repro_torch.models import transformer as tfm
    from repro_torch.models import whisper as whi
    from repro_torch.models import xlstm as xls
    from repro_torch.models import zamba as zam
    from repro_torch.serving.state_pool import RecurrentStateView
    n, dev = len(tokens), params["embed"].device
    pad = 0 if cfg.family not in ("ssm", "hybrid") or n <= 64 else -n % 128
    t = torch.tensor([list(tokens) + [0] * pad], device=dev)
    with torch.no_grad():
        if cfg.family == "ssm":
            view = RecurrentStateView.build(xls.init_state(cfg, 1, dev),
                                            None, [0], [n])
            z, _ = xls.unified_step(params, view, {"tokens": t}, cfg)
        elif cfg.family == "encdec":
            z, _ = whi.decode_full(params, t, whi.encode(
                params, embeds[None], cfg), cfg)
        else:
            fwd = zam.forward if cfg.family == "hybrid" else tfm.forward
            z, _ = fwd(params, {"tokens": t}, cfg)
    return z[0, n - 1].float()


def first_divergence(a, b):
    """The first position where two token streams differ, else None."""
    for j, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return j
    return None if len(a) == len(b) else min(len(a), len(b))


def stream_gate(torch, label, cfg, params, prompts, base, spec,
                gated=True, embeds=None):
    """The stream gate: each speculative stream equals its plain stream up
    to its first divergence, and there one ``forward`` of the common prefix
    puts both tokens within ``near_tie_bound`` of the largest logit.
    Returns each request's divergence (None where the streams agree).
    With ``gated`` False (an ill-conditioned model: ``plain_call_gate``)
    the divergences are measured and returned, not gated, each with the
    measured effect of one bf16 ulp there: the largest change of those
    logits when one element of the prefix's first embedding moves one ulp
    (``nudged_embedding``).  ``embeds`` are an enc-dec model's requests'
    encoder features."""
    out = []
    for i, (p, x, y) in enumerate(zip(prompts, base, spec)):
        emb = None if embeds is None else embeds[i]
        check(len(x) == len(y), f"{label}: request {i} streams of "
              f"{len(x)} and {len(y)} tokens")
        j = first_divergence(x, y)
        if j is None:
            out.append(None)
            continue
        prefix = list(p) + list(x[:j])
        z = last_logits(torch, cfg, params, prefix, emb)
        bound = near_tie_bound(z, cfg.n_layers, residual_roundings(cfg))
        sens = None
        if not gated:
            with nudged_embedding(torch, params, prefix[0]):
                sens = float((last_logits(torch, cfg, params, prefix, emb)
                              - z).abs().max())
        top = float(z.max())
        gaps = (top - float(z[x[j]]), top - float(z[y[j]]))
        check(not gated or max(gaps) <= bound,
              f"{label}: request {i} diverges at token {j} ({x[j]} plain, "
              f"{y[j]} speculative) with logits {gaps[0]:.4f} and "
              f"{gaps[1]:.4f} below the top, over the near-tie bound "
              f"{bound:.4f}")
        out.append({"at": j, "plain_gap": gaps[0], "spec_gap": gaps[1],
                    "bound": bound, "one_ulp_sensitivity": sens})
    return out


def spec_launch_check(engine, launches, label):
    """Gate a paged serve's launches per model call, a draft model's
    included: each weight variant 7 x layers x the calls of every model
    whose projections it serves (a dense model's 0), paged attention
    layers x the target's calls (the drafter's arena is the slot layout),
    every other counter 0 (``check_launch_counts``)."""
    from repro_torch.models.sparse_serving import SparseWeight

    models = [(engine.params, engine.cfg, engine.adapter.n_model_calls)]
    if engine.spec is not None and engine.spec.drafter is not None:
        d = engine.spec.drafter
        models.append((d.adapter.params, d.cfg, d.adapter.n_model_calls))
    want = {}
    for params, cfg, calls in models:
        wq = params["layers"][0]["wq"]
        wq = getattr(wq, "local", wq)              # a mesh's RowShard
        if isinstance(wq, SparseWeight):
            key = ("fused_sparse_linear" if wq.o_values is not None
                   else "nm_spmm") + ("" if wq.v_scale is None else "_int8")
            want[key] = want.get(key, 0) + 7 * cfg.n_layers * calls
    attn = "paged_attention" + ("_int8" if engine.kv_dtype == "int8" else "")
    want[attn] = engine.cfg.n_layers * engine.adapter.n_model_calls
    check_launch_counts(launches, want, label)


class VerifyLaunches:
    """Launches of each kernel body in an engine's verify calls: the
    target adapter's chunk calls made inside ``_speculative_decode``
    (the drafter's calls go to its own adapter), with each call's
    [B, S] token shape.  Host counters only: no synchronize."""

    def __init__(self, engine):
        self.calls = []
        self._inside = False
        spec_decode = engine._speculative_decode
        step_chunk = engine.adapter.step_chunk

        def speculative_decode(stats):
            self._inside = True
            try:
                return spec_decode(stats)
            finally:
                self._inside = False

        def chunk(lanes, cur, n_new, tokens, **kw):
            if not self._inside:
                return step_chunk(lanes, cur, n_new, tokens, **kw)
            before = read_launches()
            out = step_chunk(lanes, cur, n_new, tokens, **kw)
            after = read_launches()
            self.calls.append((tuple(tokens.shape),
                               {k: after[k] - before[k] for k in after
                                if after[k] != before[k]}))
            return out
        engine._speculative_decode = speculative_decode
        engine.adapter.step_chunk = chunk

    def by_shape(self) -> dict:
        """"BxS" -> {"calls": n, launches summed by counter}."""
        out = {}
        for (B, S), delta in self.calls:
            rec = out.setdefault(f"{B}x{S}", {"calls": 0})
            rec["calls"] += 1
            for k, n in delta.items():
                rec[k] = rec.get(k, 0) + n
        return out


def spec_serve(torch, cfg, params, prompts, label, draft=None):
    """Serve ``prompts`` greedily on a traced paged engine (phase 6(a)'s
    geometry), speculating when ``draft`` is given; gates the launches per
    model call.  Returns (streams, numbers, launches)."""
    from repro_torch.serving import ServingEngine, ServingTracer

    tracer = ServingTracer()
    engine = ServingEngine(cfg, params, device="cuda", n_slots=8,
                           max_len=1024, token_budget=512, kv_layout="paged",
                           block_size=ATTN_SHAPE["bs"], n_blocks=512,
                           tracer=tracer, draft=draft)
    verify = VerifyLaunches(engine) if draft is not None else None
    reqs, wall, decode_only, launches = drive(torch, engine, [prompts],
                                              SERVE_GEN)
    spec_launch_check(engine, launches, label)
    st = engine.stats()
    n_tok = sum(len(r.tokens) for r in reqs)
    out = {"requests": len(reqs), "tokens": n_tok, "wall_s": wall,
           "tok_per_s": n_tok / wall, "steps": st["n_steps"],
           "model_calls": st["n_model_calls"],
           "by_kind": kind_walls(tracer.attribution()),
           "launches": {k: n for k, n in launches.items() if n},
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    if draft is not None:
        out["speculative"] = st["speculative"]
        out["draft_k"] = [r.draft_k for r in reqs]
        out["verify_launches"] = verify.by_shape()
        if engine.spec.drafter is not None:
            out["draft_model_calls"] = \
                engine.spec.drafter.adapter.n_model_calls
    del engine, tracer
    torch.cuda.empty_cache()
    return [r.tokens for r in reqs], out, launches


def add_launches(*runs) -> dict:
    return {k: sum(r[k] for r in runs) for k in runs[0]}


def spec_phase(torch, log, cfg, params):
    """Phase 11: (a) phase 4's 8:16+16:256 params draft for their own
    densification, (b) n-gram self-drafting on phase 4's compressed
    target, (c) the CLI's --draft sparse on a 4-layer dense target; each
    speculative serve against the same target served plain in this run.
    Returns (numbers, the launches of every phase-11 serve summed)."""
    from repro_torch.models.sparse_serving import densify_params
    from repro_torch.serving import SpeculativeConfig

    out, runs = {}, []
    spec = dict(k=SPEC_K, max_k=SPEC_MAX_K)

    def pair(label, target, prompts, draft):
        base, nums_b, l_b = spec_serve(torch, cfg, target, prompts,
                                       f"{label} plain")
        specd, nums_s, l_s = spec_serve(torch, cfg, target, prompts,
                                        f"{label} speculative", draft)
        runs.extend((l_b, l_s))
        gate = stream_gate(torch, label, cfg, target, prompts, base, specd)
        res = {"plain": nums_b, "speculative": nums_s, "divergences": gate,
               "streams_identical": sum(g is None for g in gate),
               "tok_per_s_ratio": nums_s["tok_per_s"] / nums_b["tok_per_s"],
               "steps_ratio": nums_s["steps"] / nums_b["steps"]}
        sp = nums_s["speculative"]
        log(f"  ({label}) acceptance {sp['acceptance_rate']:.4f}, "
            f"{sp['accepted_per_step']:.3f} accepted a step over "
            f"{sp['n_spec_steps']} steps; tok/s {nums_s['tok_per_s']:.2f} "
            f"against {nums_b['tok_per_s']:.2f} plain; steps "
            f"{nums_s['steps']} against {nums_b['steps']}; streams "
            f"identical {res['streams_identical']}/{len(prompts)}")
        for k, v in sorted(nums_s["by_kind"].items()):
            log(f"  ({label}) {k}: {v['calls']} calls, steady wall "
                f"{v['steady_wall_ms']} ms")
        log(f"  ({label}) verify launches by [B x S]: "
            + json.dumps(nums_s["verify_launches"]))
        return res

    # (a) the paper's pair: the compressed model drafts for its dense twin
    prompts = prompts_for(torch, cfg, SERVE_PROMPT_LENS, seed=10)
    target = densify_params(params)
    torch.cuda.reset_peak_memory_stats()
    res = pair("a", target, prompts, SpeculativeConfig(
        method="model", params=params, cfg=cfg, **spec))
    sp, nums = res["speculative"]["speculative"], res["speculative"]
    check(sp["acceptance_rate"] >= SPEC_ACCEPT_MIN,
          f"(a) acceptance {sp['acceptance_rate']:.4f} < {SPEC_ACCEPT_MIN}")
    check(sp["accepted_per_step"] > 1.0,
          f"(a) {sp['accepted_per_step']:.3f} accepted tokens a step")
    check(nums["launches"].get("fused_sparse_linear", 0)
          == 7 * cfg.n_layers * nums["draft_model_calls"],
          "(a) the fused kernel's launches are not the draft calls'")
    verify_pre = sum(v.get("paged_attention_prefill", 0)
                     for v in nums["verify_launches"].values())
    check(verify_pre > 0, "(a) no verify call reached paged attention's "
          "prefill-chunk body")
    out["a_paper_pair"] = res
    del target
    torch.cuda.empty_cache()

    # (b) n-gram self-drafting on the compressed target: prompts repeat a
    # random segment, so the proposer finds matches
    g = torch.Generator(device="cuda").manual_seed(15)
    prompts = [torch.randint(0, cfg.vocab, (NGRAM_SEGMENT,), generator=g,
                             device="cuda").tolist() * NGRAM_REPEATS
               for _ in SERVE_PROMPT_LENS]
    res = pair("b", params, prompts,
               SpeculativeConfig(method="ngram", **spec))
    sp, nums = res["speculative"]["speculative"], res["speculative"]
    check(sp["drafted"] > 0, "(b) the n-gram proposer drafted nothing")
    m64 = [v for shape, v in nums["verify_launches"].items()
           if shape == "8x8"]
    check(m64 and m64[0].get("fused_sparse_linear_prefill", 0)
          == 7 * cfg.n_layers * m64[0]["calls"],
          "(b) verify calls at M = 64 did not launch the fused kernel's "
          "prefill body 7 x layers times each")
    out["b_ngram"] = res

    # (c) the CLI: a dense 4-layer target and its own magnitude-compressed
    # draft (--draft sparse), through run_engine on the paged layout
    out["c_cli"], launches = spec_cli(torch, log, cfg, "(c)")
    runs.append(launches)
    return out, add_launches(*runs)


def spec_cli(torch, log, cfg, label, mesh=None):
    """Phase 11(c)'s serve: ``serve --draft sparse`` on a
    ``SPEC_CLI["n_layers"]``-layer dense target and its own magnitude
    compression, through ``run_engine`` on the paged layout; with ``mesh``
    (the 1x1 serving mesh) ``--mesh 1x1`` (phase 19(a)).  Every launch
    count is set to 0 just before and read just after; each engine step's
    wall is timed to a synchronize, and the collectives each model call
    issues are counted by kind (the drafter's ``draft_step`` and
    ``draft_decode``, the target's ``step``: its prefill chunks and verify
    calls).  Returns (numbers with the streams, launches)."""
    from repro_torch.launch import serve
    from repro_torch.serving import ServingEngine, Status
    from repro_torch.serving.families import TransformerAdapter

    cfg_c = dataclasses.replace(cfg, n_layers=SPEC_CLI["n_layers"])
    argv = ["--arch", "llama3-8b", "--batch", str(SPEC_CLI["batch"]),
            "--prompt-len", str(SPEC_CLI["prompt_len"]),
            "--gen", str(SPEC_CLI["gen"]), "--slots", "8",
            "--token-budget", "512", "--kv-layout", "paged",
            "--block-size", str(ATTN_SHAPE["bs"]), "--draft", "sparse",
            "--spec-k", str(SPEC_K)]
    args = serve.parse_args(argv + (["--mesh", "1x1"] if mesh else []))
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    dense, _ = serve.build_params(cfg_c, args, "cuda", g)
    steps, per_call = [], {}
    saved = (ServingEngine.step, TransformerAdapter.step_chunk,
             TransformerAdapter.step_decode)

    def timed_step(engine):
        s0 = time.perf_counter()
        st = saved[0](engine)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - s0, st))
        return st

    def by_kind(fn, kind):
        def call(adapter, *a, **kw):
            n0 = coll.n
            res = fn(adapter, *a, **kw)
            per_call.setdefault(adapter.trace_kind_prefix + kind,
                                set()).add(coll.n - n0)
            return res
        return call
    ServingEngine.step = timed_step
    TransformerAdapter.step_chunk = by_kind(saved[1], "step")
    TransformerAdapter.step_decode = by_kind(saved[2], "decode")
    try:
        with counted_collectives() as coll:
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            reqs, engine = serve.run_engine(cfg_c, dense, args, "cuda", g,
                                            mesh=mesh)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_launches()
    finally:
        (ServingEngine.step, TransformerAdapter.step_chunk,
         TransformerAdapter.step_decode) = saved
    for r in reqs:
        check(r.status is Status.FINISHED and len(r.tokens) == args.gen,
              f"{label} request {r.request_id}: {r.status}, "
              f"{len(r.tokens)} tokens")
    spec_launch_check(engine, launches, label)
    st = engine.stats()
    decode = sorted(w for w, s in steps
                    if s["prefill_tokens"] == 0 and s["decoded"] > 0)
    check(len(decode) > 0, f"{label}: no decode-only step")
    out = {"argv": " ".join(argv[argv.index("--kv-layout"):]
                            + (["--mesh", "1x1"] if mesh else []))
           + f", {cfg_c.n_layers} layers",
           "requests": len(reqs), "wall_s": wall,
           "speculative": st["speculative"], "steps": st["n_steps"],
           "model_calls": st["n_model_calls"],
           "draft_model_calls": engine.spec.drafter.adapter.n_model_calls,
           "placement": st["placement"],
           "decode_step_ms_p50": 1e3 * decode[len(decode) // 2],
           "decode_steps": len(decode),
           "collectives": coll.n,
           "collectives_per_call": {k: sorted(v)
                                    for k, v in sorted(per_call.items())},
           "launches": {k: n for k, n in launches.items() if n}}
    log(f"  {label} {json.dumps(out)}")
    out["streams"] = [r.tokens for r in reqs]
    del engine, dense
    torch.cuda.empty_cache()
    return out, launches


# ------------------------------------------------------ phase 12: the fleet
class ReplicaLaunches:
    """Launches of every kernel counter inside each replica's model calls
    (its adapter's chunk and decode calls), so a fleet's launches are gated
    per replica.  Host counters only: no synchronize."""

    def __init__(self, fleet):
        self.fleet = fleet
        self.by_replica = [dict.fromkeys(read_launches(), 0)
                           for _ in fleet.replicas]
        self.calls0 = [0] * len(fleet.replicas)
        for i, e in enumerate(fleet.replicas):
            for name in ("step_chunk", "step_decode"):
                setattr(e.adapter, name,
                        self._counted(getattr(e.adapter, name), i))

    def _counted(self, fn, i):
        def call(*args, **kw):
            before = read_launches()
            out = fn(*args, **kw)
            after = read_launches()
            for k, n in after.items():
                self.by_replica[i][k] += n - before[k]
            return out
        return call

    def reset(self):
        """Zero the per-replica counts and mark each replica's model calls
        so far; with ``reset_launches`` just before a run."""
        for d in self.by_replica:
            for k in d:
                d[k] = 0
        self.calls0 = [e.adapter.n_model_calls for e in self.fleet.replicas]

    def check(self, cfg, label) -> list:
        """Each replica's launches per its model calls since ``reset``, as
        ``serve_numbers`` gates one engine; returns the calls."""
        calls = []
        for i, e in enumerate(self.fleet.replicas):
            n = e.adapter.n_model_calls - self.calls0[i]
            check_launch_counts(self.by_replica[i], {
                "fused_sparse_linear": 7 * cfg.n_layers * n,
                "paged_attention": cfg.n_layers * n}, f"{label} r{i}")
            calls.append(n)
        return calls


def param_ptrs(params) -> list:
    """The data pointers of every tensor of a params tree, SparseWeight
    buffers included, in the tree's order."""
    from repro_torch.tree import flatten
    return [t.data_ptr() for leaf in flatten(params)
            for t in (leaf.buffers() if hasattr(leaf, "buffers") else [leaf])]


def fleet_kwargs(blocks):
    return dict(device="cuda", n_slots=FLEET_SLOTS, max_len=FLEET_MAX_LEN,
                token_budget=512, kv_layout="paged",
                block_size=ATTN_SHAPE["bs"], n_blocks=blocks)


def fleet_replay(torch, cfg, fleet, counted, trace, label):
    """One replay of ``trace`` at time scale 0 through ``fleet``, every
    launch count set to 0 just before and read just after; gates every
    request finished, none rejected, and the launches per model call of
    each replica.  Returns (replay's result, launches, model calls by
    replica)."""
    from repro_torch.serving import Status, replay

    torch.cuda.synchronize()
    reset_launches()
    counted.reset()
    res = replay(fleet, trace, time_scale=0.0)
    torch.cuda.synchronize()
    launches = read_launches()
    done = res["finished"]
    check(len(done) == len(trace) and res["rejected"] == 0,
          f"{label}: {len(done)} of {len(trace)} finished, "
          f"{res['rejected']} rejected")
    for r in done:
        check(r.status is Status.FINISHED
              and len(r.tokens) == r.sampling.max_new_tokens,
              f"{label}: request {r.request_id}: {r.status}, "
              f"{len(r.tokens)} tokens")
        check(all(0 <= t < cfg.vocab for t in r.tokens),
              f"{label}: request {r.request_id}: token outside the vocab")
        check(all(math.isfinite(lp) for lp in r.logprobs),
              f"{label}: request {r.request_id}: non-finite logprob")
    calls = counted.check(cfg, label)
    check_launch_counts(launches, {
        "fused_sparse_linear": 7 * cfg.n_layers * sum(calls),
        "paged_attention": cfg.n_layers * sum(calls)}, label)
    return res, launches, calls


def fleet_numbers(fleet, res, prompt_tokens, calls) -> dict:
    """The numbers of a fleet run: tok/s over the wall and over
    ``critical_path_s``, busy time per replica, prefix hits over prompt
    tokens, moves, TTFT, model calls by replica."""
    from repro_torch.runtime.metrics import summarize
    st = fleet.stats()
    s = summarize([r.metrics for r in res["finished"]], res["wall_s"])
    crit = st["critical_path_s"]
    return {"requests": s["n_requests"], "tokens": s["total_tokens"],
            "wall_s": res["wall_s"], "tok_per_s": s["tok_per_s"],
            "critical_path_s": crit,
            "tok_per_s_critical_path": s["total_tokens"] / crit,
            "busy_s": st["busy_s"], "router_busy_s": st["router_busy_s"],
            "hit_tokens": st["prefix_cache"]["hit_tokens"],
            "prefix_hit_rate": st["prefix_cache"]["hit_tokens"]
            / prompt_tokens,
            "n_steals": st["n_steals"], "n_drains": st["n_drains"],
            "ttft_ms": {k: s["ttft"][k] * 1e3 for k in ("p50", "p99")},
            "steps": st["n_steps"], "model_calls": calls,
            "finished_by_replica": [p["n_finished"] for p in st["replicas"]],
            "preemptions": [p["n_preemptions"] for p in st["replicas"]],
            "router": st["router"]}


def fleet_phase(torch, log, cfg, params):
    """Phase 12: the fleet trace replayed at time scale 0 through (a) a
    1-replica set with the fleet's KV, (b) round-robin and (c) prefix
    routing over 2 replicas, (d) prefix routing stealing at threshold 1,
    each once from cold (their warm replays were cut for the script's
    wall), (e) the CLI's ``run_trace --replicas 2 --routing prefix``
    traced.
    Returns (numbers, the launches of every phase-12 run summed)."""
    from repro_torch.launch import serve
    from repro_torch.runtime.metrics import format_summary
    from repro_torch.runtime.telemetry import validate_trace_events
    from repro_torch.serving import (ReplicaSet, fleet_trace, load_trace,
                                     save_trace)

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    trace_path = out_dir / "phase12_requests.json"
    made = fleet_trace(vocab=cfg.vocab, **FLEET_TRACE)
    save_trace(str(trace_path), made)
    trace = load_trace(str(trace_path))
    check(trace == made, "fleet: load_trace did not return the saved "
          "requests")
    n_req = len(trace)
    ordered = sorted(trace, key=lambda t: t.arrival_s)   # = request ids
    prompt_tokens = sum(len(t.prompt) for t in trace)
    R, NB = FLEET_REPLICAS, FLEET_BLOCKS
    ptrs = param_ptrs(params)
    out = {"trace": dict(FLEET_TRACE, file=str(trace_path.relative_to(ROOT)),
                         prompt_tokens=prompt_tokens,
                         gen_tokens=sum(t.max_new_tokens for t in trace)),
           "replicas": R, "blocks_per_replica": NB,
           "slots_per_replica": FLEET_SLOTS, "max_len": FLEET_MAX_LEN}
    runs, cold = [], {}

    def build(n_replicas, routing, blocks, steal_threshold=4):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        fleet = ReplicaSet(cfg, params, n_replicas=n_replicas,
                           routing=routing, steal_threshold=steal_threshold,
                           **fleet_kwargs(blocks))
        torch.cuda.synchronize()
        added = torch.cuda.memory_allocated() - before
        arena = sum(e.pool.stats()["arena_bytes"]
                    + e.pool.stats()["scale_bytes"] for e in fleet.replicas)
        check(added <= 1.05 * arena,
              f"fleet of {n_replicas}: building it added {added} bytes, "
              f"over its pools' {arena} + 5%")
        for i, e in enumerate(fleet.replicas):
            check(e.params is params and param_ptrs(e.adapter.params) == ptrs,
                  f"fleet: replica {i} does not hold phase 4's parameter "
                  f"tensors")
        return fleet, {"added_bytes": added, "arena_bytes": arena}

    def measured(name, n_replicas, routing, blocks, steal_threshold=4):
        fleet, mem = build(n_replicas, routing, blocks, steal_threshold)
        counted = ReplicaLaunches(fleet)
        res, launches, calls = fleet_replay(torch, cfg, fleet, counted,
                                            trace, f"({name}) cold")
        runs.append(launches)
        cold[name] = [res["finished"][i].tokens for i in range(n_req)]
        nums = {"cold": fleet_numbers(fleet, res, prompt_tokens, calls),
                "memory": mem,
                "launches": {k: n for k, n in launches.items() if n}}
        rep = nums["cold"]
        log(f"  ({name}) {rep['tok_per_s']:.2f} tok/s over the wall, "
            f"{rep['tok_per_s_critical_path']:.2f} over the critical path; "
            f"busy {[round(b, 3) for b in rep['busy_s']]} s; prefix hits "
            f"{rep['prefix_hit_rate']:.4f} of prompt tokens; steals "
            f"{rep['n_steals']}, drains {rep['n_drains']}; TTFT p50/p99 "
            f"{rep['ttft_ms']['p50']:.0f}/{rep['ttft_ms']['p99']:.0f} ms; "
            f"finished by replica {rep['finished_by_replica']}")
        del fleet, counted
        torch.cuda.empty_cache()
        return nums

    # (a) the equal-KV baseline, (b) round-robin, (c) prefix routing
    out["a_single"] = measured("a", 1, "round_robin", R * NB)
    for key, name, routing in (("b_round_robin", "b", "round_robin"),
                               ("c_prefix", "c", "prefix")):
        nums = measured(name, R, routing, NB)
        check(all(n > 0 for n in nums["cold"]["finished_by_replica"]),
              f"({name}) a replica finished nothing: "
              f"{nums['cold']['finished_by_replica']}")
        out[key] = nums
    # (d) prefix routing with work-stealing at threshold 1
    nums = measured("d", R, "prefix", NB, steal_threshold=1)
    check(nums["cold"]["n_steals"] > 0, "(d) no work was stolen")
    out["d_prefix_steal"] = nums

    # each cold stream of (b)-(d) against (a)'s: equal up to the first
    # divergence, a near-tie there
    prompts = [t.prompt for t in ordered]
    for key, name in (("b_round_robin", "b"), ("c_prefix", "c"),
                      ("d_prefix_steal", "d")):
        gate = stream_gate(torch, f"({name}) vs (a)", cfg, params, prompts,
                           cold["a"], cold[name])
        out[key]["divergences"] = [dict(g, request=i) for i, g in
                                   enumerate(gate) if g is not None]
        out[key]["streams_identical"] = sum(g is None for g in gate)
        log(f"  ({name}) cold streams equal to (a)'s: "
            f"{out[key]['streams_identical']}/{n_req}; divergences "
            + json.dumps([(d["request"], d["at"], round(max(
                d["plain_gap"], d["spec_gap"]), 4), round(d["bound"], 4))
                for d in out[key]["divergences"]]))

    # (e) the CLI, traced
    trace_out = out_dir / "phase12_trace.json"
    args = serve.parse_args([
        "--arch", "llama3-8b", "--sparse", "--replicas", str(R),
        "--routing", "prefix", "--slots", str(FLEET_SLOTS),
        "--max-len", str(FLEET_MAX_LEN), "--token-budget", "512",
        "--kv-layout", "paged", "--block-size", str(ATTN_SHAPE["bs"]),
        "--n-blocks", str(NB), "--trace", str(trace_path),
        "--time-scale", "0", "--trace-out", str(trace_out)])
    torch.cuda.synchronize()
    reset_launches()
    res = serve.run_trace(cfg, params, args, "cuda")
    torch.cuda.synchronize()
    launches = read_launches()
    runs.append(launches)
    fleet = res["engine"]
    check(isinstance(fleet, ReplicaSet) and len(fleet.replicas) == R,
          "(e) run_trace did not build a fleet")
    check(len(res["finished"]) == n_req and res["rejected"] == 0,
          f"(e) {len(res['finished'])} finished, {res['rejected']} rejected")
    calls = [e.adapter.n_model_calls for e in fleet.replicas]
    check_launch_counts(launches, {
        "fused_sparse_linear": 7 * cfg.n_layers * sum(calls),
        "paged_attention": cfg.n_layers * sum(calls)}, "(e)")
    events = validate_trace_events(json.loads(trace_out.read_text()))
    routes = [e for e in events if e["name"] == "route"]
    check(len(routes) == n_req and {e["args"]["request"] for e in routes}
          == set(range(n_req)), f"(e) {len(routes)} route instants")
    procs = {e["args"]["name"] for e in events
             if e["name"] == "process_name"}
    want = {"fleet router"} | {f"{kind} r{i}" for i in range(R)
                               for kind in ("engine", "requests")}
    check(want <= procs, f"(e) processes missing: {sorted(want - procs)}")
    reg = res["tracer"].registry
    decided = sum(reg.counter("fleet_routing_decisions_total")
                  .series().values())
    check(decided == n_req,
          f"(e) fleet_routing_decisions_total {decided} != {n_req}")
    st = fleet.stats()
    out["e_cli"] = {
        "argv": "--replicas 2 --routing prefix --kv-layout paged "
                "--time-scale 0 --trace-out",
        "trace_file": str(trace_out.relative_to(ROOT)),
        "trace_events": len(events), "route_instants": len(routes),
        "routing_decisions": decided, "wall_s": res["wall_s"],
        "summary_line": format_summary("trace", res["summary"]),
        "n_steals": st["n_steals"], "n_drains": st["n_drains"],
        "model_calls": calls,
        "by_kind": [kind_walls(e.tracer.attribution())
                    for e in fleet.replicas],
        "launches": {k: n for k, n in launches.items() if n}}
    log(f"  (e) {out['e_cli']['summary_line']}")
    for i, k in enumerate(out["e_cli"]["by_kind"]):
        log(f"  (e) r{i}: " + json.dumps(k))
    del res, fleet
    torch.cuda.empty_cache()
    return out, add_launches(*runs)


# ------------------------------------------------------- phase 8: pipeline
def calibrate(torch, log, cfg):
    """8(a): the dense bf16 model from seed 0 and its own calibration
    statistics over 4 SyntheticLM batches."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.eval import harness
    from repro_torch.models import transformer as tfm

    t0 = time.perf_counter()
    dense = tfm.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                            "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    data = SyntheticLM(vocab=cfg.vocab, seq_len=CALIB["seq_len"],
                       batch=CALIB["batch"], seed=0)
    batches = data.calibration(CALIB["n_batches"])
    t0 = time.perf_counter()
    stats = harness.collect_activation_stats(cfg, dense, batches)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    tokens = CALIB["n_batches"] * CALIB["batch"] * CALIB["seq_len"]
    want = {f"layers/{i}/{p}" for i in range(cfg.n_layers)
            for p in PROJ_NAMES}
    check(set(stats) == want,
          f"calibration: {len(stats)} leaves, want {len(want)}")
    for name, st in stats.items():
        check(float(st.count) == tokens,
              f"calibration: {name} counted {float(st.count)} tokens")
        check(bool(torch.isfinite(st.sq_sum).all()
                   and torch.isfinite(st.max_abs).all()),
              f"calibration: non-finite statistics for {name}")
    out = {"leaves": len(stats), "tokens": tokens, "init_s": init_s,
           "calibrate_s": calib_s}
    log(f"  (a) {json.dumps(out)}")
    return dense, stats, out


def check_container(torch, name, sw, o_n):
    """8(b)'s gates on one compressed projection: bf16 values, the N:M
    invariant, ``o_n`` distinct ascending outlier indices in every 256-group
    and W_nm zero at every salient slot."""
    from repro_torch.core import (unpack_metadata, unpack_outlier_meta,
                                  validate_nm_mask)
    from repro_torch.core.packing import scatter_blocks
    from repro_torch.models.sparse_serving import SparseWeight

    check(isinstance(sw, SparseWeight) and sw.v_scale is None
          and sw.nm_values.dtype == torch.bfloat16
          and sw.o_values is not None and sw.o_n == o_n
          and sw.o_values.dtype == torch.bfloat16,
          f"{name}: not a bf16 SparseWeight with {o_n}:256 outliers")
    N = sw.nm_values.shape[0]
    idx = unpack_metadata(sw.nm_meta, sw.n).long()
    kept = torch.zeros((N, sw.in_dim // sw.m, sw.m), dtype=torch.bool,
                       device=idx.device).scatter_(-1, idx, True)
    check(validate_nm_mask(kept.reshape(N, -1), (sw.n, sw.m)),
          f"{name}: the {sw.n}:{sw.m} invariant does not hold")
    o_idx = unpack_outlier_meta(sw.o_meta, sw.o_n).long()
    check(bool((o_idx[..., 1:] > o_idx[..., :-1]).all()),
          f"{name}: outlier indices not distinct and ascending")
    salient = torch.zeros((N, sw.in_dim // 256, 256), dtype=torch.bool,
                          device=idx.device).scatter_(-1, o_idx, True)
    w_nm = scatter_blocks(sw.nm_values.reshape(*idx.shape), idx, sw.m)
    check(bool((w_nm.reshape(N, -1)[salient.reshape(N, -1)] == 0).all()),
          f"{name}: W_nm is not zero at every salient slot")


def layer0_checks(torch, log, lp, sparse_lp, st, scfg):
    """8(b) on layer 0: the card's containers against the same pipeline on
    the CPU from the same bf16 weights and statistics, and the unstructured
    mode's salient density."""
    from repro_torch.core import (ActStats, sparsify_linear, unpack_metadata,
                                  unpack_outlier_meta)

    agree = {"nm": [0, 0], "outliers": [0, 0]}
    unstructured, t0 = {}, time.perf_counter()
    for p in PROJ_NAMES:
        sw, s = sparse_lp[p], st[p]
        ref = sparsify_linear(lp[p].cpu(), ActStats(
            s.sq_sum.cpu(), s.max_abs.cpu(), s.count.cpu()), scfg)
        for key, ours, theirs in (
                ("nm", unpack_metadata(sw.nm_meta, sw.n).cpu(),
                 ref.nm.indices),
                ("outliers", unpack_outlier_meta(sw.o_meta, sw.o_n).cpu(),
                 ref.outliers.indices)):
            same = ours == theirs
            agree[key][0] += int(same.sum())
            agree[key][1] += same.numel()
            if key == "outliers":       # copies of the weights: exact
                check(torch.equal(sw.o_values.cpu()[same],
                                  ref.outliers.values[same]),
                      f"layer 0 {p}: salient values differ from the CPU's")
    cpu_s = time.perf_counter() - t0
    for p in PROJ_NAMES:
        w = lp[p]
        sl = sparsify_linear(w, st[p], dataclasses.replace(
            scfg, unstructured_outliers=True))
        k = round(w.numel() * 16 / 256)
        extra = int(sl.salient_mask.sum()) - k
        check(sl.outliers is None and 0 <= extra <= 1,
              f"layer 0 {p} unstructured: {extra:+d} salient entries against "
              f"the 16/256 budget of {k}")
        unstructured[p] = {"salient": k + extra, "budget": k,
                           "density": (k + extra) / w.numel()}
    share = {k: a / n for k, (a, n) in agree.items()}
    for key, val in share.items():
        check(val >= PIPELINE_AGREE, f"layer 0: {key} index agreement with "
                                     f"the CPU {val:.6f} < {PIPELINE_AGREE}")
    out = {"cpu_index_agreement": share,
           "cpu_indices_compared": {k: n for k, (_, n) in agree.items()},
           "cpu_pipeline_s": cpu_s, "unstructured": unstructured}
    log(f"  (b) layer 0: {json.dumps(out)}")
    return out


def compress(torch, log, cfg, dense, stats):
    """8(b): RIA + SmoothQuant + VC to 8:16 + 16:256, one layer at a time on
    the card.  Returns (compressed params, numbers)."""
    from repro_torch.core import SparsifyConfig, compression_report
    from repro_torch.models.sparse_serving import sparsify_for_serving

    scfg = SparsifyConfig(weight_pattern="8:16", outlier_pattern="16:256")
    report = {"n_layers_sparsified": 0, "dense_bytes": 0,
              "compressed_bytes": 0}
    paper_bytes, layers, seconds = 0, [], []
    for i, lp in enumerate(dense["layers"]):
        st = {p: stats[f"layers/{i}/{p}"] for p in PROJ_NAMES}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, rep = sparsify_for_serving(lp, scfg, st)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        for p in PROJ_NAMES:
            check_container(torch, f"layer {i} {p}", new[p], 16)
            paper_bytes += compression_report(
                *lp[p].shape, "8:16", "16:256")["compressed_bytes"]
        for key in report:
            report[key] += rep[key]
        layers.append(new)
    sparse = dict(dense, layers=layers)
    out = {"config": dataclasses.asdict(scfg), "seconds_per_layer": {
        "mean": sum(seconds) / len(seconds), "max": max(seconds),
        "total": sum(seconds)},
        "compressed_gb": report["compressed_bytes"] / 1e9,
        "dense_gb": report["dense_bytes"] / 1e9,
        "ratio": report["compressed_bytes"] / report["dense_bytes"],
        "paper_accounting_gb": paper_bytes / 1e9,
        "matrices": report["n_layers_sparsified"]}
    log(f"  (b) {json.dumps(out)}")
    out["layer0"] = layer0_checks(torch, log, dense["layers"][0], layers[0],
                                  {p: stats[f"layers/0/{p}"]
                                   for p in PROJ_NAMES}, scfg)
    return sparse, scfg, out


def pipeline_serve(torch, log, cfg, sparse, paged_a):
    """8(c): phase 6(a)'s traffic on the paged layout from the compressed
    params, with 6(a)'s numbers of the same run beside."""
    from repro_torch.serving import ServingEngine

    engine = ServingEngine(cfg, sparse, device="cuda", n_slots=8,
                           max_len=1024, token_budget=512, kv_layout="paged",
                           block_size=ATTN_SHAPE["bs"])
    prompts = prompts_for(torch, cfg, SERVE_PROMPT_LENS, seed=10)
    torch.cuda.reset_peak_memory_stats()
    reqs, wall, decode_only, launches = drive(torch, engine, [prompts],
                                              SERVE_GEN)
    out = serve_numbers(torch, engine, reqs, wall, decode_only, launches)
    add_profile(torch, engine, out, seed=11)
    out["vs_6a"] = {
        "decode_step_p50_ms": [out["decode_step_ms"]["p50"],
                               paged_a["decode_step_ms"]["p50"]],
        "tok_per_s": [out["tok_per_s"], paged_a["tok_per_s"]],
        "ttft_p50_ms": [out["ttft_ms"]["p50"], paged_a["ttft_ms"]["p50"]],
        "itl_p50_ms": [out["itl_ms"]["p50"], paged_a["itl_ms"]["p50"]]}
    log(f"  (c) {json.dumps(out)}")
    del engine
    torch.cuda.empty_cache()
    return out


def ops_phase(torch, timer, log, lp, st):
    """8(d): ``kernels/ops`` on layer 0's four projection shapes, each
    outlier pattern and M; the counts are set to 0 just before each group of
    ``ops`` calls and read just after, and the comparisons and timings
    run outside them.  Returns (cases, launches, ceilings): ``ceilings``
    gives each case's gather ceiling, worked out, not measured, so it
    stays out of the cases of the kernels line."""
    import torch.nn.functional as F
    from repro_torch.core import (SparsifyConfig, pack_outlier_meta,
                                  sparsify_linear)
    from repro_torch.kernels import fused_sparse_linear as fsl
    from repro_torch.kernels import nm_spmm as nms
    from repro_torch.kernels import ops
    from repro_torch.kernels import outlier_spmm as osp

    g = torch.Generator(device="cuda").manual_seed(8)
    cases, launches, ceilings = [], {}, []
    for p in OPS_PROJ:
        w = lp[p]
        N, K = w.shape
        for pat in OPS_PATTERNS:
            sl = sparsify_linear(w, st[p], SparsifyConfig(
                weight_pattern="8:16", outlier_pattern=pat))
            o, nm = sl.outliers, sl.nm
            vals, meta = o.values, pack_outlier_meta(o.indices)
            nm_meta = nm.packed_metadata()
            dense_o = o.to_dense()
            del sl
            for M in MS:
                x = torch.randn((M, K), generator=g, device="cuda").to(
                    torch.bfloat16)
                torch.cuda.synchronize()
                reset_launches()
                y = ops.outlier_matmul(x, o)
                if pat == "16:256":
                    y_nm = ops.nm_matmul(x, nm)
                    y_fused = ops.sparse_linear_apply(x, nm, o)
                torch.cuda.synchronize()
                for key, n in read_launches().items():
                    launches[key] = launches.get(key, 0) + n
                y_plain = osp.plain(x, vals, meta, n=o.n)
                check(y.shape == (M, N) and y.dtype == torch.bfloat16
                      and bool(torch.isfinite(y).all()),
                      f"outlier_spmm {p} {pat} M={M}: {tuple(y.shape)} "
                      f"{y.dtype} or non-finite")
                err = float((y.float() - y_plain.float()).abs().max())
                tol = KERNEL_TOL_REL * float(y_plain.float().abs().max())
                check(err <= tol, f"outlier_spmm {p} {pat} M={M}: "
                                  f"max|kernel-plain| {err:.3e} > {tol:.3e}")
                b_ms, b_by = outlier_bound(M, N, K, o.n)
                case = {"proj": p, "pattern": pat, "N": N, "K": K, "M": M,
                        "max_abs_err": err, "tol": tol,
                        "ms": timer.ms(lambda: osp.outlier_spmm(
                            x, vals, meta, n=o.n), 20),
                        "plain_ms": timer.ms(lambda: osp.plain(
                            x, vals, meta, n=o.n), 5),
                        "library_ms": timer.ms(lambda: F.linear(x, dense_o),
                                               20),
                        "bound_ms": b_ms, "bound_by": b_by}
                ceiling = outlier_gather_ceiling(M, N, K, o.n)
                # the plan's body (decode at M <= T, prefill above): the
                # same inputs twice give the same bits, and the old kernel
                # is timed beside it on the same inputs
                op = osp.plan(M, K, N, o.n, sm_count(torch))
                again = osp.outlier_spmm(x, vals, meta, n=o.n)
                torch.cuda.synchronize()
                check(torch.equal(y, again), f"outlier_spmm {p} {pat} M={M}: "
                                             f"two calls give different bits")
                old_plan = osp.gather8_plan(M, K, N)
                case.update(path=op.path, rows=op.rows, cols=op.cols,
                            splits=op.splits,
                            old_ms=timer.ms(lambda: osp.outlier_spmm(
                                x, vals, meta, n=o.n, force_plan=old_plan),
                                20))
                if pat == "16:256":
                    pair = y_nm + y
                    u_err = float((pair.float() - y_fused.float()).abs().max())
                    u_tol = UNFUSED_TOL_REL * sum(
                        float(t.float().abs().max()) for t in (y_nm, y,
                                                               y_fused))
                    check(u_err <= u_tol, f"ops {p} M={M}: unfused pair vs "
                                          f"fused {u_err:.3e} > {u_tol:.3e}")
                    case.update(
                        unfused_err=u_err, unfused_tol=u_tol,
                        unfused_ms=timer.ms(lambda: nms.nm_spmm(
                            x, nm.values, nm_meta, n=nm.n, m=nm.m)
                            + osp.outlier_spmm(x, vals, meta, n=o.n), 20),
                        fused_ms=timer.ms(lambda: fsl.fused_sparse_linear(
                            x, nm.values, nm_meta, vals, meta, n=nm.n,
                            m=nm.m, o_n=o.n), 20))
                cases.append(case)
                ceilings.append({"proj": p, "pattern": pat, "M": M,
                                 "path": op.path, "ms": ceiling})
                log(f"  (d) outlier_spmm {p:7s} {pat:6s} M={M:4d}: err "
                    f"{err:.2e} (tol {tol:.2e})  {op.path} {op.rows}x"
                    f"{op.cols} S={op.splits} {case['ms']:.4f} ms  old "
                    f"{case['old_ms']:.4f}  plain {case['plain_ms']:.4f}  "
                    f"F.linear {case['library_ms']:.4f}  bound {b_ms:.4f} "
                    f"({b_by})  gather ceiling {ceiling:.4f}"
                    + (f"  unfused {case['unfused_ms']:.4f} fused "
                       f"{case['fused_ms']:.4f}" if pat == "16:256" else ""))
            del o, nm, vals, meta, nm_meta, dense_o
    n16 = len(OPS_PROJ) * len(MS)
    want = {"outlier_spmm": len(OPS_PATTERNS) * n16, "nm_spmm": n16,
            "fused_sparse_linear": n16}
    for name in ("nm_spmm", "fused_sparse_linear"):   # split by path
        want[f"{name}_decode"] = len(OPS_PROJ) * sum(
            M <= fsl.DECODE_MAX_M for M in MS)
        want[f"{name}_prefill"] = len(OPS_PROJ) * sum(
            M > fsl.DECODE_MAX_M for M in MS)
    for path, count in (("decode", sum(M <= osp.DECODE_MAX_M for M in MS)),
                        ("prefill", sum(M > osp.DECODE_MAX_M for M in MS))):
        want[f"outlier_spmm_{path}"] = (len(OPS_PATTERNS) * len(OPS_PROJ)
                                        * count)
    for key, n in launches.items():
        check(n == want.get(key, 0),
              f"ops path: {key} launched {n} times, want {want.get(key, 0)}")
    return cases, launches, ceilings


def perplexity_phase(torch, log, cfg, dense, sparse, stats, scfg):
    """8(e): perplexities, reported; the compressed params' forward (fused
    kernel) against the dense-effective params' (torch.matmul), gated."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.eval import harness
    from repro_torch.models import transformer as tfm

    data = SyntheticLM(vocab=cfg.vocab, seq_len=PPL["seq_len"],
                       batch=PPL["batch"], seed=0)
    n = PPL["n_batches"]
    out = {"tokens": n * PPL["batch"] * PPL["seq_len"],
           "ppl_dense": harness.eval_ppl(cfg, dense, data, n_batches=n)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    effective = harness.sparsify_model(cfg, dense, stats, scfg)
    torch.cuda.synchronize()
    out["sparsify_model_s"] = time.perf_counter() - t0
    check(all(isinstance(lp[p], torch.Tensor) for lp in effective["layers"]
              for p in PROJ_NAMES),
          "sparsify_model: a projection is not a dense tensor")
    out["ppl_dense_effective"] = harness.eval_ppl(cfg, effective, data,
                                                  n_batches=n)
    out["ppl_compressed"] = harness.eval_ppl(cfg, sparse, data, n_batches=n)
    batch = {k: torch.as_tensor(v, device="cuda").long()
             for k, v in data.batch_at(50_000).items()}
    with torch.no_grad():
        torch.cuda.synchronize()
        reset_launches()
        logits, _ = tfm.forward(sparse, batch, cfg)
        torch.cuda.synchronize()
        launches = read_launches()
        reset_launches()
        ref, _ = tfm.forward(effective, batch, cfg)
        torch.cuda.synchronize()
        dense_launches = read_launches()
    del effective
    torch.cuda.empty_cache()
    for key, count in launches.items():
        # 2 x 512 rows a projection: the prefill kernel
        want = 7 * cfg.n_layers if key in (
            "fused_sparse_linear", "fused_sparse_linear_prefill") else 0
        check(count == want, f"forward: {key} launched {count}, want {want}")
    check(not any(dense_launches.values()),
          f"dense-effective forward launched sparse kernels: "
          f"{dense_launches}")
    check(bool(torch.isfinite(logits).all()), "forward: non-finite logits")
    scale = float(ref.float().abs().max())
    err = float((logits.float() - ref.float()).abs().max())
    out.update(layers=cfg.n_layers, logit_scale=scale, max_abs_err=err,
               tol=MODEL_TOL_REL * scale,
               greedy_agreement=float((logits.argmax(-1) == ref.argmax(-1))
                                      .float().mean()))
    log(f"  (e) {json.dumps(out)}")
    check(err <= MODEL_TOL_REL * scale,
          f"forward: compressed vs dense-effective {err:.3e} > "
          f"{MODEL_TOL_REL} x {scale:.3e}")
    return out


def pipeline_phase(torch, log, paged_a):
    """Phase 8: the paper's pipeline on llama3-8b, (a) to (e)."""
    from repro_torch.configs import get

    cfg = get("llama3-8b")
    dense, stats, calib = calibrate(torch, log, cfg)
    sparse, scfg, comp = compress(torch, log, cfg, dense, stats)
    served = pipeline_serve(torch, log, cfg, sparse, paged_a)
    timer = Timer(torch)
    cases, launches, ceilings = ops_phase(torch, timer, log,
                                          dense["layers"][0],
                                          {p: stats[f"layers/0/{p}"]
                                           for p in PROJ_NAMES})
    del timer
    ppl = perplexity_phase(torch, log, cfg, dense, sparse, stats, scfg)
    del dense, sparse
    torch.cuda.empty_cache()
    fused = [c for c in cases if "fused_ms" in c]
    out = {"calibrate": calib, "compress": comp, "serve": served,
           "ops": {"launches": launches,
                   "outlier_spmm_ms": sum(c["ms"] for c in cases),
                   "outlier_spmm_old_ms": sum(c["old_ms"] for c in cases),
                   "unfused_ms": sum(c["unfused_ms"] for c in fused),
                   "fused_ms": sum(c["fused_ms"] for c in fused),
                   # worked out from the shapes (outlier_gather_ceiling)
                   "outlier_spmm_gather_ceiling_ms": {
                       "decode": sum(c["ms"] for c in ceilings
                                     if c["path"] == "decode"),
                       "prefill": sum(c["ms"] for c in ceilings
                                      if c["path"] == "prefill"),
                       "prefill_by_pattern": {
                           pat: sum(c["ms"] for c in ceilings
                                    if c["path"] == "prefill"
                                    and c["pattern"] == pat)
                           for pat in OPS_PATTERNS},
                       "cases": ceilings}},
           "perplexity": ppl}
    return out, cases, launches


# ------------------------------------------ phase 10: training and EBFT
def train_phase(torch, log):
    """10(a): ``harness.train_small_lm`` on llama3-8b at full width, 4
    layers, bf16 params, f32 moments, remat.  Returns (cfg, data, params,
    numbers)."""
    from repro_torch.configs import get
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.eval import harness
    from repro_torch.tree import flatten

    cfg = dataclasses.replace(get("llama3-8b"), n_layers=TRAIN["n_layers"])
    check(cfg.remat and cfg.dtype == torch.bfloat16,
          "phase 10 trains bf16 params with remat")
    data = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN["seq_len"],
                       batch=TRAIN["batch"], seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, losses = harness.train_small_lm(cfg, data, steps=TRAIN["steps"],
                                            lr=TRAIN["lr"], seed=0,
                                            device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_params = sum(t.numel() for t in flatten(params))
    out = {"layers": cfg.n_layers, "params": n_params,
           "tokens_per_step": TRAIN["batch"] * TRAIN["seq_len"],
           "steps": TRAIN["steps"], "lr": TRAIN["lr"], "losses": losses,
           "wall_s": wall, "wall_ms_per_step": wall / TRAIN["steps"] * 1e3,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"  (a) {json.dumps(out)}")
    check(all(math.isfinite(x) for x in losses), "train: non-finite loss")
    last = sum(losses[-5:]) / 5
    check(last < losses[0],
          f"train: mean of the last 5 losses {last:.4f} not below the "
          f"first {losses[0]:.4f}")
    return cfg, data, params, out


def model_flops(cfg, n_matmul_params, batch, seq):
    """Model FLOPs of one train step: 6 x the parameters that multiply (the
    projections and lm_head; the embedding is a lookup) x tokens, plus the
    attention products, QK^T and PV over the full S x S square as
    ``layers._sdpa_full`` computes them, forward and backward (3x)."""
    tokens = batch * seq
    attn = 3 * 4 * batch * cfg.n_heads * seq * seq * cfg.hd * cfg.n_layers
    return 6 * n_matmul_params * tokens + attn


def profile_call(torch, fn):
    """Device time by kernel class over one call of ``fn``
    (torch.profiler), with the device's busy share of the profiled call's
    wall time.  None when the profiler records no device kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    del res
    got = _device_time(prof, 1)
    if got is None:
        return None
    busy, by_class, count_by_class, top, count = got
    return {"profiled_call_ms": wall_ms, "device_busy_ms": busy,
            "busy_share_profiled": busy / wall_ms,
            "device_ms_by_class": by_class,
            "launches_by_class": count_by_class, "kernels": count,
            "top_kernels_ms": top}


def step_phase(torch, log, cfg, data, params):
    """10(b): ``make_train_step`` from (a)'s params with a fresh AdamW
    state, one batch against two microbatches (with and without int8
    compression), gated; then 5 one-batch steps timed with CUDA events and
    ``adamw_step`` alone on the same gradients."""
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_step
    from repro_torch.tree import flatten, value_and_grad

    ocfg = AdamWConfig(lr=TRAIN["lr"])
    batch = {k: torch.as_tensor(v, device="cuda").long()
             for k, v in data.batch_at(TRAIN["steps"]).items()}
    variants = {"one_batch": steps.TrainOptions(),
                "microbatches_2": steps.TrainOptions(microbatches=2),
                "microbatches_2_int8": steps.TrainOptions(
                    microbatches=2, grad_compression=True)}
    out = {"variants": {}}
    for name, opts in variants.items():
        step = steps.make_train_step(cfg, ocfg, opts)
        new_p, new_o, metrics = step(params, adamw_init(params, ocfg), batch)
        out["variants"][name] = {"loss": float(metrics["loss"]),
                                 "grad_norm": float(metrics["grad_norm"])}
        check(all(bool(torch.isfinite(t).all())
                  for t in flatten(new_p)),
              f"train step {name}: non-finite params")
        del new_p, new_o, metrics
        torch.cuda.empty_cache()
    one = out["variants"]["one_batch"]
    for name, tol in (("microbatches_2", MICRO_TOL_REL),
                      ("microbatches_2_int8", COMPRESS_TOL_REL)):
        v = out["variants"][name]
        for key in ("loss", "grad_norm"):
            check(math.isfinite(v[key]), f"train step {name}: {key} not "
                  f"finite")
            rel = abs(v[key] - one[key]) / abs(one[key])
            v[f"{key}_rel_diff"] = rel
            key_tol = MICRO_TOL_REL if key == "loss" else tol
            check(rel <= key_tol, f"train step {name}: {key} {v[key]} vs "
                  f"one batch {one[key]} ({rel:.2e} > {key_tol:.2e})")

    # timing: a warm-up, then TRAIN_TIMED_STEPS chained one-batch steps
    step = steps.make_train_step(cfg, ocfg, steps.TrainOptions())
    p, o = params, adamw_init(params, ocfg)
    p, o, _ = step(p, o, batch)
    times = []
    for _ in range(TRAIN_TIMED_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        p, o, _ = step(p, o, batch)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    profiled = profile_call(torch, lambda: step(p, o, batch))
    # the optimizer alone, on one set of gradients (the step is functional,
    # so every call does the same work)
    _, grads = value_and_grad(lambda q, b: tfm.loss_fn(q, b, cfg)[0], p,
                              batch)
    adam = []
    for _ in range(TRAIN_TIMED_STEPS + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = adamw_step(p, grads, o, ocfg)
        end.record()
        end.synchronize()
        adam.append(start.elapsed_time(end))
        del res
    del p, o, grads
    torch.cuda.empty_cache()
    step_ms = sorted(times)[len(times) // 2]
    adam_ms = sorted(adam[1:])[len(adam[1:]) // 2]
    tokens = TRAIN["batch"] * TRAIN["seq_len"]
    n_matmul = sum(t.numel() for lp in params["layers"] for t in lp.values()
                   if t.ndim == 2) + params["lm_head"].numel()
    flops = model_flops(cfg, n_matmul, TRAIN["batch"], TRAIN["seq_len"])
    out.update(profile=profiled, step_ms=times, step_ms_median=step_ms,
               adamw_ms=adam[1:], adamw_ms_median=adam_ms,
               optimizer_share=adam_ms / step_ms,
               tokens_per_s=tokens / step_ms * 1e3, matmul_params=n_matmul,
               model_flops=flops,
               bound_ms=flops / BF16_OPS_PER_S * 1e3,
               peak_share=flops / (step_ms / 1e3) / BF16_OPS_PER_S)
    log(f"  (b) {json.dumps(out)}")
    return out


def ebft_phase(torch, log, cfg, data, params):
    """10(c): calibrate (a)'s model, sparsify to 8:16 without outliers with
    RIA + SmoothQuant + VC, EBFT each block against its dense teacher on 8
    calibration sequences, repack the tuned projections and run the packed
    model through ``nm_spmm``'s two bodies, gated against the tuned
    dense-effective weights; perplexities reported."""
    import numpy as np
    from repro_torch.core import EBFTConfig, SparsifyConfig, ebft_block, \
        sparsify_tree
    from repro_torch.core.ebft import make_block_masks
    from repro_torch.core.packing import unpack_metadata
    from repro_torch.eval import harness
    from repro_torch.kernels.ref import decompress_nm
    from repro_torch.models import transformer as tfm
    from repro_torch.models.sparse_serving import to_sparse_weight

    calib = data.calibration(EBFT_CALIB_BATCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = harness.collect_activation_stats(cfg, params, calib)
    scfg = SparsifyConfig(weight_pattern="8:16", outlier_pattern=None)
    sparse, records = sparsify_tree(params, stats, scfg)
    torch.cuda.synchronize()
    out = {"sparsify": dataclasses.asdict(scfg), "ebft": dict(EBFT_CFG),
           "calibrate_and_sparsify_s": time.perf_counter() - t0}
    want = {f"layers/{i}/{p}" for i in range(cfg.n_layers)
            for p in PROJ_NAMES}
    check(set(records) == want, f"sparsify_tree: {len(records)} records")

    tokens = torch.as_tensor(np.concatenate([b["tokens"] for b in calib]),
                             device="cuda").long()         # [8, 512]
    positions = torch.arange(tokens.shape[1], device="cuda")[None]
    x = sparse["embed"][tokens]

    def block_fn(lp, h, pos):
        return tfm.block_forward(lp, h, pos, cfg)[0]

    ecfg = EBFTConfig(**EBFT_CFG)
    tuned_layers, blocks = [], []
    for i, (lp_dense, lp_sparse) in enumerate(zip(params["layers"],
                                                  sparse["layers"])):
        kept = {p: records[f"layers/{i}/{p}"].nonsalient_kept_mask
                for p in PROJ_NAMES}
        masks = make_block_masks(lp_sparse, kept)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tuned, losses = ebft_block(block_fn, lp_sparse, lp_dense, masks, x,
                                   ecfg, extra_inputs=(positions,))
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        blocks.append({"seconds": sec, "ms_per_step": sec / ecfg.steps * 1e3,
                       "first_loss": losses[0], "last_loss": losses[-1],
                       "losses": losses})
        check(all(math.isfinite(v) for v in losses),
              f"ebft block {i}: non-finite loss")
        check(losses[-1] < losses[0], f"ebft block {i}: last loss "
              f"{losses[-1]:.4e} not below the first {losses[0]:.4e}")
        for p in PROJ_NAMES:
            check(not bool(tuned[p][~kept[p]].ne(0).any()),
                  f"ebft block {i} {p}: a weight off the mask is not 0")
        with torch.no_grad():
            x = block_fn(tuned, x, positions)
        tuned_layers.append(tuned)
    out["blocks"] = blocks
    log(f"  (c) EBFT {json.dumps([{k: b[k] for k in ('seconds', 'ms_per_step', 'first_loss', 'last_loss')} for b in blocks])}")

    # repack: plain 8:16 by magnitude, no SQ/VC, must decompress exactly
    pack = SparsifyConfig(weight_pattern="8:16", outlier_pattern=None,
                          scorer="magnitude", use_smoothquant=False,
                          use_variance_correction=False)
    packed_layers = []
    for i, lp in enumerate(tuned_layers):
        new = dict(lp)
        for p in PROJ_NAMES:
            sw = to_sparse_weight(lp[p], pack)
            dense = decompress_nm(sw.nm_values, unpack_metadata(sw.nm_meta,
                                                                sw.n), sw.m)
            # +0 and -0 compare equal: the mask multiply leaves -0 off-mask
            check(dense.dtype == lp[p].dtype and torch.equal(dense, lp[p]),
                  f"repack layer {i} {p}: not the tuned weight")
            new[p] = sw
        packed_layers.append(new)
    tuned_params = dict(sparse, layers=tuned_layers)
    packed = dict(sparse, layers=packed_layers)

    forwards, launches = {}, {"nm_spmm": 0, "nm_spmm_decode": 0,
                              "nm_spmm_prefill": 0}
    eval_batch = data.batch_at(50_000)
    cases = {"prefill_2x512": eval_batch["tokens"][:2],
             "decode_8x1": np.concatenate(
                 [data.batch_at(50_000 + i)["tokens"][:, :1]
                  for i in range(2)])}
    for name, toks in cases.items():
        batch = {"tokens": torch.as_tensor(toks, device="cuda").long()}
        path = "prefill" if name.startswith("prefill") else "decode"
        with torch.no_grad():
            torch.cuda.synchronize()
            reset_launches()
            logits, _ = tfm.forward(packed, batch, cfg)
            torch.cuda.synchronize()
            got = read_launches()
            reset_launches()
            ref, _ = tfm.forward(tuned_params, batch, cfg)
            torch.cuda.synchronize()
            dense_launches = read_launches()
        for key, count in got.items():
            n = 7 * cfg.n_layers if key in ("nm_spmm", f"nm_spmm_{path}") \
                else 0
            check(count == n, f"forward {name}: {key} launched {count}, "
                  f"want {n}")
        check(not any(dense_launches.values()),
              f"dense-effective forward launched sparse kernels: "
              f"{dense_launches}")
        for key in launches:
            launches[key] += got[key]
        check(bool(torch.isfinite(logits).all()),
              f"forward {name}: non-finite logits")
        scale = float(ref.float().abs().max())
        err = float((logits.float() - ref.float()).abs().max())
        forwards[name] = {"rows": int(batch["tokens"].numel()),
                          "logit_scale": scale, "max_abs_err": err,
                          "tol": MODEL_TOL_REL * scale,
                          "launches": got["nm_spmm"]}
        check(err <= MODEL_TOL_REL * scale,
              f"forward {name}: packed vs dense-effective {err:.3e} > "
              f"{MODEL_TOL_REL} x {scale:.3e}")
    out["forward"] = forwards
    n = 2
    out["perplexity"] = {
        "tokens": n * TRAIN["batch"] * TRAIN["seq_len"],
        "dense": harness.eval_ppl(cfg, params, data, n_batches=n),
        "sparsified": harness.eval_ppl(cfg, sparse, data, n_batches=n),
        "tuned": harness.eval_ppl(cfg, tuned_params, data, n_batches=n)}
    log(f"  (c) forward {json.dumps(forwards)} perplexity "
        f"{json.dumps(out['perplexity'])}")
    del sparse, tuned_params, packed, tuned_layers, packed_layers
    torch.cuda.empty_cache()
    return out, launches


def training_phase(torch, log):
    """Phase 10: (a) train, (b) train steps, (c) EBFT and deployment."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, data, params, trained = train_phase(torch, log)
    stepped = step_phase(torch, log, cfg, data, params)
    tuned, launches = ebft_phase(torch, log, cfg, data, params)
    del params
    torch.cuda.empty_cache()
    out = {"train": trained, "step": stepped, "ebft": tuned,
           "seconds": time.perf_counter() - t0,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"  phase 10: {out['seconds']:.1f}s, peak {out['peak_mem_gb']:.1f} "
        f"GB")
    return out, launches


# ------------------- phase 16: the training driver and the one-shot loop
def vlm_oneshot_phase(torch, log, smi):
    """16(a): qwen2-vl-72b at full width cut to ``VLM_LAYERS`` layers,
    8:16+16:256 by magnitude (the down projection, in-dim 29,568, plain
    8:16 on ``nm_spmm``), built one layer at a time; its new projection
    shapes through phase 2's gate at ``VLM_MS``; one prefill call and one
    decode step with every kernel launch held in context, the prefill call
    also end to end against the plain versions; then
    ``launch/serve.run_oneshot`` over ``VLM_LOOP``'s random ``embeds`` with
    its launches gated per model call.  Returns (results, launches)."""
    import argparse
    from repro_torch.launch import serve, steps
    from repro_torch.models.model_zoo import grow_caches

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, params, build = build_model(torch, log, arch="qwen2-vl-72b",
                                     n_layers=VLM_LAYERS)
    res = {"device": smi, "build": build,
           "weight_cases": family_weight_gate(torch, log, cfg, params,
                                              ms=VLM_MS)}
    head = sum(params[n].numel() * params[n].element_size()
               for n in ("embed", "lm_head"))
    res["memory"] = {"compressed_gb": build["compressed_gb"],
                     "compressed_gb_per_layer":
                         build["compressed_gb"] / cfg.n_layers,
                     "dense_gb_per_layer": build["dense_gb"] / cfg.n_layers,
                     "embed_and_head_gb": head / 1e9,
                     "peak_build_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"  qwen2-vl-72b: {cfg.n_layers} of 80 layers, d {cfg.d_model}, "
        f"d_ff {cfg.d_ff}, M-RoPE {cfg.mrope_sections}: "
        f"{json.dumps(res['memory'])}")
    B, S, gen = VLM_LOOP["batch"], VLM_LOOP["prompt_len"], VLM_LOOP["gen"]
    g = torch.Generator(device="cuda").manual_seed(16)
    prompts, embeds = serve.draw_inputs(
        cfg, argparse.Namespace(batch=B, prompt_len=S), g)
    batch = serve.oneshot_batch(cfg, prompts, embeds)
    check(set(batch) == {"embeds", "positions"}
          and tuple(batch["positions"].shape) == (3, B, S),
          f"vlm batch: {({k: tuple(v.shape) for k, v in batch.items()})}")
    n_nm = cfg.n_layers                        # w_down, no outliers
    n_fused = launches_per_call(cfg)[0] - n_nm
    prefill, decode = steps.make_prefill_step(cfg), steps.make_decode_step(cfg)

    def by_kernel(checks):
        out = {}
        for name, _, e, tol in checks.cases:
            k = out.setdefault(name, {"launches": 0,
                                      "worst_err_over_tol": 0.0})
            k["launches"] += 1
            k["worst_err_over_tol"] = max(k["worst_err_over_tol"],
                                          e / tol if tol else 0.0)
        return out

    with torch.no_grad():
        with in_context_checks(torch) as pre:
            logits, caches = prefill(params, batch)
        with plain_versions():
            ref, ref_caches = prefill(params, batch)
        del ref_caches
        out, ref = logits.float(), ref.float()
        check(bool(torch.isfinite(out).all()), "vlm prefill: non-finite")
        err, scale = float((out - ref).abs().max()), float(ref.abs().max())
        agree = float((out.argmax(-1) == ref.argmax(-1)).float().mean())
        check(err <= MODEL_TOL_REL * scale,
              f"vlm prefill call: max|kernels-plain| {err:.3e} > "
              f"{MODEL_TOL_REL} x {scale:.3e}")
        caches = grow_caches(caches, S + 2)
        tok = logits.argmax(-1)[:, None]
        with in_context_checks(torch) as dec:
            _, caches = decode(params, caches, {"tokens": tok})
        profiled = profile_call(torch, lambda: decode(params, caches,
                                                      {"tokens": tok}))
    del caches
    want = {"fused_sparse_linear": n_fused, "nm_spmm": n_nm}
    for label, checks in (("prefill", pre), ("decode", dec)):
        got = by_kernel(checks)
        check({k: v["launches"] for k, v in got.items()} == want,
              f"vlm {label} call in context: {got}, want {want}")
        res[f"{label}_in_context"] = got
    res["prefill_call"] = {"max_abs_err": err, "scale": scale,
                           "tol_rel": MODEL_TOL_REL,
                           "greedy_agreement": agree}
    res["decode_profile"] = profiled
    log(f"  vlm prefill call {B}x{S} and a decode step: every launch within "
        f"one bf16 ulp of its plain version ({json.dumps(res['prefill_in_context'])}"
        f"; {json.dumps(res['decode_in_context'])}); the prefill call end to "
        f"end {err:.3e} of scale {scale:.3e} (greedy agreement {agree:.4f})")
    # the one-shot loop, the counts set to 0 just before and read just after
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    tokens, numbers = serve.run_oneshot(cfg, params, batch, gen)
    launches = read_launches()
    check(tuple(tokens.shape) == (B, gen) and bool(
        ((tokens >= 0) & (tokens < cfg.vocab)).all()),
        f"vlm one-shot tokens {tuple(tokens.shape)}")
    check(torch.equal(tokens[:, 0], logits.argmax(-1)),
          "vlm one-shot: the first tokens differ from the checked prefill "
          "call's")
    check_launch_counts(launches, {k: v * gen for k, v in want.items()},
                        f"qwen2-vl-72b one-shot, {gen} model calls")
    for name, n in want.items():
        check(launches[f"{name}_prefill"] == n
              and launches[f"{name}_decode"] == n * (gen - 1),
              f"{name}: prefill body {launches[f'{name}_prefill']}, decode "
              f"body {launches[f'{name}_decode']}; want {n} and "
              f"{n * (gen - 1)}")
    res["oneshot"] = dict(numbers, batch=B, prompt_len=S, gen=gen,
                          decode_step_ms=numbers["decode_s"] / (gen - 1) * 1e3,
                          peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                          launches=launches, sample=tokens[0, :8].tolist())
    log(f"  (a) vlm one-shot: {json.dumps({k: v for k, v in res['oneshot'].items() if k != 'launches'})}")
    del params, logits, ref, out, batch, embeds
    gc.collect()
    torch.cuda.empty_cache()
    return res, launches


def legacy_phase(torch, log):
    """16(b): ``--legacy`` on llama3-8b at full width, phase 10's depth,
    8:16+16:256: ``run_oneshot`` then the slot engine on the same 8 random
    prompts (``serve.legacy_parity``), each run's launches gated per model
    call; the diverging streams gated by ``near_tie_bound``.  Returns
    (results, launches of both runs)."""
    from repro_torch.launch import serve

    cfg, params, build = build_model(torch, log,
                                     n_layers=LEGACY_LOOP["n_layers"])
    args = serve.parse_args([
        "--arch", "llama3-8b", "--sparse", "--legacy",
        "--batch", str(LEGACY_LOOP["batch"]),
        "--prompt-len", str(LEGACY_LOOP["prompt_len"]),
        "--gen", str(LEGACY_LOOP["gen"])])
    inputs = serve.draw_inputs(cfg, args, torch.Generator(
        device="cuda").manual_seed(17))
    per_call = launches_per_call(cfg)[0]
    torch.cuda.synchronize()
    reset_launches()
    tokens, numbers = serve.run_oneshot(
        cfg, params, serve.oneshot_batch(cfg, *inputs), args.gen)
    one = read_launches()
    check_launch_counts(one, {"fused_sparse_linear": per_call * args.gen},
                        "llama3-8b one-shot")
    reset_launches()
    t0 = time.perf_counter()
    eng, n_bad, engine = serve.legacy_parity(cfg, params, args, "cuda",
                                             inputs, tokens)
    wall = time.perf_counter() - t0
    two = read_launches()
    calls = engine.stats()["n_model_calls"]
    check_launch_counts(two, {"fused_sparse_linear": per_call * calls},
                        f"llama3-8b --legacy engine, {calls} model calls")
    one_streams = tokens.tolist()
    divergences = stream_gate(torch, "one-shot vs engine (--legacy)", cfg,
                              params, [p.tolist() for p in inputs[0]],
                              one_streams, eng)
    res = {"build": build, "layers": cfg.n_layers, "oneshot": numbers,
           "engine_wall_s": wall, "engine_model_calls": calls,
           "streams_identical": f"{len(eng) - n_bad}/{len(eng)}",
           "divergences": divergences,
           "launches_oneshot": one, "launches_engine": two}
    log(f"  (b) --legacy: {json.dumps({k: v for k, v in res.items() if not k.startswith('launches')})}")
    del engine, params
    gc.collect()
    torch.cuda.empty_cache()
    return res, add_launches(one, two)


class TimedCheckpoints:
    """Within the block, ``launch/train``'s ``CheckpointManager`` records
    each save's host copy (the caller's part) and the background write
    until its commit, in seconds, and each restore's seconds and how many
    of its leaves equal, bit for bit, those of the state it was asked to
    be like (the state the driver saved, when it fails right after a
    save)."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        torch = self.torch
        from repro_torch.launch import train
        from repro_torch.runtime.checkpoint import CheckpointManager
        self.saves, self.restores = [], []
        outer = self

        class Timed(CheckpointManager):
            def save(self, step, tree, cfg=None, blocking=True):
                t0 = time.perf_counter()
                super().save(step, tree, cfg=cfg, blocking=blocking)
                outer.saves.append({"step": step, "host_copy_s":
                                    time.perf_counter() - t0,
                                    "returned": time.perf_counter()})

            def _gc(self):
                last = outer.saves[-1]
                last["write_s"] = time.perf_counter() - last.pop("returned")
                super()._gc()

            def restore(self, like, step=None, shardings=None):
                from repro_torch.tree import flatten
                t0 = time.perf_counter()
                out = super().restore(like, step, shardings)
                seconds = time.perf_counter() - t0
                pairs = list(zip(flatten(out[0]), flatten(like)))
                outer.restores.append({
                    "step": out[1]["step"], "seconds": seconds,
                    "leaves": len(pairs),
                    "leaves_bit_equal_to_like": sum(
                        a.dtype == b.dtype and a.device == b.device
                        and torch.equal(a.view(torch.uint8) if a.ndim else a,
                                        b.view(torch.uint8) if b.ndim else b)
                        for a, b in pairs)})
                return out
        self.saved = train.CheckpointManager
        train.CheckpointManager = Timed
        return self

    def __exit__(self, *exc):
        from repro_torch.launch import train
        train.CheckpointManager = self.saved
        return False


def driver_phase(torch, log):
    """16(c): ``launch/train.run`` on ``DRIVER_ARCH`` at full width,
    ``DRIVER_LAYERS`` deep, phase 10's batch and learning rate, with a
    failure right after the first
    of its two saves (``DRIVER``), in a temporary directory removed
    afterwards; gates the restart, the restored step, the restored state
    bit for bit against the state the driver saved (the one it held when
    it failed), one checkpoint left on disk, and the losses against an
    uninterrupted run's at the same steps (``DRIVER_LOSS_TOL_REL``)."""
    import tempfile
    from repro_torch.configs import get
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.launch.steps import TrainOptions
    from repro_torch.models.model_zoo import get_model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.tree import flatten

    cfg = dataclasses.replace(get(DRIVER_ARCH), n_layers=DRIVER_LAYERS)
    # bf16 params, f32 m and v: 10 bytes a parameter (norms aside)
    state_gb = 10 * cfg.param_count() / 1e9
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        disk = shutil.disk_usage(tmp)
        res = {"checkpoint_gb_estimate": state_gb,
               "disk": {"dir": tmp, "total_gb": disk.total / 1e9,
                        "free_gb": disk.free / 1e9}}
        log(f"  (c) a checkpoint of {state_gb:.1f} GB (bf16 params, f32 m "
            f"and v); {json.dumps(res['disk'])}")
        # keep_last_k 1: the next commit removes the last, so two at most
        check(disk.free > 2.2 * state_gb * 1e9,
              f"{disk.free / 1e9:.1f} GB free under {tmp}: two checkpoints "
              f"of {state_gb:.1f} GB do not fit")
        argv = ["--arch", DRIVER_ARCH, "--n-layers", str(DRIVER_LAYERS),
                "--batch", str(TRAIN["batch"]), "--seq",
                str(TRAIN["seq_len"]), "--lr", str(TRAIN["lr"]),
                "--ckpt-dir", tmp, "--seed", "0", "--device", "cuda"] + [
            f"--{k.replace('_', '-')}={v}" for k, v in DRIVER.items()]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with TimedCheckpoints(torch) as timed:
            report, state = train.run(train.parse_args(argv))
        wall = time.perf_counter() - t0
        nbytes = sum(t.numel() * t.element_size() for t in flatten(state))
        del state
        steps_on_disk = sorted(p.name for p in pathlib.Path(tmp).iterdir())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    fail, every = DRIVER["fail_at_step"], DRIVER["save_every"]
    resumed = fail // every * every
    check(report.restarts == 1 and report.restored_steps == [resumed],
          f"driver: {report.restarts} restarts, restored "
          f"{report.restored_steps}, want 1 and [{resumed}]")
    check(len(timed.saves) == DRIVER["steps"] // every
          and all("write_s" in s for s in timed.saves),
          f"driver: saves {timed.saves}")
    check(len(timed.restores) == 1 and timed.restores[0]["step"] == resumed
          and timed.restores[0]["leaves_bit_equal_to_like"]
          == timed.restores[0]["leaves"],
          f"driver: the restored state is not the saved one bit for bit: "
          f"{timed.restores}")
    check(steps_on_disk == [f"step_{DRIVER['steps']:06d}"],
          f"keep_last_k 1 left {steps_on_disk}")
    # the uninterrupted run: the same init, batches and step, no checkpoint
    ocfg = AdamWConfig(lr=TRAIN["lr"])
    step, _, _ = train.build(cfg, ocfg, TrainOptions())
    data = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN["seq_len"],
                       batch=TRAIN["batch"], seed=0)
    params = get_model(cfg, "cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    opt = adamw_init(params, ocfg)
    plain, times = [], []
    for i in range(DRIVER["steps"]):
        batch = {k: torch.as_tensor(v, device="cuda").long()
                 for k, v in data.batch_at(i).items()}
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, opt, m = step(params, opt, batch)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        plain.append(float(m["loss"]))
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()
    # the driver's losses: steps 0 .. fail - 1, then resumed .. steps - 1
    first, after = report.losses[:fail], report.losses[fail:]
    rel = [abs(a - b) / abs(b) for a, b in
           zip(first + after, plain[:fail] + plain[resumed:])]
    check(len(after) == DRIVER["steps"] - resumed
          and all(math.isfinite(x) for x in report.losses)
          and max(rel) <= DRIVER_LOSS_TOL_REL,
          f"driver losses {report.losses} against the uninterrupted "
          f"{plain}: relative {max(rel):.2e} > {DRIVER_LOSS_TOL_REL:.2e}")
    save_s = [s["host_copy_s"] + s["write_s"] for s in timed.saves]
    restore_s = timed.restores[0]["seconds"]
    res.update(
        layers=cfg.n_layers, argv=argv, wall_s=wall,
        losses=report.losses, uninterrupted_losses=plain,
        loss_rel_diff=rel, tol_rel=DRIVER_LOSS_TOL_REL,
        restarts=report.restarts, restored_steps=report.restored_steps,
        checkpoint_gb=nbytes / 1e9, saves=timed.saves,
        save_gb_per_s=[nbytes / 1e9 / s for s in save_s],
        restores=timed.restores, restore_gb_per_s=nbytes / 1e9 / restore_s,
        step_ms=times, step_ms_median=sorted(times[1:])[len(times[1:]) // 2],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"  (c) driver: {json.dumps({k: v for k, v in res.items() if k != 'argv'})}")
    return res


def family_train_phase(torch, log):
    """16(d): ``make_train_step`` on xlstm-350m (12 of 24 layers),
    zamba2-2.7b (27 of 54), whisper-medium at full size and mixtral-8x7b
    at 2 of 32 layers, fresh
    from seed 0, ``FAMILY_TRAIN_STEPS`` steps on one random batch of
    ``model_zoo.input_specs``' shapes (``FAMILY_TRAIN``'s sequence length)
    at phase 10's learning rate; gates finite losses and gradient norms
    and the last loss below the first."""
    from repro_torch.configs import ShapeConfig, get
    from repro_torch.launch import steps
    from repro_torch.models import model_zoo
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.tree import flatten

    ocfg = AdamWConfig(lr=TRAIN["lr"])
    out = {}
    for arch, n_layers, seq in FAMILY_TRAIN:
        cfg = get(arch)
        if n_layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=n_layers)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        g = torch.Generator(device="cuda").manual_seed(0)
        params = model_zoo.get_model(cfg, "cuda").init(g)
        n_params = sum(t.numel() for t in flatten(params))
        opt = adamw_init(params, ocfg)
        shape = ShapeConfig("train", seq, FAMILY_TRAIN_BATCH, "train")
        batch = {}
        for name, (dims, dtype) in model_zoo.input_specs(cfg, shape).items():
            if name == "embeds":
                batch[name] = torch.randn(dims, generator=g, device="cuda"
                                          ).to(dtype)
            else:
                batch[name] = torch.randint(0, cfg.vocab, dims, generator=g,
                                            device="cuda")
        step = steps.make_train_step(cfg, ocfg)
        losses, gnorms, times = [], [], []
        for _ in range(FAMILY_TRAIN_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            params, opt, m = step(params, opt, batch)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
        check(all(math.isfinite(x) for x in losses + gnorms),
              f"{arch} training: non-finite loss or gradient norm "
              f"({losses}, {gnorms})")
        check(losses[-1] < losses[0], f"{arch} training: last loss "
              f"{losses[-1]:.4f} not below the first {losses[0]:.4f}")
        rest = sorted(times[1:])
        out[arch] = {"layers": cfg.n_layers, "params": n_params,
                     "batch": shape.global_batch, "seq": shape.seq_len,
                     "losses": losses, "grad_norms": gnorms,
                     "step_ms": times, "step_ms_median": rest[len(rest) // 2],
                     "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        log(f"  (d) {arch}: {json.dumps(out[arch])}")
        del params, opt, batch, step
        gc.collect()
        torch.cuda.empty_cache()
    return out


def slice_phase(torch, log, smi):
    """Phase 16: (a) the vlm one-shot serve, (b) ``--legacy``, (c) the
    training driver, (d) a train step per family.  Returns (results,
    launches of (a) and (b))."""
    t0 = time.perf_counter()
    parts = {}

    def part(key, fn, *args):
        t = time.perf_counter()
        got = fn(*args)
        parts[key] = time.perf_counter() - t
        return got
    vlm, vlm_launches = part("16a", vlm_oneshot_phase, torch, log, smi)
    legacy, legacy_launches = part("16b", legacy_phase, torch, log)
    driver = part("16c", driver_phase, torch, log)
    families = part("16d", family_train_phase, torch, log)
    out = {"device": smi, "vlm_oneshot": vlm, "legacy": legacy,
           "driver": driver, "family_train": families,
           "seconds": time.perf_counter() - t0, "seconds_by_part": parts}
    log(f"  phase 16: {out['seconds']:.1f}s {json.dumps(parts)} ({smi})")
    return out, add_launches(vlm_launches, legacy_launches)


# ------------------------------------------- phase 17: the serving mesh
def mesh_serve_phase(torch, log, cfg, params, mesh, *, kv_dtype="bf16"):
    """Phase 17(a): phase 6(a)'s paged engine (phase 7(a)'s with int8 KV)
    on phase 4's (7's) params, without a placement and then on the 1x1
    mesh ``mesh`` (a world-size-1 NCCL group), the same traffic through
    each: the streams must be bit-identical (the placement's gathers copy,
    every product is the same kernel at the same shape), ``stats()
    ["placement"]`` must describe the mesh, and each run's launches are
    gated per model call.  Reports each run's decode step wall and, from a
    decode profile, its kernels a step by class: the gathers' extra
    launches.  Returns (results, the two runs' launches summed)."""
    from repro_torch.serving import ServingEngine

    base = dict(device="cuda", n_slots=8, max_len=1024, token_budget=512,
                kv_layout="paged", kv_dtype=kv_dtype,
                block_size=ATTN_SHAPE["bs"])
    prompts = prompts_for(torch, cfg, SERVE_PROMPT_LENS, seed=10)
    runs, streams, launches = {}, {}, []
    for label, m in (("plain", None), ("mesh_1x1", mesh)):
        engine = ServingEngine(cfg, params, mesh=m, **base)
        torch.cuda.reset_peak_memory_stats()
        reqs, wall, decode_only, got = drive(torch, engine, [prompts],
                                             SERVE_GEN)
        out = serve_numbers(torch, engine, reqs, wall, decode_only, got)
        out["placement"] = engine.stats()["placement"]
        g = torch.Generator(device="cuda").manual_seed(11)
        out["decode_profile"] = profile_decode(torch, engine, g)
        runs[label], streams[label] = out, [r.tokens for r in reqs]
        launches.append(got)
        log(f"  (a) {kv_dtype} KV, {label}: " + json.dumps(out))
        del engine
        torch.cuda.empty_cache()
    check(runs["plain"]["placement"] == {"devices": 1, "mesh": None}
          and runs["mesh_1x1"]["placement"] == {
              "devices": 1, "mesh": {"data": 1, "model": 1}},
          f"placement: {runs['plain']['placement']}, "
          f"{runs['mesh_1x1']['placement']}")
    same = sum(a == b for a, b in zip(streams["plain"], streams["mesh_1x1"]))
    check(same == len(prompts), f"1x1 mesh ({kv_dtype} KV): {same} of "
                                f"{len(prompts)} streams bit-identical")
    profs = [runs[k]["decode_profile"] for k in ("plain", "mesh_1x1")]
    res = {"kv_dtype": kv_dtype, "streams_identical": f"{same}/{same}",
           "decode_step_ms_p50": [runs[k]["decode_step_ms"]["p50"]
                                  for k in ("plain", "mesh_1x1")],
           "runs": runs}
    if all(p is not None for p in profs):
        res["kernels_per_decode_step"] = [p["kernels_per_step"]
                                          for p in profs]
        res["extra_launches_per_decode_step"] = (
            profs[1]["kernels_per_step"] - profs[0]["kernels_per_step"])
    log(f"  (a) {kv_dtype} KV: plain vs 1x1 mesh: decode step "
        f"{res['decode_step_ms_p50'][0]:.2f} vs "
        f"{res['decode_step_ms_p50'][1]:.2f} ms, kernels a step "
        f"{res.get('kernels_per_decode_step')}")
    return res, add_launches(*launches)


def shard_phase(torch, timer, log):
    """Phase 17(b): every projection shape and attention head count one
    rank of a 1x2, 1x4 and 1x8 llama3-8b mesh launches, through phase 2's
    gate (the fused kernel, bf16 and int8 values, M in ``MESH_MS``) and
    phase 2b's (decode case and 512-token chunk, bf16 and int8 arenas):
    each held against its plain version at one bf16 ulp, timed beside it,
    the library call and the bound.  Returns {kernel: cases}."""
    from repro_torch.core import SparsifyConfig
    from repro_torch.kernels import fused_sparse_linear as fsl
    from repro_torch.models.sparse_serving import to_sparse_weight
    from repro_torch.serving.cache_pool import quantize_kv

    g = torch.Generator(device="cuda").manual_seed(17)
    scfg = SparsifyConfig(weight_pattern="8:16", outlier_pattern="16:256",
                          scorer="magnitude", use_smoothquant=False)
    shapes = {}
    for m in MESH_SHARDS:
        for proj, N, K in PROJECTIONS:
            shapes.setdefault((N // m, K), []).append(f"{proj}@1x{m}")
    out = {"fused_sparse_linear": [], "fused_sparse_linear_int8": [],
           "paged_attention": [], "paged_attention_int8": []}
    for (N, K), names in shapes.items():
        w = (torch.randn((N, K), generator=g, device="cuda")
             / math.sqrt(K)).to(torch.bfloat16)
        sw, sw8 = (to_sparse_weight(w, scfg, quantize=q) for q in (False,
                                                                   True))
        del w
        for M in MESH_MS:
            x = torch.randn((M, K), generator=g, device="cuda").to(
                torch.bfloat16)
            for key, s in (("fused_sparse_linear", sw),
                           ("fused_sparse_linear_int8", sw8)):
                case = weight_case(timer, log, key, "+".join(names), x, s,
                                   fsl.fused_sparse_linear, fsl.plain)
                out[key].append(dict(case, mesh=names))
        del sw, sw8
    ga = torch.Generator().manual_seed(18)
    for m in MESH_SHARDS:
        shape = dict(ATTN_SHAPE, H=ATTN_SHAPE["H"] // m,
                     KV=ATTN_SHAPE["KV"] // m)
        for name, cursors, S, window in ATTN_HD_CASES:
            q, k, v, tables, cur = attention_case(torch, ga, cursors, S,
                                                  window, **shape)
            (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
            args = (f"{name}_1x{m}", cursors, S, window)
            for key, kv, sc in (("paged_attention", (k, v), None),
                                ("paged_attention_int8", (k8, v8),
                                 (ks, vs))):
                case = attention_run(torch, timer, log, key, args, q, *kv,
                                     tables, cur, sc, shape=shape)
                out[key].append(dict(case, mesh=f"1x{m}"))
            del q, k, v, k8, v8, ks, vs
    return out


def _two_rank_worker(rank, world, store, out_dir):
    """One of phase 17(c)'s ranks: a gloo group through a ``file://``
    store, the card for both, llama3-8b at 4 layers from seed 0 placed on
    the 1 x ``world`` mesh, phase 6(a)'s traffic; writes its streams,
    launches and numbers to ``<out_dir>/rank<r>.json``."""
    import datetime
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.serving import ServingEngine

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_serving_mesh(f"1x{world}", "cuda")
        cfg, params, _ = build_model(torch, lambda msg: None,
                                     n_layers=MESH_TWO_RANK_LAYERS)
        engine = ServingEngine(cfg, params, device="cuda", n_slots=8,
                               max_len=1024, token_budget=512,
                               kv_layout="paged", mesh=mesh,
                               block_size=ATTN_SHAPE["bs"])
        del params
        prompts = prompts_for(torch, cfg, SERVE_PROMPT_LENS, seed=10)
        reqs, wall, decode_only, launches = drive(torch, engine, [prompts],
                                                  SERVE_GEN)
        out = serve_numbers(torch, engine, reqs, wall, decode_only,
                            launches)
        out.update(streams=[r.tokens for r in reqs],
                   placement=engine.stats()["placement"],
                   arena_heads=engine.pool.blocks.k.shape[-2])
        (pathlib.Path(out_dir) / f"rank{rank}.json").write_text(
            json.dumps(out))
    finally:
        dist.destroy_process_group()


def two_rank_phase(torch, log):
    """Phase 17(c): a 1x2 mesh as two processes on the one card over gloo
    (whose collectives take CUDA tensors; NCCL refuses two ranks on one
    device), llama3-8b at full width and ``MESH_TWO_RANK_LAYERS`` layers,
    phase 6(a)'s traffic, against the same model served here without a
    placement: each rank's launches gated per model call (its own shards),
    its arenas at 4 of the 8 KV heads, both ranks' streams equal, and each
    stream equal to the unplaced one up to a divergence at a near-tie
    (``near_tie_bound``, as phase 11: a shard's rows may take another
    split of K than the whole product's)."""
    import tempfile
    import torch.multiprocessing as mp
    from repro_torch.serving import ServingEngine

    cfg, params, _ = build_model(torch, log, n_layers=MESH_TWO_RANK_LAYERS)
    engine = ServingEngine(cfg, params, device="cuda", n_slots=8,
                           max_len=1024, token_budget=512, kv_layout="paged",
                           block_size=ATTN_SHAPE["bs"])
    prompts = prompts_for(torch, cfg, SERVE_PROMPT_LENS, seed=10)
    reqs, wall, decode_only, launches = drive(torch, engine, [prompts],
                                              SERVE_GEN)
    plain = serve_numbers(torch, engine, reqs, wall, decode_only, launches)
    base = [r.tokens for r in reqs]
    del engine
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        ctx = mp.start_processes(_two_rank_worker,
                                 args=(2, f"{d}/store", d), nprocs=2,
                                 join=False, start_method="spawn")
        deadline = time.monotonic() + MESH_TWO_RANK_DEADLINE_S
        try:
            while not ctx.join(timeout=5):
                check(time.monotonic() < deadline,
                      f"two ranks still running after "
                      f"{MESH_TWO_RANK_DEADLINE_S}s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        ranks = [json.loads((pathlib.Path(d) / f"rank{r}.json").read_text())
                 for r in range(2)]
    for r, res in enumerate(ranks):
        check(res["placement"] == {"devices": 2,
                                   "mesh": {"data": 1, "model": 2}}
              and res["arena_heads"] == cfg.n_kv_heads // 2,
              f"rank {r}: placement {res['placement']}, arena heads "
              f"{res['arena_heads']}")
    check(ranks[0]["streams"] == ranks[1]["streams"],
          "the two ranks' streams differ")
    divergences = stream_gate(torch, "phase 17(c) 1x2 mesh", cfg, params,
                              prompts, base, ranks[0]["streams"])
    del params
    torch.cuda.empty_cache()
    out = {"layers": cfg.n_layers, "plain": plain,
           "ranks": [{k: v for k, v in res.items() if k != "streams"}
                     for res in ranks],
           "divergences": divergences,
           "streams_identical": sum(d is None for d in divergences)}
    log(f"  (c) 1x2 over gloo, {cfg.n_layers} layers: "
        f"{out['streams_identical']}/{len(prompts)} streams identical to "
        f"the unplaced engine's; decode step "
        f"{plain['decode_step_ms']['p50']:.2f} ms unplaced, "
        f"{[res['decode_step_ms']['p50'] for res in ranks]} ms a rank")
    return out


# ---------------------------------- phase 18: every family on the mesh
def family_shard_phase(torch, timer, log):
    """Phase 18(b): the compressed projection shapes one rank of a 1x2,
    1x4 and 1x8 mesh of xlstm-350m, zamba2-2.7b and whisper-medium
    launches ([out / m, in], ``FAMILY_MESH_PROJECTIONS``) through phase
    2's gate (the fused kernel, bf16 values, M in ``MESH_MS``), and the
    attention of zamba2's shared block and of mixtral at a rank's heads
    through phase 2b's (decode case and 512-token chunk, bf16 arenas):
    each held against its plain version at one bf16 ulp, timed beside it,
    the library call and the bound.  Returns {kernel: cases}."""
    from repro_torch.core import SparsifyConfig
    from repro_torch.kernels import fused_sparse_linear as fsl
    from repro_torch.models.sparse_serving import to_sparse_weight

    g = torch.Generator(device="cuda").manual_seed(19)
    scfg = SparsifyConfig(weight_pattern="8:16", outlier_pattern="16:256",
                          scorer="magnitude", use_smoothquant=False)
    shapes = {}
    for m in MESH_SHARDS:
        for proj, N, K in FAMILY_MESH_PROJECTIONS:
            shapes.setdefault((N // m, K), []).append(f"{proj}@1x{m}")
    out = {"fused_sparse_linear": [], "paged_attention": []}
    for (N, K), names in shapes.items():
        w = (torch.randn((N, K), generator=g, device="cuda")
             / math.sqrt(K)).to(torch.bfloat16)
        sw = to_sparse_weight(w, scfg)
        del w
        for M in MESH_MS:
            x = torch.randn((M, K), generator=g, device="cuda").to(
                torch.bfloat16)
            case = weight_case(timer, log, "fused_sparse_linear",
                               "+".join(names), x, sw,
                               fsl.fused_sparse_linear, fsl.plain)
            out["fused_sparse_linear"].append(dict(case, mesh=names))
        del sw
    ga = torch.Generator().manual_seed(20)
    for arch, (whole, window) in FAMILY_MESH_ATTN.items():
        for m in MESH_SHARDS:
            shape = dict(whole, H=whole["H"] // m, KV=whole["KV"] // m)
            for name, cursors, S, _ in ATTN_HD_CASES:
                q, k, v, tables, cur = attention_case(torch, ga, cursors, S,
                                                      window, **shape)
                case = attention_run(
                    torch, timer, log, "paged_attention",
                    (f"{name}_{arch}_1x{m}", cursors, S, window), q, k, v,
                    tables, cur, None, shape=shape)
                out["paged_attention"].append(dict(case, mesh=f"1x{m}",
                                                   arch=arch))
                del q, k, v
    return out


def family_traffic(torch, cfg):
    """Phase 18(c)'s requests of a cut model: (prompts, an enc-dec model's
    encoder features or None), the same draws in every process."""
    if cfg.family != "encdec":
        return prompts_for(torch, cfg, MESH_FAMILY_PROMPT_LENS, seed=10), \
            None
    prompts = prompts_for(torch, cfg, WHISPER_PROMPT_LENS[:4], seed=10)
    g = torch.Generator(device="cuda").manual_seed(14)
    return prompts, [torch.randn((WHISPER_FRAMES, cfg.d_model), generator=g,
                                 device="cuda").to(cfg.dtype)
                     for _ in prompts]


def family_engine_kw(cfg) -> dict:
    """Phase 18(c)'s engine of a cut model: the paged layout where the
    family has one (ssm is served on slots, encdec too, with the context
    rows of ``WHISPER_FRAMES`` frames)."""
    if cfg.family == "encdec":
        return dict(WHISPER_ENGINE, n_slots=MESH_FAMILY_ENGINE["n_slots"])
    kw = dict(MESH_FAMILY_ENGINE)
    if cfg.family in ("hybrid", "moe"):
        kw.update(kv_layout="paged", block_size=ATTN_SHAPE["bs"])
    return kw


def rank_blocks(torch, engine) -> dict:
    """What a rank holds of a cut model: its arenas' KV heads, its context
    rows' heads, its recurrent layers' splits and state leaves' shapes,
    its expert stacks' shapes."""
    from repro_torch.parallel import ColShard
    out = {}
    pool = engine.pool
    st = getattr(pool, "state", pool)
    if hasattr(st, "shards"):
        out["state_modes"] = sorted({s.mode for s in st.shards})
        out["state_shapes"] = sorted({tuple(a.shape) for layer in st.states
                                      for a in layer if a is not None})
    kv = getattr(pool, "kv", pool)
    kv = getattr(kv, "blocks", kv)
    if hasattr(kv, "k"):
        out["arena_heads"] = kv.k.shape[-2]
    if engine.cfg.family == "encdec":
        out["context_heads"] = engine.adapter.ctx.ck.shape[-2]
    if engine.cfg.family == "moe":
        moe = engine.params["layers"][0]["moe"]
        out["experts"] = {k: list(moe[k].local.shape) for k in moe
                          if isinstance(moe[k], ColShard)}
    return out


def _family_rank_worker(rank, world, store, out_dir):
    """One of phase 18(c)'s ranks: a gloo group through a ``file://``
    store, the card for both; each cut model (``MESH_FAMILY_CUTS``) from
    seed 0 placed on the 1 x ``world`` mesh and served its traffic, the
    ill-conditioned ones with every kernel launch held in context; writes
    its streams, launches, blocks and numbers to
    ``<out_dir>/rank<r>.json``."""
    import contextlib
    import datetime
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.serving import ServingEngine

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_serving_mesh(f"1x{world}", "cuda")
        res = {}
        for arch, cut in MESH_FAMILY_CUTS.items():
            cfg, params, _ = build_model(torch, lambda msg: None, arch=arch,
                                         **cut)
            prompts, embeds = family_traffic(torch, cfg)
            engine = ServingEngine(cfg, params, device="cuda", mesh=mesh,
                                   **family_engine_kw(cfg))
            del params
            torch.cuda.empty_cache()
            held = arch in MESH_FAMILY_IN_CONTEXT
            with (in_context_checks(torch) if held
                  else contextlib.nullcontext()) as checks, \
                    counted_collectives() as coll:
                reqs, wall, decode_only, launches = drive(
                    torch, engine, [prompts], MESH_FAMILY_GEN,
                    None if embeds is None else [embeds])
            out = serve_numbers(torch, engine, reqs, wall, decode_only,
                                launches)
            calls = out["model_calls"] + out["encode_calls"]
            out.update(streams=[r.tokens for r in reqs],
                       placement=engine.stats()["placement"],
                       collectives_per_model_call=coll.n / calls,
                       blocks=rank_blocks(torch, engine))
            if held:
                worst = max(e / t if t else 0.0
                            for _, _, e, t in checks.cases)
                out["in_context"] = {"launches": len(checks.cases),
                                     "worst_err_over_tol": worst}
            res[arch] = out
            del engine, reqs
            torch.cuda.empty_cache()
        (pathlib.Path(out_dir) / f"rank{rank}.json").write_text(
            json.dumps(res))
    finally:
        dist.destroy_process_group()


def family_two_rank_phase(torch, log):
    """Phase 18(c): a 1x2 mesh as two processes on the one card over gloo
    (``_family_rank_worker``), each family's cut model at full width,
    against the same model served here without a placement, one model at
    a time after the ranks are done: each rank's placement and blocks
    (state split by heads, experts by their last dim, arenas and context
    rows by KV heads), both ranks' streams equal, the launches per model
    call gated in each rank; xlstm's and whisper's streams equal to the
    unplaced engine's up to a divergence at a near-tie (``near_tie_bound``,
    as phase 17(c)); zamba2's and mixtral's divergences reported beside
    the effect of one ulp (their kernels were held in context)."""
    import tempfile
    import torch.multiprocessing as mp
    from repro_torch.serving import ServingEngine

    with tempfile.TemporaryDirectory() as d:
        ctx = mp.start_processes(_family_rank_worker,
                                 args=(2, f"{d}/store", d), nprocs=2,
                                 join=False, start_method="spawn")
        deadline = time.monotonic() + MESH_TWO_RANK_DEADLINE_S
        try:
            while not ctx.join(timeout=5):
                check(time.monotonic() < deadline,
                      f"two ranks still running after "
                      f"{MESH_TWO_RANK_DEADLINE_S}s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        ranks = [json.loads((pathlib.Path(d) / f"rank{r}.json").read_text())
                 for r in range(2)]
    out = {}
    for arch, cut in MESH_FAMILY_CUTS.items():
        cfg, params, _ = build_model(torch, log, arch=arch, **cut)
        got = [r[arch] for r in ranks]
        for r, res in enumerate(got):
            blocks = res["blocks"]
            heads = cfg.n_kv_heads // 2 if cfg.n_kv_heads % 2 == 0 \
                else cfg.n_kv_heads
            check(res["placement"] == {"devices": 2,
                                       "mesh": {"data": 1, "model": 2}}
                  and blocks.get("arena_heads", heads) == heads
                  and blocks.get("context_heads", heads) == heads
                  and blocks.get("state_modes", ["heads"]) == ["heads"]
                  and all(v[-1] * 2 == (cfg.d_model if k == "we_down"
                                        else cfg.moe.d_ff_expert)
                          for k, v in blocks.get("experts", {}).items()),
                  f"18(c) {arch} rank {r}: {res['placement']}, {blocks}")
        check(got[0]["streams"] == got[1]["streams"],
              f"18(c) {arch}: the two ranks' streams differ")
        prompts, embeds = family_traffic(torch, cfg)
        engine = ServingEngine(cfg, params, device="cuda",
                               **family_engine_kw(cfg))
        reqs, wall, decode_only, launches = drive(
            torch, engine, [prompts], MESH_FAMILY_GEN,
            None if embeds is None else [embeds])
        plain = serve_numbers(torch, engine, reqs, wall, decode_only,
                              launches)
        base = [r.tokens for r in reqs]
        del engine, reqs
        gated = arch not in MESH_FAMILY_IN_CONTEXT
        divergences = stream_gate(torch, f"phase 18(c) {arch} 1x2 mesh",
                                  cfg, params, prompts, base,
                                  got[0]["streams"], gated=gated,
                                  embeds=embeds)
        out[arch] = {
            "cut": cut, "plain": plain, "gated": gated,
            "ranks": [{k: v for k, v in res.items() if k != "streams"}
                      for res in got],
            "divergences": divergences,
            "streams_identical":
                f"{sum(x is None for x in divergences)}/{len(prompts)}"}
        log(f"  (18c) {arch} {cut}: {out[arch]['streams_identical']} "
            f"streams equal to the unplaced engine's"
            f"{'' if gated else ' (reported)'}; decode step "
            f"{plain['decode_step_ms']['p50']:.2f} ms unplaced, "
            f"{[res['decode_step_ms']['p50'] for res in got]} ms a rank; "
            f"{got[0]['collectives_per_model_call']:.1f} collectives a "
            f"call; blocks {got[0]['blocks']}"
            + (f"; in context {got[0]['in_context']}" if not gated else ""))
        del params, embeds
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ------------------------- phase 19: speculation and the fleet on meshes
def mesh_spec_phase(torch, log, cfg, mesh, ref):
    """Phase 19(a): phase 11(c)'s serve (``ref``: its numbers and streams)
    again with ``--mesh 1x1`` on the world-size-1 NCCL group: the drafter
    rides the target's placement.  Gates the streams bit-identical to
    11(c)'s (a 1x1 placement runs the same kernels at the same shapes),
    the drafted and accepted counts equal, the placement, and each run's
    launches per model call (``spec_launch_check``); reports the
    collectives of a draft and of a verify call and the decode step's p50
    against 11(c)'s.  Returns (numbers, launches)."""
    out, launches = spec_cli(torch, log, cfg, "19(a)", mesh=mesh)
    streams = out.pop("streams")
    same = sum(a == b for a, b in zip(ref["streams"], streams))
    check(same == len(ref["streams"]),
          f"19(a) speculation on the 1x1 mesh: {same} of "
          f"{len(ref['streams'])} streams bit-identical to 11(c)'s")
    counts = [(r["speculative"]["drafted"], r["speculative"]["accepted"])
              for r in (ref, out)]
    check(counts[0] == counts[1],
          f"19(a) drafted and accepted {counts[1]} on the mesh, {counts[0]} "
          f"unplaced")
    check(out["placement"] == {"devices": 1, "mesh": {"data": 1, "model": 1}},
          f"19(a) placement {out['placement']}")
    per_call = out["collectives_per_call"]
    check(all(len(per_call.get(k, [])) == 1 and per_call[k][0] > 0
              for k in ("draft_step", "draft_decode", "step")),
          f"19(a) collectives a call by kind: {per_call}")
    res = {"streams_identical": f"{same}/{same}",
           "drafted_accepted": counts[1],
           "collectives_per_draft_call": {
               k: per_call[k][0] for k in ("draft_step", "draft_decode")},
           "collectives_per_verify_call": per_call["step"][0],
           "decode_step_ms_p50": [ref["decode_step_ms_p50"],
                                  out["decode_step_ms_p50"]],
           "run": out}
    log(f"  19(a) unplaced vs 1x1 mesh: decode step "
        f"{res['decode_step_ms_p50'][0]:.2f} vs "
        f"{res['decode_step_ms_p50'][1]:.2f} ms; collectives a draft call "
        f"{res['collectives_per_draft_call']}, a verify call "
        f"{res['collectives_per_verify_call']}")
    return res, launches


def _fleet_rank_worker(rank, world, store, out_dir, trace_path):
    """One of phase 19(b)'s processes: a world of ``world`` over a
    ``file://`` store (gloo for host tensors, NCCL for the card's), the
    card for all, ``make_replica_meshes("1x1", world)`` (each replica its
    own NCCL group of one), llama3-8b at ``MESH_FLEET_LAYERS`` layers from
    seed 0 and a prefix-routed ``ReplicaSet(meshes=)`` replaying the
    trace at time scale 0 on the fleet's clock; writes its decisions,
    streams, launches and times to ``<out_dir>/rank<r>.json``."""
    import datetime
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_replica_meshes
    from repro_torch.serving import ReplicaSet, load_trace, replay

    torch.cuda.set_device(0)
    dist.init_process_group("cpu:gloo,cuda:nccl",
                            init_method=f"file://{store}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        meshes = make_replica_meshes("1x1", world, "cuda")
        cfg, params, _ = build_model(torch, lambda msg: None,
                                     n_layers=MESH_FLEET_LAYERS)
        fleet = ReplicaSet(cfg, params, n_replicas=world, routing="prefix",
                           meshes=meshes, **fleet_kwargs(FLEET_BLOCKS))
        del params
        own = fleet.replicas[fleet.own_replica]
        trace = load_trace(trace_path)
        torch.cuda.synchronize()
        reset_launches()
        res = replay(fleet, trace, time_scale=0.0, clock=fleet.shared_clock)
        torch.cuda.synchronize()
        launches = read_launches()
        st = fleet.stats()
        out = {"replica": fleet.own_replica,
               "slices": [m.mesh.flatten().tolist() for m in meshes],
               "placement": own.stats()["placement"],
               "streams": [r.tokens for r in res["finished"]],
               "status": [r.status.value for r in res["finished"]],
               "rejected": res["rejected"], "wall_s": res["wall_s"],
               "home": {str(k): v for k, v in sorted(fleet.home.items())},
               "n_steals": st["n_steals"], "n_drains": st["n_drains"],
               "decisions_by": st["router"]["decisions_by"],
               "finished_by_replica": [p["n_finished"]
                                       for p in st["replicas"]],
               "busy_s": st["busy_s"], "router_busy_s": st["router_busy_s"],
               "critical_path_s": st["critical_path_s"],
               "model_calls": own.adapter.n_model_calls,
               "n_layers": cfg.n_layers, "launches": launches}
        (pathlib.Path(out_dir) / f"rank{rank}.json").write_text(
            json.dumps(out))
    finally:
        dist.destroy_process_group()


def mesh_fleet_phase(torch, log):
    """Phase 19(b): a fleet of 2 replicas of 1x1 as two processes on the
    one card (``_fleet_rank_worker``), phase 12(c)'s prefix-routed trace at
    ``MESH_FLEET_LAYERS`` layers, against a one-process ``ReplicaSet`` on
    the same trace here.  Gates both processes' homes, steals, drains,
    routing decisions and finished streams equal, each process's launches
    per its replica's model calls, and the streams against the
    one-process fleet's through ``near_tie_bound`` (as phase 12); reports
    ``busy_s`` and ``critical_path_s`` (both processes share the card: no
    speed-up figure)."""
    import tempfile
    import torch.multiprocessing as mp
    from repro_torch.serving import (ReplicaSet, Status, fleet_trace,
                                     replay, save_trace)

    cfg, params, _ = build_model(torch, log, n_layers=MESH_FLEET_LAYERS)
    trace = fleet_trace(vocab=cfg.vocab, **FLEET_TRACE)
    trace_path = ROOT / "chiprun_out" / "phase19_requests.json"
    trace_path.parent.mkdir(exist_ok=True)
    save_trace(str(trace_path), trace)
    prompts = [t.prompt for t in sorted(trace, key=lambda t: t.arrival_s)]
    fleet = ReplicaSet(cfg, params, n_replicas=FLEET_REPLICAS,
                       routing="prefix", **fleet_kwargs(FLEET_BLOCKS))
    torch.cuda.synchronize()
    reset_launches()
    res = replay(fleet, trace, time_scale=0.0)
    torch.cuda.synchronize()
    launches = read_launches()
    calls = [e.adapter.n_model_calls for e in fleet.replicas]
    check_launch_counts(launches, {
        "fused_sparse_linear": 7 * cfg.n_layers * sum(calls),
        "paged_attention": cfg.n_layers * sum(calls)}, "19(b) one process")
    st = fleet.stats()
    base = {"streams": [r.tokens for r in res["finished"]],
            "home": {str(k): v for k, v in sorted(fleet.home.items())},
            "n_steals": st["n_steals"], "n_drains": st["n_drains"],
            "busy_s": st["busy_s"], "critical_path_s": st["critical_path_s"],
            "wall_s": res["wall_s"], "model_calls": calls}
    del fleet
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        ctx = mp.start_processes(
            _fleet_rank_worker,
            args=(FLEET_REPLICAS, f"{d}/store", d, str(trace_path)),
            nprocs=FLEET_REPLICAS, join=False, start_method="spawn")
        deadline = time.monotonic() + MESH_TWO_RANK_DEADLINE_S
        try:
            while not ctx.join(timeout=5):
                check(time.monotonic() < deadline,
                      f"19(b): the fleet's processes still running after "
                      f"{MESH_TWO_RANK_DEADLINE_S}s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        ranks = [json.loads((pathlib.Path(d) / f"rank{r}.json").read_text())
                 for r in range(FLEET_REPLICAS)]
    n_req = len(trace)
    for r, got in enumerate(ranks):
        check(got["replica"] == r and got["slices"] == [[0], [1]]
              and got["placement"] == {"devices": 1,
                                       "mesh": {"data": 1, "model": 1}},
              f"19(b) process {r}: replica {got['replica']}, slices "
              f"{got['slices']}, placement {got['placement']}")
        check(len(got["streams"]) == n_req and got["rejected"] == 0
              and set(got["status"]) == {Status.FINISHED.value},
              f"19(b) process {r}: {len(got['streams'])} of {n_req} "
              f"finished, {got['rejected']} rejected")
        check_launch_counts(got["launches"], {
            "fused_sparse_linear": 7 * got["n_layers"] * got["model_calls"],
            "paged_attention": got["n_layers"] * got["model_calls"]},
            f"19(b) process {r}")
    keys = ("home", "n_steals", "n_drains", "decisions_by",
            "finished_by_replica", "streams")
    for k in keys:
        check(ranks[0][k] == ranks[1][k],
              f"19(b) the processes' {k} differ")
    gate = stream_gate(torch, "19(b) fleet on replica meshes vs one "
                       "process", cfg, params, prompts, base["streams"],
                       ranks[0]["streams"])
    del params
    torch.cuda.empty_cache()
    out = {"layers": cfg.n_layers, "requests": n_req,
           "one_process": {k: v for k, v in base.items() if k != "streams"},
           "processes": [dict({k: v for k, v in got.items()
                               if k not in ("streams", "status", "home")},
                              launches={k: n for k, n in
                                        got["launches"].items() if n})
                         for got in ranks],
           "home_equal_to_one_process": ranks[0]["home"] == base["home"],
           "divergences": [dict(g, request=i) for i, g in enumerate(gate)
                           if g is not None],
           "streams_identical": sum(g is None for g in gate)}
    log(f"  19(b) 2 replicas of 1x1 in two processes: steals "
        f"{ranks[0]['n_steals']}, drains {ranks[0]['n_drains']} (one "
        f"process: {base['n_steals']}, {base['n_drains']}); streams equal "
        f"to the one-process fleet's {out['streams_identical']}/{n_req}; "
        f"busy {[p['busy_s'] for p in ranks]} s, critical path "
        f"{[round(p['critical_path_s'], 3) for p in ranks]} s against "
        f"{round(base['critical_path_s'], 3)} in one process (one card "
        f"shared: not a speed-up)")
    return out


# ------------------------------------------- phase 20: the training mesh
def bf16_ulps(a, b) -> float:
    """The largest |a - b| over the bf16 ulp of max(|a|, |b|), elementwise
    (an ulp of a value below bf16's normal range counts as the smallest
    normal's)."""
    import torch
    a, b = a.float(), b.float()
    mag = torch.maximum(a.abs(), b.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((a - b).abs() / ulp).max())


def fingerprint(torch, t) -> list:
    """Two exact integer checksums of a tensor's bits: the sum of its
    words and their position-weighted sum (equal bits give equal
    fingerprints; a changed word changes both unless its change is a
    multiple of 2^64)."""
    t = t.detach().contiguous()
    w = t.view(torch.int16 if t.element_size() == 2 else torch.int32) \
        if t.dim() else t.reshape(1).view(torch.int32)
    w = w.reshape(-1).to(torch.int64)
    pos = torch.arange(w.numel(), device=w.device, dtype=torch.int64) % 65521
    return [int(w.sum()), int((w * (pos + 1)).sum())]


def run_steps(torch, step, params, opt, data, n):
    """``n`` steps from ``params``/``opt`` on ``data``'s batches: (params,
    opt, losses, grad norms, each step's wall in ms, ended by a
    synchronise)."""
    losses, norms, walls = [], [], []
    for i in range(n):
        batch = {k: torch.as_tensor(v, device="cuda").long()
                 for k, v in data.batch_at(i).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return params, opt, losses, norms, walls


def p50(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def train_mesh_opt(torch):
    """Phase 20's AdamW: bf16 moments (the reference's ``state_dtype``
    option), which keep a rank's state and the 2x1 checkpoint 40% under
    f32 moments'; phase 16(c)'s driver saves f32 ones."""
    from repro_torch.optim import AdamWConfig
    return AdamWConfig(lr=TRAIN_MESH["lr"],
                       state_dtype=getattr(torch, TRAIN_MESH["state_dtype"]))


def train_mesh_cfgs():
    from repro_torch.configs import get
    return (dataclasses.replace(get("llama3-8b"),
                                n_layers=TRAIN_MESH["layers"]),
            dataclasses.replace(get("mixtral-8x7b"),
                                n_layers=TRAIN_MESH["moe_layers"]))


def moe_tokens(torch, cfg, router):
    """The MoE layer's tokens: [B S, d] N(0, 1) from seed 0 (the scale of
    the RMS-normed hidden states it takes) plus ``moe_lean`` times expert
    0's router row over its squared norm, which raises every token's
    expert-0 logit by ``moe_lean``: expert 0's queue overflows its
    capacity, so pairs are dropped.  In the model's dtype."""
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((TRAIN_MESH["batch"] * TRAIN_MESH["seq_len"],
                     cfg.d_model), generator=g, device="cuda")
    r0 = router[0].float()
    return (x + TRAIN_MESH["moe_lean"] * r0 / r0.square().sum()).to(cfg.dtype)


def moe_vs_exact(torch, moe, p, x2, cfg, out, drops) -> dict:
    """The capacity path's output ``out`` and dropped pairs ``drops``
    (flat ``t * k + choice`` indices) on tokens ``x2`` against
    computations that share nothing with its dispatch: the pairs the
    queue rule drops, counted on the host (a pair's place is the running
    count of its expert in flat (token, choice) order; places at or past
    the capacity are dropped), and the exact per-token path
    (``_expert_ffn``'s grouped products) with the dropped pairs' weights
    zeroed.  Gates each output element within its rounding bound: one
    bf16 ulp of the element, two of each weighted expert term summed into
    it (the term's products take another accumulation order in the
    capacity path's batched products, and the term rounds again when
    weighted), and 2^-8 of the output's rms (a flipped rounding of a
    hidden element moves the down product by at most that).  A wrong
    expert, weight or dropped pair moves an element by the size of a
    whole term."""
    k, E = cfg.moe.top_k, cfg.moe.num_experts
    T = x2.shape[0]
    C = moe.capacity(T, cfg)
    top_w, top_e = moe.route(p, x2, cfg)
    flat_e = top_e.reshape(-1)
    seen, expect = [0] * E, []
    for i, e in enumerate(flat_e.tolist()):
        if seen[e] >= C:
            expect.append(i)
        seen[e] += 1
    got = sorted(int(i) for d in drops for i in d.tolist())
    w = top_w.reshape(-1).clone()
    w[torch.tensor(expect, dtype=torch.long, device=w.device)] = 0.0
    flat_t = torch.arange(T, device=x2.device).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    counts = torch.bincount(flat_e, minlength=E).tolist()
    ys = moe._expert_ffn(p, x2[flat_t[order]], counts, cfg)
    ys = ys * w[order][:, None].to(ys.dtype)
    ref = torch.zeros_like(x2).index_add_(0, flat_t[order], ys)

    def ulp(v):
        return torch.exp2(torch.floor(torch.log2(
            v.abs().float().clamp_min(2.0 ** -126))) - 7)
    terms = torch.zeros(ref.shape, dtype=torch.float32, device=ref.device)
    terms.index_add_(0, flat_t[order], ulp(ys))
    a, b = out.float(), ref.float()
    tol = ulp(torch.maximum(a.abs(), b.abs())) + 2 * terms \
        + 2.0 ** -8 * b.square().mean().sqrt()
    return {"capacity": C, "dropped_pairs": len(got),
            "drops_match_rule": got == expect,
            "worst_over_tol": float(((a - b).abs() / tol).max()),
            "bf16_ulps": bf16_ulps(out, ref)}


def train_mesh_1x1_phase(torch, log, mesh):
    """20(a): on the 1x1 mesh (phase 17(a)'s world-size-1 NCCL group),
    ``launch/train.build(mesh=)``'s step against ``make_train_step``'s on
    llama3-8b (full width, 2 layers, batch 8 x 128, 3 steps from seed 0):
    gates the losses, gradient norms and parameters bit-identical and the
    peak device memory of the steps equal (a world of one gathers,
    copies and reduces nothing).  Then mixtral-8x7b (full width, 1
    layer): the MoE layer under the policy (the capacity path the sharded
    step takes) on tokens that overflow expert 0's queue, through
    ``moe_vs_exact``; and one sharded step, its loss finite.  Returns
    (results, llama's unplaced step 0 and its parameters after it, on the
    host, for 20(b))."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.launch.steps import TrainOptions, make_train_step
    from repro_torch.models import moe
    from repro_torch.models.model_zoo import get_model
    from repro_torch.optim import adamw_init
    from repro_torch.parallel import fsdp
    from repro_torch.parallel.policy import activation_sharding
    from repro_torch.tree import flatten

    cfg, mcfg = train_mesh_cfgs()
    ocfg = train_mesh_opt(torch)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_MESH["seq_len"],
                       batch=TRAIN_MESH["batch"], seed=0)
    zoo = get_model(cfg, "cuda")
    n = TRAIN_MESH["steps"]
    res = {"layers": cfg.n_layers, "batch": TRAIN_MESH["batch"],
           "seq_len": TRAIN_MESH["seq_len"], "steps": n}
    runs = {}
    step_m, p_sh, _ = train.build(cfg, ocfg, TrainOptions(), mesh)
    for label, step in (("unplaced", make_train_step(cfg, ocfg)),
                        ("mesh_1x1", step_m)):
        params = zoo.init(torch.Generator(device="cuda").manual_seed(0))
        if label == "mesh_1x1":
            params = fsdp.shard_tree(params, p_sh)
        opt = adamw_init(params, ocfg)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params, opt, losses, norms, walls = run_steps(
            torch, step, params, opt, data, 1)
        if label == "unplaced":
            step1 = {"loss": losses[0], "grad_norm": norms[0],
                     "params": [t.cpu() for t in flatten(params)]}
        params, opt, l2, n2, w2 = run_steps(
            torch, step, params, opt, _Offset(data, 1), n - 1)
        runs[label] = {"losses": losses + l2, "grad_norms": norms + n2,
                       "step_ms": walls + w2,
                       "step_ms_p50": p50((walls + w2)[1:]),
                       "peak_mem_gb":
                           torch.cuda.max_memory_allocated() / 1e9}
        # the final params' exact fingerprints: keeping the params would
        # hold a copy on the card through the next run's peak
        runs[label]["params"] = [fingerprint(torch, t)
                                 for t in flatten(params)]
        del params, opt
    a, b = runs["unplaced"], runs["mesh_1x1"]
    check(a["losses"] == b["losses"] and a["grad_norms"] == b["grad_norms"],
          f"20(a): the 1x1 mesh's losses {b['losses']} / norms "
          f"{b['grad_norms']} are not the unplaced step's {a['losses']} / "
          f"{a['grad_norms']}")
    same = sum(x == y for x, y in zip(a.pop("params"), b.pop("params")))
    check(same == len(flatten(p_sh.specs)),
          f"20(a): {same} of {len(flatten(p_sh.specs))} parameters "
          f"bit-identical after {n} steps on the 1x1 mesh")
    check(a["peak_mem_gb"] == b["peak_mem_gb"],
          f"20(a): peak device memory {b['peak_mem_gb']} GB on the 1x1 "
          f"mesh against {a['peak_mem_gb']} GB unplaced")
    res.update(runs, params_bit_identical=same)
    gc.collect()
    torch.cuda.empty_cache()

    # mixtral: the capacity path on one shard, and one sharded step
    mzoo = get_model(mcfg, "cuda")
    mparams = mzoo.init(torch.Generator(device="cuda").manual_seed(0))
    mdata = SyntheticLM(vocab=mcfg.vocab, seq_len=TRAIN_MESH["seq_len"],
                        batch=TRAIN_MESH["batch"], seed=0)
    lp = mparams["layers"][0]["moe"]
    x2 = moe_tokens(torch, mcfg, lp["router"])
    with torch.no_grad():
        with activation_sharding(mesh), moe.record_drops() as drops:
            ep = moe.moe_apply(lp, x2, mcfg)
        exact = moe_vs_exact(torch, moe, lp, x2, mcfg, ep, drops)
    check(exact["drops_match_rule"] and exact["worst_over_tol"] <= 1.0
          and exact["dropped_pairs"] > 0,
          f"20(a): the capacity path on 1x1 against the exact one: {exact}")
    mstep, _, _ = train.build(mcfg, ocfg, TrainOptions(), mesh)
    mopt = adamw_init(mparams, ocfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with moe.record_drops() as step_drops:
        out = run_steps(torch, mstep, mparams, mopt, mdata, 1)
    ml, mn, mw = out[2:]
    del out
    check(all(math.isfinite(x) for x in ml + mn),
          f"20(a): mixtral's sharded step: loss {ml}, norm {mn}")
    res["mixtral"] = {
        "layers": mcfg.n_layers, "tokens": x2.shape[0],
        "pairs": x2.shape[0] * mcfg.moe.top_k, "vs_exact": exact,
        "step_loss": ml[0], "step_grad_norm": mn[0], "step_ms": mw[0],
        "step_dropped_pairs": int(sum(len(d) for d in step_drops)),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    del mparams, mopt, lp, x2
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  (a) 1x1: llama3-8b {cfg.n_layers} layers, {n} steps bit-"
        f"identical; step p50 {a['step_ms_p50']:.1f} ms unplaced, "
        f"{b['step_ms_p50']:.1f} ms on 1x1; peak {a['peak_mem_gb']:.2f} / "
        f"{b['peak_mem_gb']:.2f} GB; mixtral's capacity path vs exact "
        f"{exact['worst_over_tol']:.3f} of the bound "
        f"({exact['bf16_ulps']:.1f} ulps), {exact['dropped_pairs']} of "
        f"{res['mixtral']['pairs']} pairs dropped as the rule says")
    return res, step1


class _Offset:
    """``data`` with its steps shifted by ``k`` (``batch_at(i)`` is
    ``data.batch_at(i + k)``)."""

    def __init__(self, data, k):
        self.data, self.k = data, k

    def batch_at(self, i):
        return self.data.batch_at(i + self.k)


class CountedCollectives:
    """Within the block, the calls to each collective the training step
    issues, counted on the host by kind."""

    KINDS = ("all_gather", "reduce_scatter", "all_reduce",
             "all_to_all_single", "barrier", "broadcast_object_list")

    def __enter__(self):
        import torch.distributed as dist
        self.counts = dict.fromkeys(self.KINDS, 0)
        self.saved = {k: getattr(dist, k) for k in self.KINDS}

        def counted(kind, fn):
            def call(*a, **k):
                self.counts[kind] += 1
                return fn(*a, **k)
            return call
        for k, fn in self.saved.items():
            setattr(dist, k, counted(k, fn))
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        for k, fn in self.saved.items():
            setattr(dist, k, fn)
        return False


def _gloo_probe(torch, dist, rank, world) -> dict:
    """Each collective the training step issues, once on CUDA tensors over
    the gloo group: "ok" or the error's first line."""
    x = torch.arange(4, dtype=torch.float32, device="cuda") + 10 * rank
    calls = {
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(x) for _ in range(world)], x),
        "reduce_scatter": lambda: dist.reduce_scatter(
            torch.empty(2, device="cuda"), list(x.chunk(world))),
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty_like(x), x),
        "barrier": lambda: dist.barrier(),
        "broadcast_object_list": lambda: dist.broadcast_object_list(
            [rank], src=0)}
    out = {}
    for kind in GLOO_PROBES:
        try:
            calls[kind]()
            torch.cuda.synchronize()
            out[kind] = "ok"
        except Exception as e:      # recorded: the phase gates on it
            out[kind] = f"{type(e).__name__}: {str(e).splitlines()[0]}"
    return out


def _train_mesh_rank_worker(rank, world, store, out_dir):
    """One of 20(b)'s ranks: a gloo group through a ``file://`` store, the
    card for both, the 2x1 mesh.  Probes the collectives; llama3-8b (full
    width, 2 layers) one sharded step from seed 0, the params saved from
    2x1 (rank 0 writes) and their blocks' fingerprints; mixtral's MoE
    layer on the rank's rows through the all-to-all against the plain EP
    version over 2 virtual shards and against the exact computation.
    Writes ``<out_dir>/rank<r>.json``."""
    import datetime
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.launch.steps import TrainOptions
    from repro_torch.models import moe
    from repro_torch.models.model_zoo import get_model
    from repro_torch.optim import adamw_init
    from repro_torch.parallel import fsdp
    from repro_torch.parallel.policy import activation_sharding
    from repro_torch.runtime.checkpoint import CheckpointManager
    from repro_torch.tree import flatten

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    out_dir = pathlib.Path(out_dir)
    res = {"rank": rank, "part_s": {}}
    t_part = time.perf_counter()

    def part(name):
        nonlocal t_part
        now = time.perf_counter()
        res["part_s"][name] = now - t_part
        t_part = now
    try:
        res["probe"] = _gloo_probe(torch, dist, rank, world)
        mesh = DeviceMesh("cuda", torch.arange(world).view(world, 1),
                          mesh_dim_names=("data", "model"))
        cfg, mcfg = train_mesh_cfgs()
        ocfg = train_mesh_opt(torch)
        data = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_MESH["seq_len"],
                           batch=TRAIN_MESH["batch"], seed=0)
        step, p_sh, _ = train.build(cfg, ocfg, TrainOptions(), mesh)
        tm = p_sh.tm
        params = fsdp.shard_tree(get_model(cfg, "cuda").init(
            torch.Generator(device="cuda").manual_seed(0)), p_sh)
        opt = adamw_init(params, ocfg)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        part("start")
        with CountedCollectives() as coll:
            params, opt, losses, norms, walls = run_steps(
                torch, step, params, opt, data, TRAIN_MESH["rank_steps"])
        part("steps")
        res.update(losses=losses, grad_norms=norms, step_ms=walls,
                   collectives_per_step={
                       k: v / TRAIN_MESH["rank_steps"]
                       for k, v in coll.counts.items()},
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                   block_gb=sum(t.numel() * t.element_size()
                                for t in flatten(params) + flatten(opt))
                   / 1e9)
        del opt
        sh = fsdp.StateSharding(tm, {"params": p_sh.specs},
                                {"params": p_sh.shapes})
        cm = CheckpointManager(out_dir / "ckpt", shardings=sh)
        t0 = time.perf_counter()
        cm.save(TRAIN_MESH["rank_steps"], {"params": params},
                blocking=False)
        res["save_caller_s"] = time.perf_counter() - t0
        cm.wait()
        res["save_s"] = time.perf_counter() - t0
        res["fingerprints"] = [fingerprint(torch, t)
                               for t in flatten({"params": params})]
        part("save")
        del params
        gc.collect()
        torch.cuda.empty_cache()

        # mixtral's MoE layer through the all-to-all
        lp = moe.init_moe(mcfg, torch.Generator(device="cuda").manual_seed(0),
                          "cuda")
        x2 = moe_tokens(torch, mcfg, lp["router"])
        rows = x2.chunk(tm.n_fsdp)[tm.fsdp_index]
        with torch.no_grad():
            with activation_sharding(tm), moe.record_drops() as drops, \
                    CountedCollectives() as coll:
                ep = moe.moe_apply(lp, rows, mcfg)
            with moe.record_drops() as plain_drops:
                plain = moe._moe_ep_plain(lp, x2, mcfg, tm.n_fsdp)
            exact = moe_vs_exact(torch, moe, lp, rows, mcfg, ep, drops)
        mine = plain.chunk(tm.n_fsdp)[tm.fsdp_index]
        res["moe"] = {
            "ep_vs_plain_bf16_ulps": bf16_ulps(ep, mine),
            "drops_equal": [d.tolist() for d in drops]
            == [plain_drops[tm.fsdp_index].tolist()],
            "pairs": rows.shape[0] * mcfg.moe.top_k,
            "vs_exact": exact, "collectives": coll.counts}
        part("moe")
        (out_dir / f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def train_mesh_two_rank_phase(torch, log, mesh, d, step1):
    """20(b): a 2x1 mesh as two processes on the one card over gloo
    (``_train_mesh_rank_worker``): gates every probed collective taken;
    both ranks' loss and norm equal, and within ``TRAIN_MESH_RTOL`` of
    ``step1``'s (20(a)'s unplaced step 0 on the same params and global
    batch); mixtral's MoE rows through the all-to-all within 2 bf16 ulps
    of the plain EP version over 2 virtual shards (the owner's products
    take both shards' rows in one product) with the same dropped pairs,
    and through ``moe_vs_exact``.  Then restores the params the ranks
    saved from 2x1 here, on the 1x1 mesh, gates each rank's 2x1 blocks of
    them bit-equal to the blocks the rank held (exact fingerprints), and
    holds them against ``step1``'s params: within one bf16 ulp plus 2^-6
    of the learning rate (the update's bf16 moments) of each other,
    except at most ``TRAIN_MESH_FLIP_SHARE`` of them moved by a sign
    flip of Adam's first update (at most 2 lr more), and none further."""
    import torch.multiprocessing as mp
    from repro_torch.launch import train
    from repro_torch.launch.steps import TrainOptions
    from repro_torch.models.model_zoo import get_model
    from repro_torch.optim import adamw_init
    from repro_torch.parallel import fsdp
    from repro_torch.parallel.sharding import local_shard, param_shardings
    from repro_torch.runtime.checkpoint import CheckpointManager
    from repro_torch.tree import flatten, unflatten

    t0 = time.perf_counter()
    ctx = mp.start_processes(_train_mesh_rank_worker,
                             args=(2, f"{d}/store", str(d)), nprocs=2,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + TRAIN_MESH_DEADLINE_S
    try:
        while not ctx.join(timeout=5):
            check(time.monotonic() < deadline,
                  f"20(b): two ranks still running after "
                  f"{TRAIN_MESH_DEADLINE_S}s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)
    ranks_s = time.perf_counter() - t0
    ranks = [json.loads((d / f"rank{r}.json").read_text()) for r in range(2)]
    refused = {k: v for k, v in ranks[0]["probe"].items() if v != "ok"}
    check(not refused, f"20(b): gloo refused on CUDA tensors: {refused}")
    check(ranks[0]["losses"] == ranks[1]["losses"]
          and ranks[0]["grad_norms"] == ranks[1]["grad_norms"],
          f"20(b): the ranks' losses {ranks[0]['losses']} / "
          f"{ranks[1]['losses']} or norms differ")
    vs_1x1 = {k: abs(ranks[0][many][0] - step1[k]) / abs(step1[k])
              for k, many in (("loss", "losses"),
                              ("grad_norm", "grad_norms"))}
    check(max(vs_1x1.values()) <= TRAIN_MESH_RTOL,
          f"20(b): step 0 on 2x1 against 20(a)'s unplaced step 0, "
          f"relative differences {vs_1x1} (bound {TRAIN_MESH_RTOL})")
    for r, res in enumerate(ranks):
        m = res["moe"]
        check(m["ep_vs_plain_bf16_ulps"] <= 2 and m["drops_equal"]
              and m["collectives"]["all_to_all_single"] == 2
              and m["vs_exact"]["drops_match_rule"]
              and m["vs_exact"]["worst_over_tol"] <= 1.0
              and m["vs_exact"]["dropped_pairs"] > 0,
              f"20(b) rank {r}: EP vs plain and exact {m}")
    # the params saved from 2x1, restored on the 1x1 mesh
    cfg, _ = train_mesh_cfgs()
    ocfg = train_mesh_opt(torch)
    _, p_sh, _ = train.build(cfg, ocfg, TrainOptions(), mesh)
    sh = fsdp.StateSharding(p_sh.tm, {"params": p_sh.specs},
                            {"params": p_sh.shapes})
    fake, _ = fsdp.shapes_of(get_model(cfg, "cuda"),
                             lambda p: adamw_init(p, ocfg))
    shapes = {"params": fake}
    like = unflatten(shapes, [
        torch.empty_strided(t.shape, (0,) * t.dim(), dtype=t.dtype,
                            device="cuda") for t in flatten(shapes)])
    t0 = time.perf_counter()
    state, manifest = CheckpointManager(d / "ckpt").restore(like,
                                                            shardings=sh)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    # every rank's blocks of the restored params, by the 2x1 specs,
    # against the blocks the rank held: equal bits block by block are
    # equal bits of the whole
    mesh21 = {"data": 2, "model": 1}
    specs21 = flatten({"params": param_shardings(mesh21, state["params"])})
    equal = 0
    for r, res in enumerate(ranks):
        got = [fingerprint(torch, local_shard(t, spec, mesh21,
                                              {"data": r, "model": 0}))
               for t, spec in zip(flatten(state), specs21)]
        equal += sum(a == b for a, b in zip(got, res["fingerprints"]))
    n_blocks = 2 * len(specs21)
    check(manifest["step"] == TRAIN_MESH["rank_steps"] and equal == n_blocks,
          f"20(b): the params restored on 1x1 are not the ranks' params "
          f"({equal} of {n_blocks} blocks bit-equal)")
    # the 2x1 params after step 0 (the restored ones, bit-equal to the
    # ranks') against (a)'s unplaced ones
    lr = TRAIN_MESH["lr"]
    flips, beyond, moved, total = 0, 0, 0, 0
    for a, b in zip(flatten(state["params"]), step1["params"]):
        a, b = a.float(), b.to(a.device).float()
        diff = (a - b).abs()
        mag = torch.maximum(a.abs(), b.abs()).clamp_min(2.0 ** -126)
        ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        close = diff <= ulp + 2.0 ** -6 * lr
        flip = ~close & (diff <= ulp + 2.02 * lr)
        flips += int(flip.sum())
        beyond += int((~close & ~flip).sum())
        moved += int((diff > 0).sum())
        total += diff.numel()
    pv = {"flips": flips, "flip_share": flips / total, "beyond": beyond,
          "elements_differing": moved, "elements": total}
    check(beyond == 0 and flips <= TRAIN_MESH_FLIP_SHARE * total,
          f"20(b): the 2x1 params vs 20(a)'s: {pv}")
    nbytes = sum(t.numel() * t.element_size() for t in flatten(state))
    del state, like
    gc.collect()
    torch.cuda.empty_cache()
    out = {"ranks": [{k: v for k, v in r.items() if k != "fingerprints"}
                     for r in ranks],
           "restore_1x1_s": restore_s, "checkpoint_gb": nbytes / 1e9,
           "blocks_bit_equal": equal, "step0_vs_1x1_rel": vs_1x1,
           "params_vs_1x1": pv, "ranks_s": ranks_s}
    log(f"  (b) 2x1 over gloo: loss {ranks[0]['losses']} (vs 1x1 "
        f"{vs_1x1}); step {[p50(r['step_ms']) for r in ranks]} ms a rank; "
        f"collectives a step {ranks[0]['collectives_per_step']}; peak "
        f"{[round(r['peak_mem_gb'], 2) for r in ranks]} GB; params "
        f"{pv['flip_share']:.2e} flipped; save {ranks[0]['save_s']:.1f}s, "
        f"restore on 1x1 {restore_s:.1f}s of {nbytes / 1e9:.2f} GB; EP vs "
        f"plain {[r['moe']['ep_vs_plain_bf16_ulps'] for r in ranks]} ulps, "
        f"vs exact "
        f"{[round(r['moe']['vs_exact']['worst_over_tol'], 3) for r in ranks]}"
        f" of the bound; the ranks {ranks_s:.1f}s "
        f"{json.dumps(ranks[0]['part_s'])}")
    return out


def train_mesh_phase(torch, log, mesh):
    """Phase 20: (a) then (b), in a temporary directory removed
    afterwards."""
    import tempfile
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as d:
        d = pathlib.Path(d)
        t0 = time.perf_counter()
        a, step1 = train_mesh_1x1_phase(torch, log, mesh)
        ta = time.perf_counter() - t0
        b = train_mesh_two_rank_phase(torch, log, mesh, d, step1)
        del step1
    return {"a_1x1": a, "b_2x1": b,
            "seconds": {"20a": ta, "20b": time.perf_counter() - t0 - ta}}


def mesh_entries(cases) -> dict:
    """Phase 17(b)'s shard cases of one kernel for its kernels-line entry:
    their sums for each mesh, as ``case_sums`` gives them."""
    return {f"1x{m}": dict(case_sums(part), cases=len(part))
            for m in MESH_SHARDS
            if (part := [c for c in cases
                         if f"1x{m}" in str(c.get("mesh"))])}


# ------------------------------------------------ phase 21: the dry run
def dryrun_cli_start(out_dir) -> list:
    """21(b): ``python -m repro_torch.launch.dryrun --no-probe`` on each of
    ``DRYRUN_CELLS``, started together as subprocesses (fake tensors on
    the host: they run beside (a) and (c)); returns (cell, process, start
    time, log path)."""
    # fake tensors compute nothing: one intra-op thread a process
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for arch, shape, extra in DRYRUN_CELLS:
        log_path = out_dir / f"{arch}__{shape}{''.join(extra)}.log"
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--no-probe", "--out", str(out_dir),
               *extra]
        fh = open(log_path, "w")
        procs.append(((arch, shape, extra), subprocess.Popen(
            cmd, cwd=ROOT, env=env, stdout=fh, stderr=subprocess.STDOUT),
            time.perf_counter(), log_path, fh))
    return procs


def dryrun_cli_finish(procs, out_dir, log, smi) -> dict:
    """21(b): wait for the cells, gate their exit codes and ``status ==
    "ok"``, and report a rank's argument and temp GiB, FLOPs, collective
    MiB by kind and whether argument + temp fits the card (a finding, not
    a gate)."""
    res = {}
    for (arch, shape, extra), proc, t0, log_path, fh in procs:
        try:
            rc = proc.wait(timeout=max(1.0, DRYRUN_CELL_TIMEOUT_S
                                       - (time.perf_counter() - t0)))
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            fh.close()
        tail = log_path.read_text()[-2000:]
        tag = "pod16x16" + ("_sparse" if "--sparse" in extra else "")
        check(rc == 0, f"dryrun {arch} x {shape} x {tag}: rc {rc}\n{tail}")
        rec = json.loads((out_dir / f"{arch}__{shape}__{tag}.json"
                          ).read_text())
        check(rec["status"] == "ok",
              f"dryrun {arch} x {shape} x {tag}: {rec.get('error')}\n"
              f"{rec.get('traceback', '')}")
        full, mem = rec["full"], rec["full"]["memory"]
        need = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
        cell = {"wall_s": time.perf_counter() - t0,
                "argument_gib": mem["argument_size_in_bytes"] / 2 ** 30,
                "temp_gib": mem["temp_size_in_bytes"] / 2 ** 30,
                "flops": full["flops"],
                "bytes_accessed": full["bytes_accessed"],
                "collective_mib": {k: v / 2 ** 20 for k, v in
                                   full["collective_bytes"].items()},
                "collective_counts": full["collective_counts"],
                "kernel_launches": full["kernel_launches"],
                "run_s": full["compile_s"],
                "placement": rec.get("placement"),
                "fits_80gb": need <= DEVICE_GB * 1e9}
        res[f"{arch}__{shape}__{tag}"] = cell
        log(f"  (b) {arch} x {shape} x {tag}, rank 0 of 256: args "
            f"{cell['argument_gib']:.2f} GiB, temp {cell['temp_gib']:.2f} "
            f"GiB ({'fits' if cell['fits_80gb'] else 'does not fit'} "
            f"{DEVICE_GB} GB), {cell['flops']:.4g} FLOPs, collectives "
            f"{json.dumps({k: round(v, 2) for k, v in cell['collective_mib'].items()})}"
            f" MiB, {cell['wall_s']:.1f}s ({smi})")
    return res


def dryrun_step_gate(torch, log, cfg, params, kind, B, S) -> dict:
    """21(a) for one step: the dry run's record of the step (its inputs
    from ``dryrun.build_step``, fake CUDA tensors) against the step run on
    the card on ``params``: FLOPs (``FlopCounterMode`` plus the kernels'
    recorded FLOPs), kernel launches by plan against the wrappers'
    counters, argument bytes against the real inputs', all exact; the
    peak (argument + temp) against the real inputs' bytes plus the rise of
    ``max_memory_allocated`` over the step, within ``DRYRUN_PEAK_BAND``."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.hlo_analysis import nbytes, record_step

    shape = ShapeConfig(f"{kind}_{B}x{S}", S, B, kind)
    t0 = time.perf_counter()
    built = dryrun.build_step(cfg, shape, None, sparse=True, device="cuda")
    build_s = time.perf_counter() - t0
    with built.mode:
        rec = record_step(built.step, built.args, donated=built.donated)
    dry_s = time.perf_counter() - t0
    g = torch.Generator(device="cuda").manual_seed(21)
    if kind == "prefill":
        step = steps.make_prefill_step(cfg)
        tokens = torch.randint(0, cfg.vocab, (B, S), generator=g,
                               dtype=torch.int32, device="cuda")
        args = (params, {"tokens": tokens})
    else:
        step = steps.make_decode_step(cfg)
        kv = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.hd)
        caches = {"k": torch.zeros(kv, dtype=cfg.dtype, device="cuda"),
                  "v": torch.zeros(kv, dtype=cfg.dtype, device="cuda"),
                  "pos": S - 1}
        tokens = torch.randint(0, cfg.vocab, (B, 1), generator=g,
                               dtype=torch.int32, device="cuda")
        args = (params, caches, {"tokens": tokens})
    real_arg = nbytes(args)
    out = step(*args)                  # warm: first-call workspaces
    del out
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_launches()
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as counter:
        out = step(*args)
    torch.cuda.synchronize()
    real_s = time.perf_counter() - t0
    launches = read_launches()
    rise = torch.cuda.max_memory_allocated() - base
    check(bool(torch.isfinite(out[0].float()).all()),
          f"21(a) {kind}: non-finite logits")
    del out, args
    real_by_plan = {k: v for k, v in launches.items()
                    if v and re.search(r"_(decode|prefill)(_int8)?$", k)}
    dry_by_plan = rec.launches_by_plan()
    kernel_flops = sum(k.flops for k in rec.kernel_launches)
    aten_real = int(counter.get_total_flops())
    check(rec.flops == aten_real + kernel_flops,
          f"21(a) {kind}: dry FLOPs {rec.flops} != FlopCounterMode "
          f"{aten_real} + kernels {kernel_flops}")
    check(dry_by_plan == real_by_plan,
          f"21(a) {kind}: launches by plan, dry {dry_by_plan} != card "
          f"{real_by_plan}")
    check(built.argument_bytes == real_arg,
          f"21(a) {kind}: dry argument bytes {built.argument_bytes} != "
          f"the real inputs' {real_arg}")
    dry_peak = built.argument_bytes + rec.temp_bytes
    real_peak = real_arg + rise
    band = DRYRUN_PEAK_BAND["abs_bytes"] + DRYRUN_PEAK_BAND["rel"] * real_peak
    check(abs(dry_peak - real_peak) <= band,
          f"21(a) {kind}: dry argument + temp {dry_peak} vs the card's "
          f"{real_peak}: {abs(dry_peak - real_peak)} apart > {band:.0f}")
    res = {"batch": B, "seq": S, "flops": rec.flops, "aten_flops": aten_real,
           "kernel_flops": kernel_flops, "launches_by_plan": dry_by_plan,
           "argument_bytes": real_arg, "temp_bytes": rec.temp_bytes,
           "real_rise_bytes": rise, "peak_dry_bytes": dry_peak,
           "peak_real_bytes": real_peak,
           "peak_rel_diff": (dry_peak - real_peak) / real_peak,
           "bytes_accessed": rec.bytes_accessed, "dry_build_s": build_s,
           "dry_s": dry_s, "real_s": real_s}
    log(f"  (a) {kind} {B}x{S}: FLOPs {rec.flops:.6g} (aten {aten_real:.6g} "
        f"+ kernels {kernel_flops:.6g}) equal; launches {dry_by_plan} "
        f"equal; args {real_arg / 1e9:.3f} GB equal; peak dry "
        f"{dry_peak / 1e9:.3f} GB vs card {real_peak / 1e9:.3f} GB "
        f"({res['peak_rel_diff']:+.4%}); dry {dry_s:.1f}s (build "
        f"{build_s:.1f}s), card {real_s:.2f}s")
    return res


def dryrun_real_phase(torch, log, cfg, params, smi) -> dict:
    """21(a): both steps of ``DRYRUN_STEPS`` on phase 4's params, and the
    plans' SM count against the card's."""
    from repro_torch.kernels.common import H100_SM_COUNT
    check(H100_SM_COUNT == sm_count(torch),
          f"kernels.common.H100_SM_COUNT {H100_SM_COUNT} != the card's "
          f"{sm_count(torch)} SMs")
    out = {"device": smi, "sm_count": H100_SM_COUNT}
    for kind, B, S in DRYRUN_STEPS:
        out[kind] = dryrun_step_gate(torch, log, cfg, params, kind, B, S)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def examples_phase(torch, log, smi) -> dict:
    """21(c): ``examples/torch/quickstart.py`` on the card, its fused
    kernel's error gated at phase 2's bound (``KERNEL_TOL_REL`` of the
    largest output), and ``examples/torch/serve_sparse.py --arch
    llama-paper``, which must finish; the two run side by side."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / "torch" / f"{name}.py"),
         *argv], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for name, argv in (("quickstart", []),
                           ("serve_sparse", ["--arch", "llama-paper"]))}
    res = {}
    for name, p in procs.items():
        try:
            out, err = p.communicate(timeout=300)
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
        check(p.returncode == 0, f"examples/torch/{name}.py: rc "
              f"{p.returncode}\n{out[-1500:]}\n{err[-1500:]}")
        res[name] = {"wall_s": time.perf_counter() - t0,
                     "stdout": out.strip().splitlines()}
    text = "\n".join(res["quickstart"]["stdout"])
    m = re.search(r"fused kernel error: (\S+) of max\|y\| (\S+) .*cuda", text)
    check(m is not None, f"quickstart: no kernel line on the card\n{text}")
    err, scale = float(m.group(1)), float(m.group(2))
    check(err <= KERNEL_TOL_REL * scale,
          f"quickstart: fused kernel error {err:.3e} > {KERNEL_TOL_REL} x "
          f"{scale:.3e}")
    res["quickstart"].update(kernel_err=err, kernel_scale=scale,
                             tol=KERNEL_TOL_REL * scale)
    check(any(ln.startswith("sample:") for ln in res["serve_sparse"]["stdout"]),
          "serve_sparse: no sample line")
    log(f"  (c) quickstart: kernel error {err:.3e} of {scale:.3e} (tol "
        f"{KERNEL_TOL_REL * scale:.3e}); serve_sparse --arch llama-paper "
        f"finished; both in {time.perf_counter() - t0:.1f}s ({smi})")
    return res


def main() -> int:
    import torch

    def log(msg):
        print(msg, flush=True)

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              f"from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False   # plain f32 stays f32
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    walls = {}

    def timed(key, fn, *args, **kw):
        """``fn(*args, **kw)``, its wall under ``walls[key]``."""
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        walls[key] = walls.get(key, 0.0) + time.perf_counter() - t0
        return out

    smi = nvidia_smi_line()
    log(f"device: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    lib = build.build(verbose=True)
    build.library()
    walls["1_build"] = time.perf_counter() - t0
    log(f"phase 1 build: {lib.relative_to(ROOT)} in {walls['1_build']:.1f}s")
    resources = timed("1_resources", resource_usage, lib, log)

    timer = Timer(torch)
    log("phase 2 weight kernels vs plain versions (bf16 and int8 values, L2 "
        "flushed per call)")
    cases = timed("2", kernel_phase, torch, timer, log)
    log("phase 2 sweep: decode kernel vs prefill kernel (and the old tile "
        "kernel) of fused_sparse_linear and nm_spmm, w_gate and w_down")
    sweep = timed("2_sweep", sweep_phase, torch, timer, log)
    log("phase 2 sweep: outlier_spmm's decode body vs prefill body (and the "
        "old kernel), w_gate and w_down, 16:256 and 4:256")
    sweep["outlier_spmm"] = timed("2_sweep_outlier", outlier_sweep_phase,
                                  torch, timer, log)
    log("phase 2b paged_attention vs plain version (bf16 and int8 arenas, L2 "
        "flushed)")
    attn_cases, attn_cases8 = timed("2b", paged_attention_phase, torch,
                                    timer, log)
    log("phase 2b paged_attention at hd 256 (gemma-7b), 192 "
        "(nemotron-4-340b), 80 (zamba2-2.7b) and 128 at H 40 / KV 8 "
        "(llama4-maverick) vs plain version (bf16 and int8 arenas)")
    hd_cases, hd_cases8 = timed("2b_hd", paged_attention_hd_phase, torch,
                                timer, log)
    attn_cases += hd_cases
    attn_cases8 += hd_cases8
    log("phase 2b sweep: paged_attention's decode body vs prefill-chunk "
        "body, bf16 and int8 arenas, S 1..64 over the decode case's lanes")
    sweep["paged_attention"] = timed("2b_sweep", attention_sweep_phase,
                                     torch, timer, log)
    del timer
    log("phase 3 small-model reference check")
    small = timed("3", small_model_phase, torch, log)
    log("phase 4 serve llama3-8b, 32 layers, 8:16+16:256")
    cfg, params, build_info = timed("4", build_model, torch, log)
    main_serve, slot_streams, main_launches = timed(
        "4", serve_phase, torch, log, cfg, params, build_info)
    log("phase 5 serve llama3-8b, 4 layers, plain 8:16")
    cfg5, params5, build5 = timed("5", build_model, torch, log, n_layers=4,
                                  outlier=None)
    plain_serve, _, plain_launches = timed(
        "5", serve_phase, torch, log, cfg5, params5, build5,
        prompt_lens=PLAIN_PROMPT_LENS, gen=PLAIN_GEN, alone=False)
    del params5
    log("phase 5 (int8) serve llama3-8b, 4 layers, plain 8:16, int8 values")
    cfg5, params5, build5 = timed("5_int8", build_model, torch, log,
                                  n_layers=4, outlier=None, quantize=True)
    plain_serve8, _, plain_launches8 = timed(
        "5_int8", serve_phase, torch, log, cfg5, params5, build5,
        prompt_lens=PLAIN_PROMPT_LENS, gen=PLAIN_GEN, alone=False)
    del params5
    log("phase 6 serve llama3-8b, 32 layers, 8:16+16:256, paged layout")
    paged_serve, paged_launches, paged_streams = timed(
        "6", paged_serve_phase, torch, log, cfg, params, slot_streams)
    log("phase 9 replay a Poisson trace through launch/serve.run_trace, "
        "untraced and traced (phase 4's params, phase 6(a)'s engine)")
    replay = timed("9", trace_phase, torch, log, cfg, params)
    log("phase 11 speculative decoding on llama3-8b: (a) phase 4's params "
        "draft for their densification, (b) n-gram on phase 4's target, "
        "(c) the CLI's --draft sparse at 4 layers")
    speculative, spec_launches = timed("11", spec_phase, torch, log, cfg,
                                       params)
    log("phase 12 the fleet on llama3-8b (phase 4's params): a 32-request "
        "tenant trace through 1 replica, 2 round-robin, 2 prefix-routed, "
        "2 stealing at threshold 1, each once from cold, and serve "
        "--replicas 2 --trace-out")
    fleet, fleet_launches = timed("12", fleet_phase, torch, log, cfg, params)
    log("phase 17(a) the serving mesh: phase 6(a)'s engine without a "
        "placement and on a 1x1 mesh (a world-size-1 NCCL group), phase "
        "4's params")
    from repro_torch.launch.mesh import make_serving_mesh
    mesh = make_serving_mesh("1x1", "cuda")
    mesh_a, mesh_launches = timed("17a_bf16", mesh_serve_phase, torch, log,
                                  cfg, params, mesh)
    log("phase 19(a) speculation on the 1x1 mesh: phase 11(c)'s serve "
        "--draft sparse (llama3-8b, 4 layers) with --mesh 1x1")
    mesh_spec, mesh_spec_launches = timed(
        "19a", mesh_spec_phase, torch, log, cfg, mesh,
        speculative["c_cli"])
    log("phase 21 the dry run: (a) phase 4's llama3-8b, a prefill step of "
        "8 x 512 and a decode step of 8 lanes over 4,096 positions, on the "
        "card and dry on fake CUDA tensors; (b) python -m "
        "repro_torch.launch.dryrun on qwen3-8b x train_4k and x decode_32k "
        "--sparse over 256 fake ranks, beside (a) and (c); (c) "
        "examples/torch/quickstart.py and serve_sparse.py on the card")
    t21 = time.perf_counter()
    dry_dir = ROOT / "chiprun_out" / "dryrun"
    dry_procs = dryrun_cli_start(dry_dir)
    dry_real = timed("21a", dryrun_real_phase, torch, log, cfg, params, smi)
    dry_examples = timed("21c", examples_phase, torch, log, smi)
    dry_cells = timed("21b_wait", dryrun_cli_finish, dry_procs, dry_dir, log,
                      smi)
    walls["21"] = time.perf_counter() - t21
    dryrun_21 = {"device": smi, "a_steps": dry_real, "b_cells": dry_cells,
                 "c_examples": dry_examples,
                 "seconds": {k: walls[k] for k in ("21", "21a", "21c",
                                                   "21b_wait")}}
    log(f"  phase 21: {walls['21']:.1f}s "
        f"{json.dumps(dryrun_21['seconds'])} ({smi})")
    del params
    torch.cuda.empty_cache()
    log("phase 7 serve llama3-8b, 32 layers, int8 8:16 + bf16 16:256, int8 "
        "paged KV")
    cfg, params, build_info8 = timed("7", build_model, torch, log,
                                     quantize=True)
    int8_serve, int8_launches = timed(
        "7", int8_serve_phase, torch, log, cfg, params, paged_streams,
        paged_serve["c_block_pressure"])
    for run in int8_serve.values():
        run.update(build_info8)
    log("phase 17(a) the serving mesh on int8 KV: phase 7(a)'s engine "
        "without a placement and on the 1x1 mesh, phase 7's params")
    mesh_a8, mesh_launches8 = timed("17a_int8", mesh_serve_phase, torch, log,
                                    cfg, params, mesh, kv_dtype="int8")
    del params
    torch.cuda.empty_cache()
    log("phase 13 the dense family at full width, 8:16+16:256: qwen3-8b "
        "(36 layers, paged then slot), gemma-7b (28 layers, hd 256, bf16 "
        "then int8 paged KV), nemotron-4-340b (2 of 96 layers, hd 192)")
    dense_family, family_launches = timed("13", family_phase, torch, log)
    log("phase 14 the recurrent families at full width, 8:16+16:256: "
        "xlstm-350m (12 of 24 layers; slot, then half the slots with swap "
        "preemptions), zamba2-2.7b (27 of 54 mamba layers, 4 shared-"
        "attention applications at hd 80; paged, then slot); with phase "
        "18(a): xlstm's slot and zamba2's paged serve again on the 1x1 mesh")
    recurrent, recurrent_launches = timed("14", recurrent_phase, torch, log,
                                          smi, mesh)
    gc.collect()
    torch.cuda.empty_cache()
    log("phase 15 the moe and encdec families, 8:16+16:256: mixtral-8x7b "
        "(8 of 32 layers; paged, then slot), llama4-maverick-400b-a17b (1 "
        "of 48 layers, paged), whisper-medium (24 + 24 layers, 1,500 "
        "encoder frames a request; slot, then half the slots with swap "
        "preemptions); with phase 18(a): mixtral's paged and whisper's "
        "slot serve again on the 1x1 mesh")
    moe_encdec, moe_encdec_launches = timed("15", moe_encdec_phase, torch,
                                            log, smi, mesh)
    # phase 18(a)'s share of phases 14 and 15
    walls["18a"] = sum(
        fam["mesh_1x1"]["seconds"]
        for fam in (recurrent["xlstm-350m"], recurrent["zamba2-2.7b"],
                    moe_encdec["mixtral-8x7b"], moe_encdec["whisper-medium"]))
    log("phase 8 the paper's pipeline on llama3-8b, 32 layers: calibrate, "
        "compress (RIA + SmoothQuant + VC), serve, ops, perplexity")
    pipeline, ops_cases, ops_launches = timed(
        "8", pipeline_phase, torch, log, paged_serve["a_phase4_traffic"])
    gc.collect()
    log("phase 10 train llama3-8b, 4 layers, full width: train_small_lm, "
        "make_train_step, EBFT to 8:16 and the packed forward")
    training, train_launches = timed("10", training_phase, torch, log)
    gc.collect()
    log("phase 16 the training driver and the one-shot loop: (a) "
        f"qwen2-vl-72b ({VLM_LAYERS} of 80 layers) served by run_oneshot, (b) "
        f"--legacy on llama3-8b (4 layers), (c) launch/train with a failure "
        f"and a resume ({DRIVER_ARCH}, {DRIVER_LAYERS} layer), (d) a train step "
        f"a family")
    slice_16, slice_launches = timed("16", slice_phase, torch, log, smi)
    walls.update(slice_16["seconds_by_part"])
    gc.collect()
    torch.cuda.empty_cache()
    log("phase 17(b) the shard shapes of one rank of a 1x2, 1x4 and 1x8 "
        "llama3-8b mesh: the fused kernel (bf16 and int8 values) and "
        "paged_attention (bf16 and int8 arenas) vs plain versions")
    timer = Timer(torch)
    shards = timed("17b", shard_phase, torch, timer, log)
    log("phase 18(b) the shard shapes of one rank of a 1x2, 1x4 and 1x8 "
        "mesh of xlstm-350m, zamba2-2.7b and whisper-medium (the fused "
        "kernel) and of zamba2's and mixtral's attention (paged_attention) "
        "vs plain versions")
    family_shards = timed("18b", family_shard_phase, torch, timer, log)
    del timer
    log("phase 17(c) a 1x2 mesh as two processes on the one card over "
        "gloo: llama3-8b, 4 layers, phase 6(a)'s traffic")
    two_ranks = timed("17c", two_rank_phase, torch, log)
    log("phase 18(c) a 1x2 mesh as two processes on the one card over "
        "gloo: xlstm-350m, zamba2-2.7b, mixtral-8x7b and whisper-medium, "
        "each cut to a layer of each kind")
    family_ranks = timed("18c", family_two_rank_phase, torch, log)
    log("phase 19(b) a fleet of 2 replicas of 1x1 as two processes on the "
        "one card: llama3-8b, 4 layers, phase 12(c)'s prefix-routed trace")
    mesh_fleet = timed("19b", mesh_fleet_phase, torch, log)
    log("phase 20 the training mesh: (a) llama3-8b (2 layers, batch 8 x "
        "128) 3 steps unplaced and on the 1x1 mesh, mixtral-8x7b (1 layer) "
        "on the capacity path; (b) a 2x1 mesh as two processes on the one "
        "card over gloo, its params' checkpoint restored here on 1x1")
    train_mesh = timed("20", train_mesh_phase, torch, log, mesh)
    walls.update(train_mesh["seconds"])
    log(f"  phase 20: {walls['20']:.1f}s "
        f"{json.dumps(train_mesh['seconds'])} ({smi})")
    import torch.distributed as dist
    dist.destroy_process_group()
    mesh_seconds = {k: walls[k] for k in ("17a_bf16", "17a_int8", "17b",
                                          "17c")}
    mesh17 = {"device": smi, "a_bf16": mesh_a, "a_int8": mesh_a8,
              "b_shards": shards, "c_two_ranks": two_ranks,
              "seconds": mesh_seconds}
    mesh18 = {"device": smi,
              "a_1x1": {arch: fam["mesh_1x1"] for arch, fam in (
                  ("xlstm-350m", recurrent["xlstm-350m"]),
                  ("zamba2-2.7b", recurrent["zamba2-2.7b"]),
                  ("mixtral-8x7b", moe_encdec["mixtral-8x7b"]),
                  ("whisper-medium", moe_encdec["whisper-medium"]))},
              "b_shards": family_shards, "c_two_ranks": family_ranks,
              "seconds": {k: walls[k] for k in ("18a", "18b", "18c")}}
    mesh19 = {"device": smi, "a_speculation_1x1": mesh_spec,
              "b_fleet_two_processes": mesh_fleet,
              "seconds": {k: walls[k] for k in ("19a", "19b")}}
    log(f"  phase 19: {sum(mesh19['seconds'].values()):.1f}s "
        f"{json.dumps(mesh19['seconds'])} ({smi})")
    log(f"  phase 17: {sum(mesh_seconds.values()):.1f}s "
        f"{json.dumps(mesh_seconds)}; phase 18: "
        f"{sum(mesh18['seconds'].values()):.1f}s "
        f"{json.dumps(mesh18['seconds'])} ({smi})")
    # nm_spmm's main-path launches: phase 5's serve, phase 10(c)'s packed
    # forwards and phase 16(a)'s one-shot loop (qwen2-vl's down projection)
    nm_launches = {k: n + train_launches.get(k, 0)
                   + slice_launches.get(k, 0)
                   for k, n in plain_launches.items()}

    # the fused kernel's and paged attention's main-path launches: phase 4's
    # and phase 6(a)'s serves, each with phase 11's, phase 12's, 13's, 14's
    # (zamba2-2.7b's paged serve: the hd 80 bodies), 15's and 16's (the
    # one-shot loops and --legacy's engine; no paged attention)
    main_launches = add_launches(main_launches, spec_launches, fleet_launches,
                                 family_launches, recurrent_launches,
                                 moe_encdec_launches, slice_launches,
                                 mesh_launches, mesh_spec_launches)
    paged_launches = add_launches(paged_launches, spec_launches,
                                  fleet_launches, family_launches,
                                  recurrent_launches, moe_encdec_launches,
                                  mesh_launches, mesh_spec_launches)
    # phase 13's int8 KV serve (gemma-7b) and phase 17(a)'s int8 pair join
    # the int8 variants'
    int8_launches = add_launches(int8_launches, family_launches,
                                 mesh_launches8)

    kernels = {"kernels": [
        kernel_entry("fused_sparse_linear", cases["fused_sparse_linear"],
                     main_launches["fused_sparse_linear"],
                     paths(main_launches, "fused_sparse_linear")),
        kernel_entry("nm_spmm", cases["nm_spmm"], nm_launches["nm_spmm"],
                     paths(nm_launches, "nm_spmm")),
        kernel_entry("paged_attention", attn_cases,
                     paged_launches["paged_attention"],
                     paths(paged_launches, "paged_attention"),
                     by_hd={80: recurrent_launches}),
        kernel_entry("fused_sparse_linear_int8",
                     cases["fused_sparse_linear_int8"],
                     int8_launches["fused_sparse_linear_int8"],
                     paths(int8_launches, "fused_sparse_linear_int8")),
        kernel_entry("nm_spmm_int8", cases["nm_spmm_int8"],
                     plain_launches8["nm_spmm_int8"],
                     paths(plain_launches8, "nm_spmm_int8")),
        kernel_entry("paged_attention_int8", attn_cases8,
                     int8_launches["paged_attention_int8"],
                     paths(int8_launches, "paged_attention_int8"),
                     by_hd={80: recurrent_launches}),
        kernel_entry("outlier_spmm", ops_cases,
                     ops_launches["outlier_spmm"],
                     {path: ops_launches[f"outlier_spmm_{path}"]
                      for path in ("decode", "prefill")})]}
    for entry in kernels["kernels"]:
        if entry["name"] in shards:
            entry["mesh_shards"] = mesh_entries(shards[entry["name"]])
        if entry["name"] in family_shards:
            entry["family_mesh_shards"] = mesh_entries(
                family_shards[entry["name"]])
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    serves = {"serve": main_serve, "serve_plain_nm": plain_serve,
              "serve_plain_nm_int8": plain_serve8, "serve_paged": paged_serve,
              "serve_int8_paged": int8_serve, "pipeline": pipeline,
              "replay": replay, "speculative": speculative, "fleet": fleet,
              "dense_family": dense_family, "recurrent": recurrent,
              "moe_encdec": moe_encdec,
              "training": training, "slice": slice_16, "mesh": mesh17,
              "mesh_families": mesh18, "mesh_spec_fleet": mesh19,
              "train_mesh": {"device": smi, **train_mesh},
              "dryrun": dryrun_21}
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"device": smi, "seconds": time.perf_counter() - t_start,
         "phase_seconds": walls,
         "kernels": kernels["kernels"], "resources": resources,
         "sweep": sweep, "small_model": small, **serves},
        indent=1))
    print(json.dumps(serves))
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
