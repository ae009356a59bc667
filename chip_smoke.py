#!/usr/bin/env python3
"""Run the PyTorch port's one-image chat path (unpacked and packed gq codes),
its speculative decoding paths, its batched HTTP serving paths (window groups; continuous batching with
parked sessions and the radix prefix cache), its quantized-container / repacked-weight
path, its w8a8 path over an e4m3 cache, its tensor-parallel path (two ranks
on one card), its dequant-matmul probes, its clients (context shift,
chat checkpoints, the C ABI library under examples/main.c and ctypes), the
kernel gate, the benchmark's synthetic 13B teacher with its distilled
draft head, and the benchmark's timing half with the kernel floors on an
NVIDIA GPU.

Usage, from the root of a checkout:  python3 chip_smoke.py
(--only-serving, --only-clients, --only-speculative, --only-train, --only-tp,
--only-synthetic, --only-bench, --only-kernels SECTIONS: one phase alone,
no result line)

Phases (any failure exits nonzero before the last line):
  1. device  - needs torch.cuda; prints the card's name and power limit,
               torch and CUDA versions; turns TF32 off.
  2. build   - compiles minigpt4_tpu_torch/csrc/*.cu with nvcc (sm_90a).
  3. kernels - each hand-written kernel against its plain PyTorch version on
               the card at the shapes of the main paths: the exact-plane
               kernels and flash decode at Vicuna-7B shapes, the generic-plane
               kernels at Vicuna-13B shapes (q6_k planes, group 16; q8_0,
               group 32, signed codes), and the paged flash-decode kernel at
               Vicuna-13B serving shapes (8 lanes, 40 heads of 128, bf16 pools
               of 64 + 1 pages, 4 + 1 table slots, shuffled pages, one lane
               past its capacity), and the repacked-weight kernels (rq_decode,
               rq_prefill) against the f32 plain version qmatmul_repacked_ref
               at the shapes of their paths: ViT-G fc2 q5_k 1408x6144, fc1
               q5_1 6144x1408 and qkv q8_0 4224x1408 at M=257 (39 stacked
               blocks), the Q-Former intermediate q5_k 3072x768 at M=32, the
               13B w13 q5_k 27648x5120 at M=1 and 512 (40 layers) and the 13B
               q6_k output 32000x5120 at M=1, with the exact-plane gq kernels
               beside them at the w13 and fc2 shapes: max error, tolerance,
               median times (CUDA events, turns plain, kernel, kernel, plain),
               each kernel's bound (the larger of its bytes at 3.35 TB/s and
               its operations at the H100's peak for their type) and, for the
               attention kernels, the time of torch's
               scaled_dot_product_attention with a boolean mask on the same
               (gathered) cache; the paged kernel must give the dense kernel's
               bits on the gathered cache.  Last, the gq entries on packed
               codes at PACKED_CASES (the packed chats' shapes and row
               counts): each weight packed by group_i8.pack_codes must give
               the bits of its unpacked codes (max |d| = 0) and sit within
               the gq tolerances of the plain version; packed and unpacked
               are timed in turns, with the bound of the packed bytes and of
               the unpacked ones, and the wrappers' host time per decode call.
               Last, flash decode's stats mode (the partials of sequence-
               parallel attention) at 13B attention shapes (40 heads of 128,
               a bf16 cache of 2048 positions in 4 slices of 512; S = 1 and 8
               at pos0 = 700, where two slices are empty, and 2015; one e4m3
               case): each slice against flash_decode_stats_ref, the
               normalized launch bit-equal to acc / l, the merged slices
               within 2e-5 of the kernel on the whole cache, and per slice
               the stats, normalized, plain and SDPA times and the bound.
  4. engine  - four chats through MiniGPT4Engine(device="cuda"), each on
               synthetic files cached under build/smoke_models/ by geometry,
               layout and seed, one engine closed before the next is built:
               a. Vicuna-13B at full width and depth in llama.cpp's Q5_K_M
                  layout (q6_k output, q6_k wv/w2 on 20 of 40 layers, q5_k
                  elsewhere) with a 13B f16 ViT-G + Q-Former container;
               a'. the same files with quant_mode="gq": the codes packed (p5
                  q5_k, p6 q6_k); the greedy ids must equal a's, and the
                  memory each load allocated is printed; a and a' stay
                  loaded for a decode A/B, 16-token chunks in turns a, a',
                  a', a (three times);
               b. Vicuna-7B width, every projection q5_k, depth cut to 8
                  layers, with a 7B f16 container;
               b'. Vicuna-7B width, depth 8, wq/wk/wv/w1/w3 q4_k, wo q5_1, w2
                  q4_0, output q6_k, quant_mode="gq" (a synthetic mix that
                  reaches the packed entries a' does not), with the 7B f16
                  container.
               Each: encode_image, system_prompt, begin_chat_image, a greedy
               generate(limit=32), a timed 16-token decode chunk, a
               16-token chunk under torch.profiler (device busy time, idle
               share, the kernels with the most device time), a sampled
               second turn, then the system prompt and image turn once more
               from position 0 under torch.profiler (wall, device busy, idle
               share, the quantized prefill kernels' device time: the
               prefill's part of time to first token).  The launch counts are set to 0 just before each
               chat and read just after: the 13B chat must launch the five
               kernels of the chat path, the 7B chat the three exact-plane and
               flash kernels, and neither a packed entry; a' the packed p5 and
               p6 entries and b' the other six, and neither an unpacked gq
               entry.
  4''. speculative - (inside a and a', on a's loaded engine, warmed up,
               then its speculative dispatches captured by warmup at k = 8;
               every stream through generate) a. greedy n-gram drafts at
                  k = 8 on the image turn, 64 ids: the plain captured
                  chunks, the speculative stream eager (32 ids), then two
                  captured runs, the second all replays (graph keys
                  ("spec", 1, passes, 8, None) in graph_stats); tok/s of
                  each, tokens per pass, the launches of flash decode at
                  S = 8 (= layers x passes) and gq at M = 8; b. sampled
                  n-gram speculation (temp 0.8, top-k 40), 32 ids eager and
                  twice captured from the generator seeded alike: equal
                  ids, a ("spec_stoch", ...) graph replayed, tokens per
                  pass and the residual ban; c. the 7B q5_k file (8 layers)
                  as draft_llm_path (engine.set_drafter); d. a random draft
                  head of init_draft_head (d_main 5120), saved and loaded
                  (16 ids each).  f., after the 7B chat on its engine: the
                  7B file drafting for itself on a text turn, so that
                  drafts hold: 48 ids, more than 2 tokens per pass.  Every
                  greedy stream must
                  give the plain stream's ids, or leave them only where the
                  plain top-2 margin is a tie (SPEC_TIE_DECODE;
                  spec_ids_check prints where).  Each sub-path's launch
                  counts are set to 0 just before and read just after
                  ("speculative ..." paths).  e., in phase 5 (spec_batch):
                  copies of the eight prepared sessions as a plain paged
                  group, then with speculative_k = 8 as a paged window
                  group and through a ContinuousBatcher (8 lanes, paged):
                  the plain ids up to ties within SPEC_TIE_PREFILL (a
                  verify of 64 rows runs the bf16 prefill matmul),
                  aggregate tok/s and spec_demotions ("speculative
                  batched" path); b'. the first two sessions as one group
                  of a greedy and a sampled lane (M = 16): the greedy
                  lane's plain ids, each lane's tokens per lane-pass of the
                  sampled verify steps.  `python3 chip_smoke.py
                  --only-speculative` runs phases 1-2, a-d on a fresh 13B
                  engine, f on a 7B engine and e, b' on a session pool, and
                  prints no result line.
  4'''. train - (inside a and a', after 4'', on a's loaded engine;
               minigpt4_tpu_torch/train/, no backward kernel: the trainers
               differentiate through plain torch as the JAX package's
               through XLA) b. the draft head's distillation with the 13B
               gq engine as the teacher: teacher_targets on 4 x 128 random
               ids (gq_prefill and gq_prefill_generic must launch; row 0
               equal to a B = 1 forward's argmax up to SPEC_TIE_PREFILL
               ties), 30 AdamW(3e-3, weight decay 1e-4) steps of a
               DraftHeadConfig(512, 2, 8, 1408) head (the loss must fall,
               no kernel may launch), saved and set as the engine's draft
               head: 16 drafted greedy ids equal to plain greedy's, tokens
               per pass.  a. stage-1 projection training at Vicuna-13B
               width and depth: the 13B Q5_K_M file loaded again as
               qtensor (packed bytes; gq is refused) beside the engine's
               f16-container vision params, llama_proj as f32 leaves; 2
               images at 224 with 24-token captions (56 decoder rows); the
               first step's projection gradient at 2 layers, the qtensor
               autograd Function against plain autograd (1e-5 of
               max|grad|); then 5 Adam(1e-2) steps at 40 layers through
               make_train_step: s/step with forward and backward apart,
               the loss per step (must fall by 2 %), peak device memory,
               and no kernel launched ("train ..." paths).
               `python3 chip_smoke.py --only-train` runs phases 1-2 and
               this phase on a fresh 13B engine and prints no result line.
  5. serving - minigpt4_tpu_torch.serve.start_server on the 13B Q5_K_M
               geometry cut to 8 layers (LLM_13B_L8: its start captures 16
               group chunks, and the cut pays for the tp phase's second
               slice; the continuous pass below stays at full depth)
               and the 13B f16 container, with
               session_ctx 512, a 30 ms batch window and a pool of 32 pages,
               on an ephemeral port.  Eight client threads each create a
               session; one uploads an image; all ask (different lengths)
               and generate 32 greedy tokens concurrently.  Every response
               must be 200 with text, /v1/health must show all 32 pages free
               afterwards, and all six kernels must launch (counts set to 0
               just before, read just after).  Then eight sessions with the
               same prompts and copies of them decode one step as a paged
               group and as a dense group: max |dlogit| / max |logit| <= 1e-3,
               and 31 more tokens each way give the identical-token prefix
               per lane and the tok/s of an 8-lane paged group; a third copy
               decodes a 16-token chunk of the group under torch.profiler.
               Then continuous batching (continuous_serving): start_server
               with continuous=True, max_batch 8, 32 pages and park_idle
               (its start seconds, two captured graphs, beside the window
               server's start); the eight questions streamed through
               /v1/chat/completions 0.25 s apart (the last with a PNG): at
               least one join, at least 7 prefix-cache hits, gq_decode,
               gq_decode_generic and the paged flash kernel launched (the
               "continuous" path: counts set to 0 just before, read just
               after), aggregate and per-request tok/s, time to the first
               streamed token; one of the questions again, before and after
               a longer conversation that opens with it (texts equal); the
               system prompt on a miss and on a hit; the
               eight prepared sessions through the paged batcher and a dense
               one, a chunk each (ids equal); a forced preemption (the pool held down to
               one spare page: the preempted text equals the free run's);
               a 13B session parked and put back (seconds, bytes; its next
               16 greedy ids equal an unparked copy's); the pass's seconds.
               `python3 chip_smoke.py --only-serving` runs phases 1-2 and 5
               and prints no result line.
  6. repack  - a third chat as in phase 4: the 13B Q5_K_M geometry cut to
               8 layers (LLM_13B_L8, which pays for phase 4''') with
               quant_mode="repack" (every decoder weight repacked) and a 13B
               container whose quantizable weights are q5_k (ViT-G fc2 and
               the Q-Former projections of K % 256 == 0; the rest f16);
               rq_decode, rq_prefill and flash_decode must launch and no gq
               kernel may.  Then a 13B q5_1 container, every ViT-G and
               Q-Former projection quantized (K = 1408 included): its
               embedding through the kernels against the same weights
               dequantized to dense f32 on the card (max |d| / max |emb| <=
               ENCODE_TOL).
  7. w8a8    - the i8 kernels (i8_decode, the whole matmul from f32 x in
               one launch, at the five 13B decode shapes, M = 1 and 8,
               against qmatmul_i8sb_decode_ref; i8_prefill at the 13B w13 M
               = 512, ViT-G fc2 M = 257 and the Q-Former intermediate M = 32
               against qmatmul_i8sb_ref, with torch._int_mm (i8 x i8 -> i32
               without the chunk scales) as the library time where it takes
               the shape), and both flash kernels over e4m3 caches (dense S
               = 1, 8, 32 at pos0 = 2015; paged at the serving pools) in
               phase 3.
               Then smooth-quant scales of the 13B Q5_K_M geometry cut to 8
               layers (LLM_13B_L8, which with phase 6 pays for phase 4''')
               (quality.compute_smooth_scales, one 32-token calibration
               sequence, qtensor params freed before the next load) and a
               SessionPool over it in quant_mode="w8a8" with those scales and
               e4m3 caches, behind the 13B q5_1 container (the q5_k container
               quantizes no K = 1408 weight, so rq_prefill could not run):
               the chat of phase 4 on its engine, then eight sessions decode
               32 greedy tokens as a paged group and as a dense group, token
               for token equal.  i8_decode, i8_prefill, rq_prefill and both
               flash kernels must launch, no gq kernel may, packed or not
               (nor in the serving phase or the repack chat).
  8. quality - python -m minigpt4_tpu_torch.quality at the small geometry on
               the card: five finite rows, the table and both gates.
               Since the redesign of flash decode (keys split over blocks)
               and i8_prefill (wgmma over a TMA ring), those rows, the stats
               rows and the chats' own decode attention (13B B = 1, 40 heads,
               S = 1 at pos0 = 240, bf16 and e4m3) also get a device-only
               time (a CUDA graph of 20 launches replayed between events, so
               the wrapper's host work is left out), with SDPA's and
               torch._int_mm's device-only time beside them, the share of
               the bound and the factor against the library.  Every row of
               the quantized prefill kernel (gq_prefill, gq_prefill_generic,
               their packed entries, rq_prefill: wgmma with the weight in
               registers, csrc/qmm_prefill.cuh) gets a device-only time too,
               beside the dense yardstick "dense bf16, same shape" (torch.
               matmul of bf16 x with the weight dequantized to bf16 once,
               outside the timing), which is the row's library time; the 13B
               w13 q5_k rows cover the chat's buckets (M = 32, 64, 128, 256,
               512), the q6_k w2 rows M = 256 and 512.  Before phase 3 the
               SASS opcode counts of i8_prefill_kernel and qmm_prefill_kernel
               (cuobjdump) are printed; both must hold warpgroup MMA and TMA
               loads.  Since the redesign of the M <= 8 gq decode kernels
               (the dual-i8 function on __dp4a, the split of x inside the
               launch, csrc/gq_decode_i8.cuh), phase 3 starts with the 13B
               exact-plane decode shapes (wqkv, wo, w13, w2 at M = 1 and 8)
               within 1e-5 of the plain version, device-only beside the
               bound and the same-run time of the dual-i8 probe (x split
               beforehand); the decode kernel's SASS must hold IDP.4A; every
               profile prints the gq decode kernel's time.  Since the
               redesign of rq_decode (csrc/rq_decode.cuh: x staged once per
               persistent block, quads on contiguous bytes, codes unpacked
               once without I2F) and i8_decode (the quantization of x and
               the row scale inside its launch), phase 3 gives both the five
               13B decode shapes (wqkv, wo, w13, w2, output; rq_decode also
               q6_k at output, wv and w2) at M = 1 and 8, device-only beside
               the bound and the same-run time of a probe at the same shape
               (the q5 magic dequantize-matvec for rq_decode, the i8 x i8
               dot for i8_decode); the SASS of i8_decode_kernel must hold
               IDP.4A, neither it nor rq_decode_kernel local memory, and
               rq_decode_kernel no int-to-float convert; every profile
               prints the rq and i8 decode kernels' time, every chat its
               device activities per token.
               `python3 chip_smoke.py --only-kernels [flash,i8,...]` runs
               phases 1-3 alone (sections of KERNEL_SECTIONS) and prints no
               result line.
  3'. probes - (right after phase 3) the micro-benchmarks of
               minigpt4_tpu_torch/tools/, the counterparts of the JAX
               package's tools/ probes, each run in this process through its
               main() at the 13B shapes for M = 1 and 8 with the fewest timed
               launches (20): qmm_group_i8 (the dual-i8 exact-q5_k kernel at
               the five 13B decode shapes; its gq, rq_decode and i8_decode
               arms are phase 3's decode rows),
               qmm_variants, unpack_variants, qmm_v3 (its three
               entries) and qmm_r3 (the dequantize-matvec at the w2 shape,
               16-byte loads), probe_int4 (i8 x i8, s4 x s4, s4
               chunk-scaled) and probe_i8ops (the op chains, REPS = 8).  Every
               case holds its kernel against its plain version (integer modes
               bit-equal, f32 modes within 1e-4 of max|y|; the dual-i8 kernel
               also within 3e-4 of the f64 dequant); the tools' JSON lines go
               to build/probes/<tool>.jsonl, the phase's seconds and each
               kernel's representative case to the log.  The launch counts are
               set to 0 before and read after (the "probes" path); the phase
               frees its tensors before the tp phase.  All four probe
               kernels are redesigned for the H100 (their kernels-line
               entries say "state": "redesigned"): the dequantize-matvec
               (csrc/probe_qmm.cuh: a persistent grid over a cp.async ring,
               f32 FMAs at M = 1, bf16 mma.sync with x in three exact parts at
               M = 2..8), the op chains (csrc/probe_ops.cu: a persistent grid
               streaming with no row arithmetic, the out block a stage of its
               own), the dual-i8 matmul and the integer dots
               (csrc/probe_group_i8.cu, csrc/probe_int.cu: a persistent grid
               over the ring of csrc/probe_ring.cuh, producer warps copying
               while consumer warps compute, clusters splitting K at small N,
               every group dot on s8 mma.sync, int4 codes unpacked in
               registers).  Before phase 3 their SASS is held
               per template instance (PROBE_SASS): every M = 2..8
               dequantize-matvec instance (qmm_tc_kernel) must hold HMMA,
               every instance of the dual-i8 and integer kernels IMMA, and no
               instance of any of them may touch local memory.  Phase 3's
               kernel / probe factors of gq_decode and i8_decode read against
               the redesigned dual-i8 and i8 x i8 probes.
  9. tp      - (runs right after phase 3', while this process holds little
               device memory) MiniGPT4Engine(tp=2) on one card: Vicuna-13B at full width, cut
               to 8 layers, every projection q5_k, quant_mode="repack", behind the
               13B f16 container.  First the chat of phase 4 at tp=1 in this
               process; then two ranks (processes spawned by
               parallel.dryrun.run_ranks, both on cuda:0, gloo, a deadline)
               each run it on their half of the decoder (rq_decode, rq_prefill
               and flash_decode at the local shapes, no gq kernel) and print
               load time, tok/s, the collectives' share of a profiled chunk
               and the backend.  Each rank's first 8 greedy ids equal to
               tp=1's (how many of 32 agree is printed).  The logit gap
               against depth: the prefill logits of a text turn at tp=2
               against tp=1 on the same geometry cut to 1 and 4 layers and at
               8; at 1 layer within 1e-3 (max |d| / max |logit|); the
               deeper gaps, grown from f32 order through bf16 roundings,
               are printed.  Then sp_flash_decode_attention
               over the two ranks (1024 positions each) against the kernel on
               the whole cache, 2e-5, counting the stats kernel's launches
               (the "sp" path).  Between the chat and the SP check each rank
               runs the second tp slice on its loaded engine (tp_slice), held
               to the tp=1 engine of this process (tp_refs): a. the chat
               image through the ViT-G split over the ranks
               (parallel/sharding.py; qkv / fc1 column-, proj / fc2
               row-parallel), the embedding within 1e-4 of max|emb| of
               tp=1's, encode ms per rank (on failure debug.first_divergence
               of the two stage dumps); b. three Adam steps of llama_proj
               (2 images, 24-token captions) through the sharded encoder and
               the decoder loaded again as qtensor f32 and sharded: the loss
               of each step within 1e-4 relative and llama_proj after within
               2 x 3 x lr absolute of tp=1's (Adam moves an element by
               ~lr a step whatever its gradient), the first step's gradient
               within 1e-4 of max|grad|, forward and backward s/step and
               peak memory per rank (profiling.device_memory_stats), no
               kernel launched; c. start_server(tp=2, pool=) over a pool on
               the rank's engine, a window server (paged, 32 pages) and then
               a continuous one (8 lanes): four requests at once of 32 greedy
               ids, one after a PNG upload; every operation's ids agree
               across the ranks (parallel/controller.py) and the first 8 of
               each request equal tp=1's; aggregate tok/s and the
               collectives' share of the wall (profiling.collective_seconds:
               the request threads' all-reduces, which the profiler of the
               calling thread does not see); d. n-gram
               speculation at k = 8 on a text turn: greedy ids equal plain
               tp=2 greedy's but where the plain top-2 margin is below
               SPEC_TIE_PREFILL of max|logit|, a seeded sampled stream equal
               on both ranks.  Paths "13B q5_k repack tp=2 rank r serve
               window / serve continuous / spec" in launches_by_path (rows
               paged_flash_decode, rq_decode, rq_prefill; flash_decode,
               rq_decode).  `python3 chip_smoke.py --only-tp` runs phases 1-2
               and 9 alone.
  10. clients - (after phase 8) the 13B Q5_K_M geometry cut to 8 layers
               (LLM_13B_L8) and the 13B f16 container through
               MiniGPT4Engine(n_ctx=512, n_batch=64, context_shift=True), graphs
               on: a. the system prompt and image turn (235 positions), saved
               with save_state, then 400 greedy ids through generate, which
               shifts the context at least once (every shift timed; the first
               one's cache, K and V, bit-equal to shift_kv_cache on a CPU copy
               of the cache before it; st.cache["k"] keeps its data_ptr; a
               checkpoint saved two decode chunks before that shift), then
               five chunks from that checkpoint with graphs_enabled off,
               across the shift: the ids and the shifts equal; tok/s before
               and after the first shift.
               b. restore_state, 32 greedy ids, reset_chat, restore_state, 32
               ids: equal (and equal to a's first 32), the graph replay count
               moving each time; the save and restore seconds and the file
               size.  c. libminigpt4_torch.so (c_api/_build.py, g++) and the
               unchanged examples/main.c compiled against it, run as a process
               on the same files with no MINIGPT4_TPU_DEVICE: its stream must
               equal the engine's greedy text for main.c's zero image and
               prompt (the engine of a-b, then closed); then the same library
               through ctypes in this process (launch counts set to 0 after
               its load): the same text, and gq_decode, gq_prefill and
               flash_decode must launch; its tok/s.
               `python3 chip_smoke.py --only-clients` runs phases 1-2 and 10
               and prints no result line.
  11. synthetic models - (right after phase 3') a. minigpt4_tpu_torch.
               kernel_gate: run_gate, every matmul entry (gq on i8 and
               packed codes, exact and generic planes; rq; i8) at every
               Vicuna-7B and -13B weight shape as the loader lays it out,
               q4_k, q5_k, q6_k, q4_0, q8_0 and q5_1, M = 1, 8, 9, 512,
               stacked (layer 1 of 2) and flat, against the f64 product of
               the dequantized weight (1e-3 for the gq decode and i8
               entries, 2e-2 for the prefill and rq ones), and run_tp_gate
               (the repack.k_slice shards of 13B w2 and wo at tp = 2 and 4,
               summed); outside the launch counts; each case in
               build/kernel_gate.log, each matmul entry of the kernels line
               gains "gate": {"cases", "max_rel_err"}.  b. the benchmark's
               synthetic Vicuna-13B teacher (benchmark.synth_llama_params,
               gq, bench_pack_policy's packing, default_rng(0), full width
               and depth) built on the card: seconds and bytes; a 64-token
               word-id prefill and 32 greedy steps through llama.forward
               (its gq entries and flash decode must launch: path
               "synthetic 13B gq teacher") and n-gram drafting's tokens per
               pass over them; over a 512-token teacher-forced word stream,
               the distinct argmax targets and the modal share (non-finite
               logits or one distinct target, a collapsed teacher, fail).
               c. tools/train_draft.run on that teacher (40 steps, 4 teacher
               batches of 8 x 128; path "synthetic 13B distill"): target ms,
               distill s, EVAL tokens per pass at k = 8, the artifact tagged
               synth_teacher_tag's way and written to benchmark.
               DRAFT_ARTIFACT, where phase 12 reads it.  `python3
               chip_smoke.py --only-synthetic` runs phases 1-2 and 11 and
               prints no result line.
  12. bench  - (after phase 10) minigpt4_tpu_torch.benchmark in this
               process: a. chip_state_probe (GB/s of chained bf16 matvecs,
               each chain one captured graph; above 105 % of 3.35 TB/s
               fails); b. bench_decode("13B", Q5_K, 64, 64,
               quant_mode="gq", sections="single") at full width and
               depth, bench.py's headline arm: the core block and the
               n-gram, sampled, drafter and distilled-head riders (the head
               of phase 11); c. bench_decode over the serving riders
               (batched, batched speculation, paged, paged speculation)
               with quant_mode="w8a8", an e4m3 cache and 8 lanes at 13B
               width cut to 8 layers (GEOMETRIES["13B_L8"], registered
               here); d. bench_encode(5120); e. kernel_gate.run_floors
               ("check") against minigpt4_tpu_torch/kernel_floors.json,
               outside the counts.  The counts are set to 0 before b and
               read after d (path "bench").  Each result is one "[bench
               ...]" JSON line.  Fails on a section error, a skipped
               section, a rate that is not finite and positive, a floor
               under its margin, a kernel of b or c never launched, and
               b's decode_tok_s below 0.7 x the packed 13B gq chat's
               captured tok/s of phase 4.  `python3 chip_smoke.py
               --only-bench` runs phases 1-2 and 12 (without the chat
               comparison; the draft-head rider then reports its artifact
               absent) and prints no result line.
  Tools     - the repo-level tools' ports (minigpt4_tpu_torch/tools/), a
               step in three phases, each with its own path and "[tools
               ...]" lines: in phase 11, before the teacher is freed,
               profile_prefill_engine.run (each token tile x attn_len
               None / 512, chains of 2 and 6) and probe_teacher_locality.run
               on it (its gq prefill entry and flash decode must launch);
               in phase 7, before the chat, probe_paged_capacity.run at 8,
               12 and 16 lanes and at 8 lanes with --spec-k 8, and
               probe_paged_spec_cost.run on the w8a8 engine's decoder (the
               i8 kernels and both flash kernels must launch, no gq
               kernel); right after the 13B chats, python -m
               minigpt4_tpu_torch.tools.coldstart_probe over their 13B
               Q5_K_M pair as a process of its own (exit 0, JAX's keys,
               finite positive numbers; gq_decode, gq_decode_generic,
               gq_prefill and flash_decode in its launch line).
Captured CUDA graphs (engine/graphs.py): every engine's own steps and the
paged group replay graphs, so the launch counts of every path above are
counted through replays (ops/counters.py).  The 13B Q5_K_M chat, its
packed twin, the repack chat and the w8a8 + e4m3 chat each run
MiniGPT4Engine.warmup() before the chat (its seconds, graphs and pool
memory printed; the counts are set to 0 after it) and, after it, outside
the counts, graph_ab: the encoder, the system prompt and image turn (profiled), a
greedy 16-token chunk and a sampled one (temp 0.8, the generator seeded
alike) captured and with graphs_enabled off, each pair from the same
state: ids equal, logits within GRAPH_TOL of max|logit|, then the greedy
chunk timed in turns and profiled each way (tok/s, device activities per
token, idle share); the captured chunk must be less idle.  The server
captures the paged group's greedy and sampled chunks for 1 to 8 lanes as
it starts (SessionPool.warmup; the counts are set to 0 after it), and
paged_graph_ab holds the 8-lane paged group's captured chunk to the eager
one from copies of the same sessions in the same way, outside the counts.
The 7B chats and the tp=1 reference chat capture lazily (a key's second
use) and skip the A/B.
The card tests (tests/test_torch_cuda.py) hold the engine on the card to
its plain versions on small fixtures.  The line before the last is
{"kernels": [...]} (launches in each kernel's own path, the serving phase,
the repack chat, the w8a8 path, a packed chat, the SP path or the probes,
and of each path); the last is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import base64
import collections
import contextlib
import dataclasses
import gc
import io
import json
import math
import shutil
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
DEVICE = "cuda"
Q5K_D = 2.0 ** -15  # f16 superblock scale of the synthetic q5_k weights
# q6_k d that gives the q5_k weights' spread: with uniform random bytes a
# q5_k weight has std 527 d (dmin = 15.5 d), a q6_k weight d * sc * (q - 32)
# std 1366 d
Q6K_D = Q5K_D * math.sqrt(277651 / 1865102)
STACK_7B, STACK_13B = 32, 40  # stacked layers the kernel phase rotates through
STACK_VIT, STACK_QF, STACK_HEAD = 39, 12, 8  # ViT-G blocks, Q-Former layers, output copies
# q5_1 d that gives the f16 container's weight spread (std 0.02): a q5_1
# weight d * q + m with uniform codes 0..31 has std 9.23 d; m = -15.5 d
Q51_D = 0.02 / 9.23
# q4_0 d and q4_k d for the q5_k weights' spread (std 527 Q5K_D): a q4_0
# weight d * (q - 8) with uniform codes 0..15 has std 4.61 d; a q4_k weight
# d * sc * q - 7.5 d * mn with uniform sc, mn 0..63 and q 0..15 has std 263 d
Q40_D = 527 * Q5K_D / 4.61
Q4K_D = Q5K_D * 527 / 263
# NVIDIA's H100 SXM data sheet: HBM rate, f32 (CUDA cores) and dense bf16
# tensor-core peaks; a kernel's bound is the larger of bytes / HBM_BPS and
# operations / the peak of the type they run in
HBM_BPS, F32_FLOPS, BF16_FLOPS, INT8_OPS = 3.35e12, 67e12, 989e12, 1979e12
# Vicuna-7B and -13B (benchmark.py GEOMETRIES) and MiniGPT-4's ViT-G / Q-Former
LLM_13B = dict(n_embd=5120, n_head=40, n_layer=40, n_vocab=32000, n_mult=256, layout="q5_k_m")
LLM_7B = dict(n_embd=4096, n_head=32, n_layer=8, n_vocab=32000, n_mult=256, layout="q5_k")
# the packed gq entries of the formats a Q5_K_M file lacks: Vicuna-7B width,
# depth cut to 8, wq/wk/wv/w1/w3 q4_k (so wqkv and w13 fuse as in a q5_k
# file), wo q5_1, w2 q4_0, output q6_k.  No llama.cpp ftype writes this mix:
# it is synthetic coverage of the p4 and generic p5 entries.
LLM_7B_MIX = dict(LLM_7B, layout="q4_mix")
Q4_MIX = {"output.weight": "Q6_K", "attention.wo.weight": "Q5_1", "feed_forward.w2.weight": "Q4_0"}
# the largest prefill bucket of the chat (a 142-token system prompt padded
# to 256 rows); the image and the question take 32
PROMPT_M = 256
VISION_GEOMETRY = dict(width=1408, depth=39, mlp=6144, hidden=768, qf_layers=12, queries=32,
                       intermediate=3072, qf_heads=12)


T_START = time.perf_counter()


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str) -> None:
    """Mark a phase: the elapsed time, and the device memory this process
    still references from the phases before, garbage collected first (a
    leak shows here)."""
    mem = ""
    if torch.cuda.is_initialized():
        gc.collect()
        torch.cuda.empty_cache()
        mem = f", {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated"
    log(f"[phase] {name} at {time.perf_counter() - T_START:.1f} s{mem}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def _time_ms(fn, args_for, reps: int) -> list[float]:
    """Per-launch device times (ms) of fn(*args_for(i)), i = 0..reps-1."""
    out = []
    for i in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        args = args_for(i)
        a.record()
        fn(*args)
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return out


def log_profile(label: str, prof: dict, card: str) -> None:
    log(f"{label} profiled: wall {prof['wall_ms']:.1f} ms, device busy {prof['busy_ms']:.1f} ms, "
        f"idle {100 * prof['idle']:.0f} %, {prof['device_ops']} device activities; most device "
        f"time: {prof['top']}; flash decode {prof['flash_ms']:.2f} ms; quantized prefill "
        f"{prof['prefill_ms']:.2f} ms; decode matmuls gq {prof['gq_decode_ms']:.2f} / rq "
        f"{prof['rq_decode_ms']:.2f} / i8 {prof['i8_decode_ms']:.2f} ms  [{card}]")


def compare_times(kernel, plain, args_for, reps: int = 10) -> tuple[float, float]:
    """Median ms of kernel and plain, measured in turns plain, kernel,
    kernel, plain after one warm-up launch of each."""
    kernel(*args_for(0))
    plain(*args_for(0))
    torch.cuda.synchronize()
    t = {"k": [], "p": []}
    for who in ("p", "k", "k", "p"):
        t[who] += _time_ms(kernel if who == "k" else plain, args_for, reps)
    return statistics.median(t["k"]), statistics.median(t["p"])


def device_ms(fn, args_for, n_args: int) -> float:
    """Device-only median ms per launch of ``fn(*args_for(i))``: a CUDA graph
    of 20 launches (i rotating through ``n_args`` argument sets) replayed
    between CUDA events, so the wrapper's host work is left out
    (minigpt4_tpu_torch/tools/_harness.py:time_ms)."""
    from minigpt4_tpu_torch.tools import _harness

    return _harness.time_ms(fn, args_for, n_args)


# what device_row adds to a row (and the kernels line carries)
DEVICE_KEYS = ("device_ms", "library_device_ms", "bound_share", "library_factor")


def device_row(row: dict, label: str, dev_ms: float, lib_dev_ms, lib_name: str,
               card: str) -> None:
    """Add the device-only times of a kernel and of its library call to its
    row, with the share of the bound and the factor against the library,
    and print them."""
    row.update(device_ms=dev_ms, library_device_ms=lib_dev_ms,
               bound_share=row["bound_ms"] / dev_ms,
               library_factor=None if lib_dev_ms is None else dev_ms / lib_dev_ms)
    lib = ("no library call" if lib_dev_ms is None else
           f"{lib_name} {lib_dev_ms:.4f} ms, kernel / library {dev_ms / lib_dev_ms:.3f}")
    log(f"[device-only] {label}  kernel {dev_ms:.4f} ms ({100 * row['bound_share']:.1f} % of "
        f"its {row['bound_ms']:.4f} ms bound, {row['bound_by']})  {lib}  [{card}]")


# the kernels that must run on warpgroup MMA (xGMMA in their SASS) fed by TMA
# (UTMALDG): the s8 i8_prefill_kernel and the bf16 qmm_prefill_kernel (every
# plane and code source, every token tile)
WGMMA_KERNELS = ("i8_prefill_kernel", "qmm_prefill_kernel")


def check_wgmma_sass(card: str) -> dict:
    """The opcodes of each kernel of WGMMA_KERNELS: fails unless they hold
    warpgroup MMA (xGMMA) and TMA loads (UTMALDG)."""
    from minigpt4_tpu_torch.tools import _harness

    out = {}
    for kernel in WGMMA_KERNELS:
        ops = _harness.sass_opcodes(kernel)
        log(f"[sass] {kernel} opcodes: {json.dumps(dict(sorted(ops.items())))}  [{card}]")
        gmma = {k: v for k, v in ops.items() if "GMMA" in k}
        tma = {k: v for k, v in ops.items() if k.startswith("UTMALDG")}
        log(f"[sass] {kernel} warpgroup MMA {gmma}, TMA loads {tma}")
        if not gmma or not tma:
            raise AssertionError(f"{kernel}: no warpgroup MMA ({gmma}) or no TMA load ({tma}) "
                                 "in its SASS")
        out[kernel] = ops
    return out


# the M <= 8 decode kernels (every plane and code source and M): the dual-i8
# gq kernel and the fused i8 kernel must run on integer dot products
# (IDP.4A); the rq and i8 kernels keep nothing in local memory, and the rq
# kernel unpacks its codes without int-to-float converts (I2F*)
DECODE_SASS = {"gq_decode_i8_kernel": (True, False, False),
               "i8_decode_kernel": (True, True, False), "rq_decode_kernel": (False, True, True)}


def check_decode_sass(card: str) -> dict:
    """The opcodes of each kernel of DECODE_SASS, held to its row there
    (integer dot products, no local memory, no int-to-float converts)."""
    from minigpt4_tpu_torch.tools import _harness

    out = {}
    for kernel, (need_idp, no_local, no_i2f) in DECODE_SASS.items():
        ops = _harness.sass_opcodes(kernel)
        idp = {k: v for k, v in ops.items() if k.startswith("IDP")}
        local = {k: v for k, v in ops.items() if k.startswith(("LDL", "STL"))}
        i2f = {k: v for k, v in ops.items() if k.startswith("I2F")}
        log(f"[sass] {kernel} opcodes: {json.dumps(dict(sorted(ops.items())))}  [{card}]")
        log(f"[sass] {kernel} integer dot products {idp}, local-memory accesses {local}, "
            f"int-to-float converts {i2f}")
        if need_idp and not any(k.startswith("IDP.4A") for k in idp):
            raise AssertionError(f"{kernel}: no IDP.4A in its SASS ({idp})")
        if no_local and local:
            raise AssertionError(f"{kernel}: local-memory accesses in its SASS ({local})")
        if no_i2f and i2f:
            raise AssertionError(f"{kernel}: int-to-float converts in its SASS ({i2f})")
        out[kernel] = ops
    return out


# the probe kernels redesigned for the H100 (csrc/probe_qmm.cuh,
# csrc/probe_ops.cu, csrc/probe_group_i8.cu, csrc/probe_int.cu), held per
# template instance: kernel -> (the tensor-core opcode every instance must
# hold, or None; no local memory).  The dequantize-matvec's M = 2..8
# instances run on the bf16 tensor cores (HMMA), the dual-i8 matmul and the
# integer dots on the s8 ones (IMMA), the dequantize-matvec's M = 1
# instances and the op chains on the f32 and integer units; none keeps
# anything in local memory.
PROBE_SASS = {"qmm_tc_kernel": ("HMMA", True), "qmm_fma_kernel": (None, True),
              "op_chain_kernel": (None, True), "probe_group_i8_kernel": ("IMMA", True),
              "int_dot_kernel": ("IMMA", True)}


def check_probe_sass(card: str) -> dict:
    """Every instance of each kernel of PROBE_SASS held to its row there;
    returns the opcodes summed over each kernel's instances."""
    from minigpt4_tpu_torch.tools import _harness

    out = {}
    for kernel, (need_mma, no_local) in PROBE_SASS.items():
        funcs = _harness.sass_functions(kernel)
        if not funcs:
            raise AssertionError(f"{kernel}: no instance in the library's SASS")
        total: dict = {}
        for name, ops in funcs.items():
            local = {k: v for k, v in ops.items() if k.startswith(("LDL", "STL"))}
            if need_mma and not any(k.startswith(need_mma) for k in ops):
                raise AssertionError(f"{kernel}: no {need_mma} in the SASS of {name}")
            if no_local and local:
                raise AssertionError(f"{kernel}: local-memory accesses {local} in {name}")
            for k, v in ops.items():
                total[k] = total.get(k, 0) + v
        mma = {k: v for k, v in total.items() if k.startswith(("HMMA", "IMMA"))}
        log(f"[sass] {kernel}: {len(funcs)} instances, tensor-core MMAs {mma}"
            f"{f' ({need_mma} in every one)' if need_mma else ''}, no local memory in any; "
            f"opcodes {json.dumps(dict(sorted(total.items())))}  [{card}]")
        out[kernel] = total
    return out


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions at the 7B and 13B shapes
# ---------------------------------------------------------------------------


def random_gq(n_layer: int, n: int, k: int, gen: torch.Generator, dtype=None):
    """Stacked exact-plane GroupQuant made on the card: q5_k (codes 0..31,
    the smoke model's d and dmin = 15.5 d) or q4_k (codes 0..15, Q4K_D and
    dmin = 7.5 d), with random 6-bit sub-scales."""
    from minigpt4_tpu_torch.formats import DataType
    from minigpt4_tpu_torch.ops.group_i8 import GroupQuant

    q4 = dtype == DataType.Q4_K
    d = Q4K_D if q4 else Q5K_D
    g, s = k // 32, k // 256
    dev = DEVICE
    return GroupQuant(
        codes=torch.randint(0, 16 if q4 else 32, (n_layer, n, k), generator=gen, device=dev,
                            dtype=torch.int8),
        sc6=torch.randint(0, 64, (n_layer, g, n), generator=gen, device=dev, dtype=torch.uint8),
        mn6=torch.randint(0, 64, (n_layer, g, n), generator=gen, device=dev, dtype=torch.uint8),
        d=torch.full((n_layer, s, n), d, device=dev),
        dmin=torch.full((n_layer, s, n), (7.5 if q4 else 15.5) * d, device=dev),
        dtype=DataType.Q4_K if q4 else DataType.Q5_K, n_in=k)


def random_generic(n_layer: int, n: int, k: int, dtype, gen: torch.Generator):
    """Stacked generic-plane GroupQuant made on the card: q6_k (codes 0..63,
    A = d * sc for random signed sub-scales sc, B = -32 A), q4_0 (codes
    0..15, A = d in [0.5, 1.5) x Q40_D, B = -8 A), q5_1 (codes 0..31, A = d
    in [0.5, 1.5) x Q51_D, B = -15.5 A) or q8_0 (signed codes, A = d in
    [0.5, 1.5) x 2^-13, B = -0)."""
    from minigpt4_tpu_torch.formats import DataType
    from minigpt4_tpu_torch.ops import group_i8 as gq

    gs = gq.group_size(dtype)
    shape = (n_layer, k // gs, n)
    if dtype == DataType.Q6_K:
        codes = torch.randint(0, 64, (n_layer, n, k), generator=gen, device=DEVICE, dtype=torch.int8)
        a = Q6K_D * torch.randint(-128, 128, shape, generator=gen, device=DEVICE).float()
        b = -32.0 * a
    elif dtype in (DataType.Q4_0, DataType.Q5_1):
        q4 = dtype == DataType.Q4_0
        codes = torch.randint(0, 16 if q4 else 32, (n_layer, n, k), generator=gen, device=DEVICE,
                              dtype=torch.int8)
        a = (Q40_D if q4 else Q51_D) * (0.5 + torch.rand(shape, generator=gen, device=DEVICE))
        b = -(8.0 if q4 else 15.5) * a
    else:
        codes = torch.randint(-128, 128, (n_layer, n, k), generator=gen, device=DEVICE,
                              dtype=torch.int8)
        a = 2.0 ** -13 * (0.5 + torch.rand(shape, generator=gen, device=DEVICE))
        b = -torch.zeros(shape, device=DEVICE)
    return gq.GroupQuant(codes=codes, dtype=dtype, n_in=k, group_size=gs,
                         a=a.to(torch.bfloat16), b=b.to(torch.bfloat16))


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(n_bytes: float, flops: float, peak: float) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") for a call that must move
    ``n_bytes`` and do ``flops`` at ``peak`` operations per second."""
    t_bytes, t_ops = n_bytes / HBM_BPS, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def gq_bound(w, m: int) -> tuple[float, str]:
    """One layer's codes (packed or not) and planes read once, x [M, K] f32 read and y
    [M, N] f32 written once; for the decode kernels (M <= 8) the dual-i8
    function's 4 M N K integer operations (two i8 dot products) at the int8
    peak, for the prefill kernels 2 M N K in bf16 on the tensor cores."""
    from minigpt4_tpu_torch.ops import group_i8 as gq

    layer = nbytes(*w.tensors().values()) / w.codes.shape[0]  # codes, high bits, planes
    n, k = w.n_out, w.n_in
    if m <= gq.GQ_MAX_M:
        return bound(layer + 4 * m * (k + n), 4.0 * m * n * k, INT8_OPS)
    return bound(layer + 4 * m * (k + n), 2.0 * m * n * k, BF16_FLOPS)


def attention_bound(b: int, h: int, s: int, dh: int, keys: int, kv_bytes: int):
    """Live K and V rows (``keys`` in all lanes) read once, q and the f32
    output moved once; 4 S Dh operations per live key and head, in f32."""
    return bound(2 * keys * h * dh * kv_bytes + 2 * b * h * s * dh * 4,
                 4.0 * s * dh * keys * h, F32_FLOPS)


def sdpa_mask(pos: torch.Tensor, s: int, c: int) -> torch.Tensor:
    """[B, 1, S, C] boolean: query row r of lane b sees keys <= pos[b] + r."""
    q_pos = pos.long()[:, None] + torch.arange(s, device=pos.device)
    return (torch.arange(c, device=pos.device) <= q_pos[..., None])[:, None]


def prefill_device_row(row: dict, label: str, kern, w, x: torch.Tensor, n_stack: int,
                       dense_w: torch.Tensor, card: str) -> None:
    """A prefill row's device-only time (CUDA graph, rotating through the
    stacked layers) beside the dense yardstick: torch.matmul of bf16 x with
    ``dense_w``, the weight dequantized to bf16 once (outside the timing;
    copies of it rotate so it is not L2-resident), timed around the call
    (the row's library_ms) and device-only."""
    from minigpt4_tpu_torch.tools import _harness

    xb = x.to(torch.bfloat16)
    copies = _harness.rotation((dense_w,), dense_w.numel() * dense_w.element_size())
    dense = lambda a, b: a @ b.t()  # noqa: E731
    torch.cuda.synchronize()
    row["library_ms"] = statistics.median(
        _time_ms(dense, lambda i: (xb, copies[i % len(copies)][0]), 10))
    device_row(row, label, device_ms(kern, lambda i: (x, w, i % n_stack), n_stack),
               device_ms(dense, lambda i: (xb, copies[i % len(copies)][0]), len(copies)),
               "dense bf16, same shape", card)
    del copies


def check_matmul(results: dict, card: str, name: str, w, n_stack: int, ms, gen) -> None:
    """Each M of ``ms`` through the weight's decode or prefill kernel against
    its plain version, timed rotating through the stacked layers (so the code
    stream is not L2-resident)."""
    from minigpt4_tpu_torch.ops import group_i8 as gq

    n, k = w.n_out, w.n_in
    last = n_stack - 1
    for m in ms:
        x = torch.randn(m, k, generator=gen, device="cuda")
        decode = m <= gq.GQ_MAX_M
        if decode:
            kern, plain = (gq.gq_decode if w.exact else gq.gq_decode_generic), gq.qmatmul_decode_ref
        else:
            kern, plain = (gq.gq_prefill if w.exact else gq.gq_prefill_generic), gq.qmatmul_prefill_ref
        tol = 1e-5 if decode else 2e-3
        got, want = kern(x, w, last), plain(x, w, last)
        torch.cuda.synchronize()
        err, abs_err = rel_err(got, want), float((got - want).abs().max())
        k_ms, p_ms = compare_times(kern, plain, lambda i: (x, w, i % n_stack))
        key = kern.__name__
        b_ms, b_by = gq_bound(w, m)
        results[key].append(dict(shape=f"{name} {n}x{k} M={m}", format=w.dtype.name.lower(),
                                 max_rel_err=err, max_abs_err=abs_err, tol=tol, ms=k_ms,
                                 plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None))
        log(f"[kernels] {key:18s} {w.dtype.name.lower():4s} {name:6s} N={n:5d} K={k:5d} M={m:3d}"
            f"  max_rel_err={err:.3e} (tol {tol:g})  kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms"
            f"  bound {b_ms:.4f} ms ({b_by})  [{card}]")
        if not err <= tol:
            raise AssertionError(f"{key} {name} M={m}: rel err {err} > {tol}")
        if decode:  # device-only: no library call computes the dual-i8 function
            device_row(results[key][-1], f"{key} {w.dtype.name.lower()} {name} {n}x{k} M={m}",
                       device_ms(kern, lambda i: (x, w, i % n_stack), n_stack), None, "", card)
        else:
            prefill_device_row(results[key][-1], f"{key} {w.dtype.name.lower()} {name} {n}x{k} "
                               f"M={m}", kern, w, x, n_stack,
                               w.layer(last).dequantize().to(torch.bfloat16), card)


# packed-code cases, (name, (N, K), format, stacked layers, row counts), at
# the shapes and row counts of the packed chats (decode rows, the prompt's
# PROMPT_M and the image's 32) and the 512-row bucket: the q5_k (p5, exact)
# 13B w13 and w2 (K = 13824, unpadded) and ViT-G fc2, the q6_k (p6, generic)
# 13B output and w2; the 7B mix's q4_k (p4, exact) w13, q4_0 (p4) w2 (K =
# 11008, 43 chunks of 256) and q5_1 (p5) wo; q4_0 and q5_1 at the 13B
# attention projections
PACKED_CASES = (("w13", (27648, 5120), "Q5_K", STACK_13B, (1, 8, PROMPT_M, 512)),
                ("w2", (5120, 13824), "Q5_K", STACK_13B, (1,)),
                ("fc2", (1408, 6144), "Q5_K", STACK_VIT, (257,)),
                ("output", (32000, 5120), "Q6_K", STACK_HEAD, (1, 8)),
                ("w2", (5120, 13824), "Q6_K", STACK_13B, (PROMPT_M, 512)),
                ("w13", (22016, 4096), "Q4_K", STACK_7B, (1, PROMPT_M, 512)),
                ("w2", (4096, 11008), "Q4_0", STACK_7B, (1, 32, PROMPT_M)),
                ("wo", (4096, 4096), "Q5_1", STACK_7B, (1, 32, PROMPT_M)),
                ("attn", (5120, 5120), "Q4_0", STACK_13B, (1, 512)),
                ("attn", (5120, 5120), "Q5_1", STACK_13B, (1, 512)))


def host_us(fn, args_for, n: int = 50) -> float:
    """Host microseconds per call of fn(*args_for(i)), n calls back to back
    with no synchronisation between them (the device queue takes them)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        fn(*args_for(i))
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / n * 1e6


def check_packed(results: dict, card: str, name: str, w, n_stack: int, ms, gen) -> None:
    """The weight packed (group_i8.pack_codes) through the same wrapper,
    which launches the entry on the packed codes: bit-equal to the unpacked
    codes on the same weight (max |d| must be 0), within check_matmul's
    tolerances of the plain version; packed and unpacked timed in turns
    (unpacked, packed, packed, unpacked), the plain version after them; for
    decode rows, the wrapper's host time per call, packed and unpacked."""
    from minigpt4_tpu_torch.ops import group_i8 as gq

    wp = gq.pack_codes(w)
    n, k = w.n_out, w.n_in
    last = n_stack - 1
    for m in ms:
        x = torch.randn(m, k, generator=gen, device=DEVICE)
        decode = m <= gq.GQ_MAX_M
        if decode:
            kern, plain = (gq.gq_decode if w.exact else gq.gq_decode_generic), gq.qmatmul_decode_ref
        else:
            kern, plain = (gq.gq_prefill if w.exact else gq.gq_prefill_generic), gq.qmatmul_prefill_ref
        tol = 1e-5 if decode else 2e-3
        got, twin, want = kern(x, wp, last), kern(x, w, last), plain(x, wp, last)
        torch.cuda.synchronize()
        diff = float((got - twin).abs().max())
        err, abs_err = rel_err(got, want), float((got - want).abs().max())
        p_ms, u_ms = compare_times(lambda xx, li: kern(xx, wp, li), lambda xx, li: kern(xx, w, li),
                                   lambda i: (x, i % n_stack))
        plain_ms = statistics.median(_time_ms(plain, lambda i: (x, wp, i % n_stack), 10))
        host = None
        if decode:  # packed, unpacked, packed
            hp = [host_us(kern, lambda i, v=v: (x, v, i % n_stack)) for v in (wp, w, wp)]
            host = (min(hp[0], hp[2]), hp[1])
        key = f"{kern.__name__}[{wp.packing}]"
        b_ms, b_by = gq_bound(wp, m)
        results[key].append(dict(shape=f"{name} {n}x{k} M={m}", format=w.dtype.name.lower(),
                                 max_rel_err=err, max_abs_err=abs_err, tol=tol,
                                 max_diff_unpacked=diff, ms=p_ms, unpacked_ms=u_ms,
                                 plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                 unpacked_bound_ms=gq_bound(w, m)[0], library_ms=None,
                                 host_us=host))
        log(f"[kernels] {key:22s} {w.dtype.name.lower():4s} {name:6s} N={n:5d} K={k:5d} M={m:3d}"
            f"  max |packed - unpacked| = {diff:g}  max_rel_err={err:.3e} (tol {tol:g})  packed "
            f"{p_ms:.4f} ms  unpacked {u_ms:.4f} ms  plain {plain_ms:.4f} ms  bound {b_ms:.4f} ms "
            f"({b_by}; unpacked {gq_bound(w, m)[0]:.4f} ms)"
            + ("" if host is None else
               f"  host per call {host[0]:.1f} us packed, {host[1]:.1f} us unpacked")
            + f"  [{card}]")
        if diff != 0.0:
            raise AssertionError(f"{key} {name} M={m}: packed and unpacked differ by {diff}")
        if not err <= tol:
            raise AssertionError(f"{key} {name} M={m}: rel err {err} > {tol}")
        if not decode:
            prefill_device_row(results[key][-1], f"{key} {w.dtype.name.lower()} {name} {n}x{k} "
                               f"M={m}", kern, wp, x, n_stack,
                               w.layer(last).dequantize().to(torch.bfloat16), card)
    del wp


def phase_packed_kernels(results: dict, card: str, gen: torch.Generator) -> None:
    """Every packed entry at the PACKED_CASES shapes."""
    from minigpt4_tpu_torch.formats import DataType

    for name, (n, k), fmt, stack, ms in PACKED_CASES:
        dtype = DataType[fmt]
        w = (random_gq(stack, n, k, gen, dtype) if dtype in (DataType.Q4_K, DataType.Q5_K)
             else random_generic(stack, n, k, dtype, gen))
        check_packed(results, card, name, w, stack, ms, gen)
        del w
        torch.cuda.empty_cache()


def random_rq(n_layer: int, n: int, k: int, dtype, gen: torch.Generator):
    """Stacked RepackedQuant made on the card with random codes and high
    bits: q5_k (scales Q5K_D x a 6-bit sub-scale, mins 15.5 Q5K_D x another),
    q6_k (Q6K_D x a signed sub-scale, mins 32 scales), q5_1 (d in [0.5, 1.5)
    x Q51_D, mins 15.5 d) or q8_0 (d in [0.5, 1.5) x 2^-13, signed codes,
    mins 0)."""
    from minigpt4_tpu_torch.formats import DataType
    from minigpt4_tpu_torch.ops import group_i8 as gq
    from minigpt4_tpu_torch.ops import repack as rp

    code_bits, hi_bits = rp.LAYOUT[dtype]
    gs = gq.group_size(dtype)
    shape = (n_layer, n, k // gs)

    def ints(lo, hi, shp, dt=torch.int32):
        return torch.randint(lo, hi, shp, generator=gen, device=DEVICE, dtype=dt)

    def unit():
        return 0.5 + torch.rand(shape, generator=gen, device=DEVICE)

    if code_bits == 8:
        codes = ints(-128, 128, (n_layer, n, k), torch.int8)
    else:
        codes = ints(0, 256, (n_layer, n, k // 2), torch.uint8)
    hi = ints(-2 ** 31, 2 ** 31 - 1, (n_layer, n, k * hi_bits // 32)) if hi_bits else None
    if dtype == DataType.Q5_K:
        scales, mins = Q5K_D * ints(0, 64, shape).float(), 15.5 * Q5K_D * ints(0, 64, shape).float()
    elif dtype == DataType.Q6_K:
        scales = Q6K_D * ints(-128, 128, shape).float()
        mins = 32.0 * scales
    elif dtype == DataType.Q5_1:
        scales = Q51_D * unit()
        mins = 15.5 * scales
    else:
        scales, mins = 2.0 ** -13 * unit(), torch.zeros(shape, device=DEVICE)
    return rp.RepackedQuant(codes=codes, scales=scales.to(torch.bfloat16),
                            mins=mins.to(torch.bfloat16), hi=hi, dtype=dtype, n_in=k,
                            group_size=gs, code_bits=code_bits, hi_bits=hi_bits)


def rq_bound(w, m: int) -> tuple[float, str]:
    """One layer's codes, high bits and planes read once, x [M, K] f32 read
    and y [M, N] f32 written once; 2 M N K operations, in f32 on the CUDA
    cores for the decode entry (M <= 8), in bf16 on the tensor cores for the
    prefill entry."""
    from minigpt4_tpu_torch.ops import pallas_quant_matmul as rq

    layer = nbytes(*w.tensors().values()) / w.scales.shape[0]
    n, k = w.n_out, w.n_in
    return bound(layer + 4 * m * (k + n), 2.0 * m * n * k,
                 F32_FLOPS if m <= rq.RQ_MAX_M else BF16_FLOPS)


# rq tolerances, relative to max|y|: the decode entry keeps x in f32 and
# forms the f32 plain version's weights bit for bit (f32 summation order,
# as gq_decode; tests/test_torch_cuda.py holds it to the same 1e-5); the
# prefill entry
# rounds x and w = scale * q - min to bf16 (2^-9 each per product), against
# the f32 plain version 1e-2 (JAX's own tests hold the TPU kernel to 1.2e-2
# of the same product) and against the plain version with its roundings
# 1e-3 (summation order over K up to 6144)
RQ_DECODE_TOL, RQ_PREFILL_TOL, RQ_PREFILL_SAME_ROUNDING_TOL = 1e-5, 1e-2, 1e-3


def check_rq(results: dict, card: str, name: str, w, n_stack: int, ms, gen) -> None:
    """Each M of ``ms`` through rq_decode or rq_prefill against the f32 plain
    version, timed rotating through the stacked layers."""
    from minigpt4_tpu_torch.ops import pallas_quant_matmul as rq

    n, k = w.n_out, w.n_in
    last = n_stack - 1
    for m in ms:
        x = torch.randn(m, k, generator=gen, device="cuda")
        decode = m <= rq.RQ_MAX_M
        kern = rq.rq_decode if decode else rq.rq_prefill
        got, want = kern(x, w, last), rq.qmatmul_repacked_ref(x, w, last)
        same = None if decode else rq.qmatmul_repacked_prefill_ref(x, w, last)
        torch.cuda.synchronize()
        err, abs_err = rel_err(got, want), float((got - want).abs().max())
        tol = RQ_DECODE_TOL if decode else RQ_PREFILL_TOL
        same_err = None if decode else rel_err(got, same)
        k_ms, p_ms = compare_times(kern, rq.qmatmul_repacked_ref, lambda i: (x, w, i % n_stack))
        key = kern.__name__
        b_ms, b_by = rq_bound(w, m)
        results[key].append(dict(shape=f"{name} {n}x{k} M={m}", format=w.dtype.name.lower(),
                                 max_rel_err=err, max_abs_err=abs_err, tol=tol,
                                 same_rounding_rel_err=same_err, ms=k_ms, plain_ms=p_ms,
                                 bound_ms=b_ms, bound_by=b_by, library_ms=None))
        log(f"[kernels] {key:18s} {w.dtype.name.lower():4s} {name:6s} N={n:5d} K={k:5d} M={m:3d}"
            f"  max_rel_err={err:.3e} (tol {tol:g})"
            + ("" if decode else f", {same_err:.3e} against the bf16-rounding plain version "
               f"(tol {RQ_PREFILL_SAME_ROUNDING_TOL:g})")
            + f"  kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})  [{card}]")
        if not err <= tol:
            raise AssertionError(f"{key} {name} M={m}: rel err {err} > {tol}")
        if not decode and not same_err <= RQ_PREFILL_SAME_ROUNDING_TOL:
            raise AssertionError(f"{key} {name} M={m}: rel err {same_err} against the "
                                 f"bf16-rounding plain version > {RQ_PREFILL_SAME_ROUNDING_TOL}")
        if decode:  # device-only; no single library call multiplies by repacked codes
            device_row(results[key][-1], f"{key} {w.dtype.name.lower()} {name} {n}x{k} M={m}",
                       device_ms(kern, lambda i: (x, w, i % n_stack), n_stack), None, "", card)
        else:
            prefill_device_row(results[key][-1], f"{key} {w.dtype.name.lower()} {name} {n}x{k} "
                               f"M={m}", kern, w, x, n_stack,
                               w.layer(last).dequantize().to(torch.bfloat16), card)


def probe_row(row: dict, label: str, fn, args_for, n_args: int, what: str, card: str) -> None:
    """Add a probe kernel's same-run device-only time at the row's shape to
    a decode row, and the factor kernel / probe."""
    probe = device_ms(fn, args_for, n_args)
    row.update(probe_device_ms=probe, probe_factor=row["device_ms"] / probe)
    log(f"[device-only] {label}  kernel {row['device_ms']:.4f} ms ({100 * row['bound_share']:.1f}"
        f" % of its bound), {what} {probe:.4f} ms, kernel / probe {row['probe_factor']:.3f}  "
        f"[{card}]")


# the 13B decode matmuls as models/llama.py issues them (wq|wk|wv and w1|w3
# fused) and the output head; the Q5_K_M file's q6_k weights: the output,
# wv and w2
DECODE_13B = {"wqkv": (15360, 5120), "wo": (5120, 5120), "w13": (27648, 5120),
              "w2": (5120, 13824), "output": (32000, 5120)}
Q6K_13B = {"output": (32000, 5120), "wv": (5120, 5120), "w2": (5120, 13824)}


def rq_decode_13b_cases(results: dict, card: str, gen: torch.Generator) -> None:
    """rq_decode at the 13B decode shapes, M = 1 and 8: q5_k at the five of
    DECODE_13B, q6_k at those of Q6K_13B; against the plain version and
    device-only beside the bound (check_rq), and beside the same-run time of
    the q5 magic dequantize-matvec probe (qmm_r3's q5u8or, 16-byte copies, the
    probe tools' fastest width at M = 1 and 8) at the same shape."""
    import dataclasses

    from minigpt4_tpu_torch.formats import DataType
    from minigpt4_tpu_torch.ops import probes
    from minigpt4_tpu_torch.tools import _harness

    cases = ([(name, nk, DataType.Q5_K) for name, nk in DECODE_13B.items()]
             + [(name, nk, DataType.Q6_K) for name, nk in Q6K_13B.items()])
    for name, (n, k), dtype in cases:
        stack = STACK_HEAD if name == "output" else STACK_13B
        w = random_rq(stack, n, k, dtype, gen)
        check_rq(results, card, name, w, stack, (1, 8), gen)
        del w
        pw = probes.random_probe_weight("q5", n, k, gen, DEVICE)
        copies = [dataclasses.replace(pw, codes=c, hi=h, scales=sc) for c, h, sc
                  in _harness.rotation((pw.codes, pw.hi, pw.scales), pw.nbytes)]
        for row in results["rq_decode"][-2:]:
            m = int(row["shape"].rsplit("M=", 1)[1])
            x = torch.randn(m, k, generator=gen, device=DEVICE)
            probe_row(row, f"rq_decode {dtype.name.lower()} 13B {name} {n}x{k} M={m}",
                      lambda xx, ww: probes.dequant_matvec(xx, ww, "magic", 16),
                      lambda i: (x, copies[i % len(copies)]), len(copies),
                      "the q5 magic probe (16-byte copies)", card)
        del pw, copies
        torch.cuda.empty_cache()


def phase_rq_kernels(results: dict, card: str, gen: torch.Generator) -> None:
    """The repacked-weight kernels at the shapes of their paths, and the gq
    kernels at the same shapes where gq takes them."""
    from minigpt4_tpu_torch.formats import DataType

    rq_decode_13b_cases(results, card, gen)
    for name, (n, k), dtype, stack, ms in (
            ("fc2", (1408, 6144), DataType.Q5_K, STACK_VIT, (257,)),
            ("fc1", (6144, 1408), DataType.Q5_1, STACK_VIT, (257,)),
            ("qkv", (4224, 1408), DataType.Q8_0, STACK_VIT, (257,)),
            ("qf-int", (3072, 768), DataType.Q5_K, STACK_QF, (32,)),
            ("w13", (27648, 5120), DataType.Q5_K, STACK_13B, (512,))):
        w = random_rq(stack, n, k, dtype, gen)
        check_rq(results, card, name, w, stack, ms, gen)
        del w
        torch.cuda.empty_cache()
    # gq beside them: the exact-plane kernels at the 13B w13 and ViT fc2
    # shapes (gq's q6_k output row is in the generic rows above)
    for name, (n, k), stack, ms in (("w13", (27648, 5120), STACK_13B, (1, 32, 64, 128, 256, 512)),
                                    ("fc2", (1408, 6144), STACK_VIT, (257,))):
        w = random_gq(stack, n, k, gen)
        check_matmul(results, card, name, w, stack, ms, gen)
        del w
        torch.cuda.empty_cache()


def random_i8(n_layer: int, n: int, k: int, gen: torch.Generator):
    """Stacked I8SBQuant made on the card: codes -127..127, superblock scales
    in [0.5, 1.5) x 2^-13."""
    from minigpt4_tpu_torch.ops import i8_matmul as i8

    codes = torch.randint(-127, 128, (n_layer, n, k), generator=gen, device=DEVICE,
                          dtype=torch.int8)
    scales = 2.0 ** -13 * (0.5 + torch.rand((n_layer, n, k // 256), generator=gen, device=DEVICE))
    return i8.I8SBQuant(codes, scales, k)


def int_mm_ms(x_i8: torch.Tensor, w, n_stack: int, reps: int = 10):
    """(median ms around the call, device-only ms) of torch._int_mm (i8 x i8
    -> i32, no chunk scales) on the same operands, rotating through the
    stacked layers; (None, None) where it refuses the shape (it needs M >
    16)."""
    if x_i8.shape[0] <= 16:
        return None, None
    f = torch._int_mm
    try:
        f(x_i8, w.codes[0].t())
    except RuntimeError as e:  # the yardstick, not the port: report and go on
        log(f"[kernels] torch._int_mm refuses [{x_i8.shape[0]}, {x_i8.shape[1]}] x "
            f"[{w.codes.shape[2]}, {w.codes.shape[1]}]: {str(e).splitlines()[0]}")
        return None, None
    torch.cuda.synchronize()
    call = lambda li: f(x_i8, w.codes[li].t())  # noqa: E731
    return (statistics.median(_time_ms(call, lambda i: (i % n_stack,), reps)),
            device_ms(call, lambda i: (i % n_stack,), n_stack))


# i8 tolerances, relative to max|y|: each 256-wide chunk's product is an
# exact i32 in the kernels and in the plain versions (the decode kernel's
# codes bit-equal to quantize_activations), and the scaled chunks add in a
# fixed order; only the f32 summation order differs
I8_DECODE_TOL, I8_PREFILL_TOL = 1e-5, 1e-4


def check_i8(results: dict, card: str, name: str, w, n_stack: int, ms, gen) -> None:
    """Each M of ``ms`` through i8_decode (from f32 x: quantization, chunked
    contraction, row scale) or i8_prefill (x quantized beforehand) against
    its plain version, timed rotating through the stacked layers; the
    decode rows device-only, the prefill rows beside torch._int_mm."""
    from minigpt4_tpu_torch.ops import i8_matmul as i8

    n, k = w.n_out, w.n_in
    last = n_stack - 1
    for m in ms:
        decode = m <= i8.I8_MAX_M
        x = torch.randn(m, k, generator=gen, device=DEVICE)
        if decode:
            kern, plain, xa = i8.i8_decode, i8.qmatmul_i8sb_decode_ref, x
        else:
            kern, plain, xa = i8.i8_prefill, i8.qmatmul_i8sb_ref, i8.quantize_activations(x)[0]
        got, want = kern(xa, w, last), plain(xa, w, last)
        torch.cuda.synchronize()
        err, abs_err = rel_err(got, want), float((got - want).abs().max())
        tol = I8_DECODE_TOL if decode else I8_PREFILL_TOL
        k_ms, p_ms = compare_times(kern, plain, lambda i: (xa, w, i % n_stack))
        lib_ms, lib_dev = (None, None) if decode else int_mm_ms(xa, w, n_stack)
        b_ms, b_by = bound(nbytes(w.codes[0], w.scales[0], xa) + 4 * m * n, 2.0 * m * n * k,
                           INT8_OPS)
        key = kern.__name__
        results[key].append(dict(shape=f"{name} {n}x{k} M={m}", format="i8sb",
                                 max_rel_err=err, max_abs_err=abs_err, tol=tol, ms=k_ms,
                                 plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                                 library_ms=lib_ms))
        lib = ("no library call quantizes x and scales chunks" if decode else
               "torch._int_mm refuses M <= 16" if lib_ms is None else
               f"torch._int_mm (no chunk scales) {lib_ms:.4f} ms")
        log(f"[kernels] {key:18s} i8sb {name:6s} N={n:5d} K={k:5d} M={m:3d}  max_rel_err="
            f"{err:.3e} (tol {tol:g})  kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms  bound "
            f"{b_ms:.4f} ms ({b_by})  {lib}  [{card}]")
        if not err <= tol:
            raise AssertionError(f"{key} {name} M={m}: rel err {err} > {tol}")
        device_row(results[key][-1], f"{key} {name} {n}x{k} M={m}",
                   device_ms(kern, lambda i: (xa, w, i % n_stack), n_stack), lib_dev,
                   "torch._int_mm", card)


def phase_i8_kernels(results: dict, card: str, gen: torch.Generator) -> None:
    """i8_decode at the 13B decode shapes (DECODE_13B, M = 1 and 8), each
    beside the same-run time of the i8 x i8 probe (probe_int4's i8xi8: x
    quantized beforehand, no chunk scales) at the same shape, and
    i8_prefill at the shapes of the w8a8 path: the 13B w13 at the 512-row
    bucket, ViT-G fc2 at the 257-row image and the Q-Former intermediate at
    its 32 queries; each against its plain version."""
    from minigpt4_tpu_torch.ops import probes
    from minigpt4_tpu_torch.tools import _harness

    for name, (n, k) in DECODE_13B.items():
        stack = STACK_HEAD if name == "output" else STACK_13B
        w = random_i8(stack, n, k, gen)
        check_i8(results, card, name, w, stack, (1, 8), gen)
        del w
        wp = torch.randint(-127, 127, (n, k), generator=gen, device=DEVICE, dtype=torch.int8)
        copies = _harness.rotation((wp,), wp.numel())
        for row in results["i8_decode"][-2:]:
            m = int(row["shape"].rsplit("M=", 1)[1])
            x_i8 = torch.randint(-127, 127, (m, k), generator=gen, device=DEVICE,
                                 dtype=torch.int8)
            probe_row(row, f"i8_decode 13B {name} {n}x{k} M={m}",
                      lambda xx, ww: probes.int_dot(xx, ww, None, "i8xi8"),
                      lambda i: (x_i8, copies[i % len(copies)][0]), len(copies),
                      "the i8 x i8 probe", card)
        del wp, copies
        torch.cuda.empty_cache()
    for name, (n, k), stack, ms in (("w13", (27648, 5120), STACK_13B, (512,)),
                                    ("fc2", (1408, 6144), STACK_VIT, (257,)),
                                    ("qf-int", (3072, 768), STACK_QF, (32,))):
        w = random_i8(stack, n, k, gen)
        check_i8(results, card, name, w, stack, ms, gen)
        del w
        torch.cuda.empty_cache()


# e4m3 caches read as the same values in the kernel and in cache_f32
# (_block_f32's function); f32 online softmax against f32 softmax on unit inputs
E4M3_FLASH_TOL = 1e-5


def e4m3_flash_cases(results: dict, card: str, gen: torch.Generator) -> None:
    """The flash kernels over e4m3 caches: dense at the Vicuna-7B cache
    (32 heads of 128, 2048 positions) with S = 1, 8, 32 at pos0 = 2015, and
    paged at the Vicuna-13B serving pools of paged_kernel_case; against
    their plain versions, the paged kernel against the dense kernel on the
    gathered cache (bits), and SDPA on the cache cast to bf16."""
    from minigpt4_tpu_torch.ops import flash_decode as fd

    f8 = torch.float8_e4m3fn
    h, dh, c, pos = 32, 128, 2048, 2015
    ck, cv = (torch.randn((STACK_7B, 1, h, c, dh), generator=gen, device=DEVICE).to(f8)
              for _ in range(2))
    last, scale = STACK_7B - 1, dh ** -0.5
    for s in (1, 8, 32):
        q = torch.randn((1, h, s, dh), generator=gen, device=DEVICE)
        got = fd.flash_decode_attention(q, ck, cv, last, pos, scale)
        want = fd.flash_decode_ref(q, ck, cv, last, pos, scale)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        k_ms, p_ms = compare_times(fd.flash_decode_attention, fd.flash_decode_ref,
                                   lambda i: (q, ck, cv, i % STACK_7B, pos, scale))
        keys = min(pos + s, c)
        b_ms, b_by = attention_bound(1, h, s, dh, keys, 1)
        pos_v = torch.full((1,), pos, dtype=torch.int32, device=DEVICE)
        lib_ms = sdpa_ms(q, ck, cv, pos_v, scale, STACK_7B)
        results["flash_decode"].append(dict(shape=f"e4m3 B=1 S={s} pos0={pos}", max_abs_err=err,
                                            tol=E4M3_FLASH_TOL, ms=k_ms, plain_ms=p_ms,
                                            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms))
        log(f"[kernels] flash_decode e4m3 B=1 H={h} S={s:2d} C={c} pos0={pos}  max_abs_err="
            f"{err:.3e} (tol {E4M3_FLASH_TOL:g})  kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms  "
            f"bound {b_ms:.4f} ms ({b_by})  sdpa on the bf16 cache {lib_ms:.4f} ms  [{card}]")
        if not err <= E4M3_FLASH_TOL:
            raise AssertionError(f"flash_decode e4m3 S={s}: abs err {err} > {E4M3_FLASH_TOL}")
        device_row(results["flash_decode"][-1], f"flash_decode e4m3 B=1 H={h} S={s} pos0={pos}",
                   device_ms(fd.flash_decode_attention,
                             lambda i: (q, ck, cv, i % STACK_7B, pos, scale), STACK_7B),
                   sdpa_ms(q, ck, cv, pos_v, scale, STACK_7B, device_only=True),
                   "sdpa on the bf16 cache", card)
    del ck, cv
    torch.cuda.empty_cache()
    paged_kernel_case(results, card, gen, f8)


def chat_flash_case(results: dict, card: str, gen: torch.Generator) -> None:
    """The chats' own decode attention: Vicuna-13B B = 1, 40 heads of 128, S =
    1 at pos0 = 240 (the live range of the smoke chats' decode) over a 2048-
    position cache rotating through 40 layers, bf16 and e4m3: against the
    plain version (1e-5) and SDPA, timed around the call and device-only."""
    from minigpt4_tpu_torch.ops import flash_decode as fd

    h, dh, c, pos, s = 40, 128, 2048, 240, 1
    scale, last = dh ** -0.5, STACK_13B - 1
    pos_v = torch.full((1,), pos, dtype=torch.int32, device=DEVICE)
    for dtype in (torch.bfloat16, torch.float8_e4m3fn):
        tag = "e4m3 " if dtype == torch.float8_e4m3fn else ""
        ck, cv = (torch.randn((STACK_13B, 1, h, c, dh), generator=gen, device=DEVICE).to(dtype)
                  for _ in range(2))
        q = torch.randn((1, h, s, dh), generator=gen, device=DEVICE)
        got = fd.flash_decode_attention(q, ck, cv, last, pos, scale)
        want = fd.flash_decode_ref(q, ck, cv, last, pos, scale)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        args = lambda i: (q, ck, cv, i % STACK_13B, pos, scale)  # noqa: E731
        k_ms, p_ms = compare_times(fd.flash_decode_attention, fd.flash_decode_ref, args)
        b_ms, b_by = attention_bound(1, h, s, dh, pos + s, ck.element_size())
        results["flash_decode"].append(dict(
            shape=f"{tag}13B chat B=1 H={h} S={s} pos0={pos}", max_abs_err=err,
            tol=E4M3_FLASH_TOL, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=sdpa_ms(q, ck, cv, pos_v, scale, STACK_13B)))
        log(f"[kernels] flash_decode {tag}13B chat B=1 H={h} S={s} C={c} pos0={pos}  max_abs_err="
            f"{err:.3e} (tol {E4M3_FLASH_TOL:g})  kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms  bound "
            f"{b_ms:.4f} ms ({b_by})  sdpa {results['flash_decode'][-1]['library_ms']:.4f} ms  "
            f"[{card}]")
        if not err <= E4M3_FLASH_TOL:
            raise AssertionError(f"flash_decode {tag}13B chat: abs err {err} > {E4M3_FLASH_TOL}")
        device_row(results["flash_decode"][-1], f"flash_decode {tag}13B chat S=1 pos0={pos}",
                   device_ms(fd.flash_decode_attention, args, STACK_13B),
                   sdpa_ms(q, ck, cv, pos_v, scale, STACK_13B, device_only=True),
                   "sdpa" + (" on the bf16 cache" if tag else ""), card)
        del ck, cv
        torch.cuda.empty_cache()


# phase 3's sections, in order; ``--only-kernels a,b`` runs those alone
KERNEL_SECTIONS = ("gq", "flash", "chat_flash", "paged", "rq", "i8", "e4m3", "packed", "stats")


def phase_kernels(card: str, only: set | None = None) -> dict:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    results = {k: [] for k in KERNELS + PACKED_KERNELS + (STATS,)}

    def want(section: str) -> bool:
        return only is None or section in only

    if want("gq"):
        phase_gq_kernels(results, card, gen)
    if want("flash"):
        phase("kernels: flash")
        dense_flash_cases(results, card, gen)
    for section, label, fn in (("chat_flash", "chat flash", chat_flash_case),
                               ("paged", "paged flash", paged_kernel_case),
                               ("rq", "repacked", phase_rq_kernels),
                               ("i8", "i8", phase_i8_kernels),
                               ("e4m3", "e4m3 flash", e4m3_flash_cases),
                               ("packed", "packed gq", phase_packed_kernels),
                               ("stats", "flash stats", flash_stats_cases)):
        if want(section):
            phase(f"kernels: {label}")
            fn(results, card, gen)
    return results


# the 13B decode matmuls of a q5_k file's exact planes (the q6_k output is a
# generic-plane row)
GQ_13B_DECODE = {k: v for k, v in DECODE_13B.items() if k != "output"}


def gq_decode_13b_cases(results: dict, card: str, gen: torch.Generator) -> None:
    """The dual-i8 decode kernel at the 13B exact-plane shapes, M = 1 and 8:
    against its plain version and device-only (check_matmul), beside the
    probe's same-run time: the dual-i8 probe kernel on the same codes, x
    split beforehand and not timed."""
    from minigpt4_tpu_torch.ops import group_i8 as gq
    from minigpt4_tpu_torch.ops import probes

    for name, (n, k) in GQ_13B_DECODE.items():
        w = random_gq(STACK_13B, n, k, gen)
        a = (Q5K_D * torch.randint(0, 64, (STACK_13B, k // 32, n), generator=gen,
                                   device=DEVICE).float()).to(torch.bfloat16)
        b = -a
        check_matmul(results, card, f"13B {name}", w, STACK_13B, (1, 8), gen)
        for row in results["gq_decode"][-2:]:
            m = int(row["shape"].rsplit("M=", 1)[1])
            x = torch.randn(m, k, generator=gen, device=DEVICE)
            x1, x2, s1, s2 = gq.split_activations(x)
            s12, sgt = torch.cat([s1, s2], 1), gq.group_sums(x)
            probe_row(row, f"gq_decode 13B {name} {n}x{k} M={m}", probes.probe_group_i8,
                      lambda i: (x1, x2, s12, sgt, w.codes, a, b, i % STACK_13B), STACK_13B,
                      "the dual-i8 probe (x split outside)", card)
        del w, a, b
        torch.cuda.empty_cache()


def phase_gq_kernels(results: dict, card: str, gen: torch.Generator) -> None:
    """The gq kernels against their plain versions at the 7B and 13B shapes."""
    from minigpt4_tpu_torch.formats import DataType

    gq_decode_13b_cases(results, card, gen)

    # exact planes at the Vicuna-7B shapes
    d, ff, v = 4096, 11008, 32000
    for name, (n, k) in {"wqkv": (3 * d, d), "wo": (d, d), "w13": (2 * ff, d), "w2": (d, ff),
                         "output": (v, d)}.items():
        w = random_gq(STACK_7B, n, k, gen)
        ms = (1, 8, 32, 512) if name in ("wqkv", "w13", "w2") else (1, 8)
        check_matmul(results, card, name, w, STACK_7B, ms, gen)
        del w
        torch.cuda.empty_cache()
    # generic planes at the Vicuna-13B shapes: the Q5_K_M file's q6_k output,
    # wv and w2, and q8_0 (group 32, signed codes) at the fused w13
    d, ff = 5120, 13824
    for name, (n, k), dtype, ms in (("output", (v, d), DataType.Q6_K, (1, 8)),
                                    ("wv", (d, d), DataType.Q6_K, (1, 8)),
                                    ("w2", (d, ff), DataType.Q6_K, (1, 8, 32, 256, 512)),
                                    ("w13", (2 * ff, d), DataType.Q8_0, (1, 512))):
        w = random_generic(STACK_13B, n, k, dtype, gen)
        check_matmul(results, card, name, w, STACK_13B, ms, gen)
        del w
        torch.cuda.empty_cache()


def dense_flash_cases(results: dict, card: str, gen: torch.Generator) -> None:
    """Dense flash decode over bf16 caches at the Vicuna-7B cache (32 heads
    of 128, 2048 positions): B = 1 at S = 1, 8, 32 and four cursors, and a
    ragged B = 4, against the plain version and SDPA."""
    from minigpt4_tpu_torch.ops import flash_decode as fd

    h, dh, c = 32, 128, 2048
    last = STACK_7B - 1
    cases = [(1, s, p) for s in (1, 8, 32) for p in (0, 127, 1000, 2015)]
    cases += [(4, s, [0, 127, 1000, 2015]) for s in (1, 8, 32)]
    caches = {}
    for b, s, pos in cases:
        if b not in caches:
            caches[b] = [torch.randn((STACK_7B, b, h, c, dh), generator=gen, device="cuda")
                         .to(torch.bfloat16) for _ in range(2)]
        ck, cv = caches[b]
        q = torch.randn((b, h, s, dh), generator=gen, device="cuda")
        pos_t = (torch.tensor(pos, dtype=torch.int32, device="cuda") if isinstance(pos, list)
                 else pos)
        scale = dh ** -0.5
        got = fd.flash_decode_attention(q, ck, cv, last, pos_t, scale)
        want = fd.flash_decode_ref(q, ck, cv, last, pos_t, scale)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        k_ms, p_ms = compare_times(fd.flash_decode_attention, fd.flash_decode_ref,
                                   lambda i: (q, ck, cv, i % STACK_7B, pos_t, scale))
        pos_v = fd.pos_vector(pos_t, b, "cuda")
        keys = int((pos_v + s).clamp(max=c).sum())
        b_ms, b_by = attention_bound(b, h, s, dh, keys, 2)
        lib_ms = sdpa_ms(q, ck, cv, pos_v, scale, STACK_7B)
        results["flash_decode"].append(dict(shape=f"B={b} S={s} pos0={pos}", max_abs_err=err,
                                            tol=1e-3, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                                            bound_by=b_by, library_ms=lib_ms))
        log(f"[kernels] flash_decode B={b} H={h} S={s:2d} C={c} pos0={pos}  max_abs_err={err:.3e}"
            f" (tol 1e-3)  kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms  bound {b_ms:.4f} ms "
            f"({b_by})  sdpa {lib_ms:.4f} ms  [{card}]")
        if not err <= 1e-3:
            raise AssertionError(f"flash_decode B={b} S={s} pos0={pos}: abs err {err} > 1e-3")
        device_row(results["flash_decode"][-1], f"flash_decode bf16 B={b} H={h} S={s} pos0={pos}",
                   device_ms(fd.flash_decode_attention,
                             lambda i: (q, ck, cv, i % STACK_7B, pos_t, scale), STACK_7B),
                   sdpa_ms(q, ck, cv, pos_v, scale, STACK_7B, device_only=True), "sdpa", card)
    del caches
    torch.cuda.empty_cache()


# the merge of C-slice partials against the kernel on the whole cache: f32
# online softmax regrouped (JAX's bound for its SP merge)
SP_TOL = 2e-5
STATS_TOL = 1e-5  # partials against their plain version: f32 sums in another order


def flash_stats_cases(results: dict, card: str, gen: torch.Generator) -> None:
    """The stats mode of flash decode at Vicuna-13B attention shapes (B = 1,
    40 heads of 128, a bf16 cache of 2048 positions rotating through 40
    layers) split into 4 slices of 512 positions, as 4 sequence-parallel
    ranks hold it: S = 1 and 8 at pos0 = 700 (two slices empty: negative
    cursors) and 2015, and one e4m3 case.  Each slice's (acc, m, l) against
    flash_decode_stats_ref (m to STATS_TOL absolute, l and acc to STATS_TOL
    of their maximum, exact zeros and m = -inf where a row sees no key), the
    normalized launch on the slice against acc / l of the stats launch (bit
    for bit), and the merge of the 4 slices against the normalized kernel on
    the whole cache (SP_TOL).  Per slice: the stats launch, the normalized
    launch, the plain version and SDPA with a boolean mask, timed, and the
    bound of the slice's live rows."""
    from minigpt4_tpu_torch.ops import flash_decode as fd

    h, dh, c, n_sl = 40, 128, 2048, 4
    cl, last, scale = c // n_sl, STACK_13B - 1, dh ** -0.5

    def stats(*a):
        return fd.flash_decode_attention(*a, return_stats=True)

    for dtype, cases in ((torch.bfloat16, [(s, p) for p in (700, 2015) for s in (1, 8)]),
                         (torch.float8_e4m3fn, [(1, 2015)])):
        tag = "e4m3 " if dtype == torch.float8_e4m3fn else ""
        ck, cv = (torch.randn((STACK_13B, 1, h, c, dh), generator=gen, device=DEVICE).to(dtype)
                  for _ in range(2))
        slices = [(ck[:, :, :, i * cl:(i + 1) * cl].contiguous(),
                   cv[:, :, :, i * cl:(i + 1) * cl].contiguous()) for i in range(n_sl)]
        for s, pos in cases:
            q = torch.randn((1, h, s, dh), generator=gen, device=DEVICE)
            whole = fd.flash_decode_attention(q, ck, cv, last, pos, scale)
            parts, rows = [], []
            for i, (ks, vs) in enumerate(slices):
                p_loc = pos - i * cl
                acc, m, l = stats(q, ks, vs, last, p_loc, scale)
                wacc, wm, wl = fd.flash_decode_stats_ref(q, ks, vs, last, p_loc, scale)
                torch.cuda.synchronize()
                empty = torch.isneginf(wm)
                if not (torch.equal(torch.isneginf(m), empty) and (l[empty] == 0).all()
                        and (acc[empty] == 0).all()):
                    raise AssertionError(f"flash stats {tag}S={s} pos0={pos} slice {i}: a row "
                                         "that sees no key has nonzero partials")
                live = ~empty
                err_m = float((m[live] - wm[live]).abs().max()) if live.any() else 0.0
                err_l, err_acc = (rel_err(l, wl), rel_err(acc, wacc)) if live.any() else (0.0, 0.0)
                norm = fd.flash_decode_attention(q, ks, vs, last, p_loc, scale)
                bits = bool(torch.equal(norm, acc / l[..., None])) if not empty.any() else None
                if not (err_m <= STATS_TOL and err_l <= STATS_TOL and err_acc <= STATS_TOL):
                    raise AssertionError(f"flash stats {tag}S={s} pos0={pos} slice {i}: m err "
                                         f"{err_m}, l rel {err_l}, acc rel {err_acc} > {STATS_TOL}")
                if bits is False:
                    raise AssertionError(f"flash stats {tag}S={s} pos0={pos} slice {i}: the "
                                         "normalized launch is not acc / l of the stats launch")
                args = lambda j, ks=ks, vs=vs, p_loc=p_loc: (q, ks, vs, j % STACK_13B, p_loc,  # noqa: E731
                                                             scale)
                k_ms, p_ms = compare_times(stats, fd.flash_decode_stats_ref, args)
                n_ms = statistics.median(_time_ms(fd.flash_decode_attention, args, 20))
                keys = max(0, min(p_loc + s, cl))
                b_ms, b_by = bound(2 * keys * h * dh * ks.element_size() + 2 * h * s * dh * 4
                                   + 2 * h * s * 4, 4.0 * s * dh * keys * h, F32_FLOPS)
                lib_ms = (sdpa_ms(q, ks, vs, torch.full((1,), p_loc, dtype=torch.int32,
                                                          device=DEVICE), scale, STACK_13B)
                          if keys > 0 else None)
                dev = device_ms(stats, args, STACK_13B)
                lib_dev = (sdpa_ms(q, ks, vs, torch.full((1,), p_loc, dtype=torch.int32,
                                                         device=DEVICE), scale, STACK_13B,
                                   device_only=True) if keys > 0 else None)
                parts.append((acc, m, l))
                rows.append(dict(shape=f"{tag}B=1 S={s} pos0={pos} slice {i}",
                                 max_abs_err=max(err_m, float((acc - wacc).abs().max()),
                                                 float((l - wl).abs().max())),
                                 rel_err_l=err_l, rel_err_acc=err_acc, tol=STATS_TOL,
                                 null_ml_bits_equal=bits, ms=k_ms, normalized_ms=n_ms,
                                 plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms))
                log(f"[kernels] flash_decode stats {tag}B=1 H={h} S={s} pos0={pos} slice {i} "
                    f"(local cursor {p_loc}, {keys} live keys)  m err {err_m:.2e}, l rel "
                    f"{err_l:.2e}, acc rel {err_acc:.2e} (tol {STATS_TOL:g}); normalized launch "
                    f"{'= acc / l bit for bit' if bits else 'not compared (a row sees no key)'}"
                    f"  stats {k_ms:.4f} ms  normalized {n_ms:.4f} ms  plain {p_ms:.4f} ms  "
                    f"bound {b_ms:.4f} ms ({b_by})  sdpa "
                    f"{'none (no live key)' if lib_ms is None else f'{lib_ms:.4f} ms'}  [{card}]")
                device_row(rows[-1], f"flash_decode stats {tag}S={s} pos0={pos} slice {i}", dev,
                           lib_dev, "sdpa", card)
            merged = fd.merge_partials(parts)
            torch.cuda.synchronize()
            merge_err = float((merged - whole).abs().max())
            for r in rows:
                r["merge_err"] = merge_err
            results[STATS].extend(rows)
            log(f"[kernels] flash_decode stats {tag}S={s} pos0={pos}: merge of {n_sl} slices "
                f"against the kernel on the whole cache, max abs err {merge_err:.3e} "
                f"(tol {SP_TOL:g})  [{card}]")
            if not merge_err <= SP_TOL:
                raise AssertionError(f"flash stats {tag}S={s} pos0={pos}: merged partials differ "
                                     f"from the whole-cache kernel by {merge_err} > {SP_TOL}")
        del ck, cv, slices
        torch.cuda.empty_cache()


def sdpa_ms(q, ck, cv, pos, scale: float, n_stack: int, reps: int = 20,
            device_only: bool = False) -> float:
    """Median ms of torch's scaled_dot_product_attention on the live part of
    the stacked cache [L, B, H, C, Dh] (bf16 q, boolean causal mask),
    rotating through the layers: the one PyTorch call for this function.
    Timed around the call, or with ``device_only`` as a CUDA graph
    (:func:`device_ms`)."""
    b, h, s, dh = q.shape
    c = min(int(pos.max()) + s, ck.shape[3])
    if ck.element_size() == 1:  # an e4m3 cache: SDPA on it cast to bf16, outside the timing
        ck, cv = ck[:, :, :, :c].to(torch.bfloat16), cv[:, :, :, :c].to(torch.bfloat16)
    qb = q.to(ck.dtype)
    mask = sdpa_mask(pos, s, c)
    f = torch.nn.functional.scaled_dot_product_attention

    def call(li):
        return f(qb, ck[li, :, :, :c], cv[li, :, :, :c], attn_mask=mask, scale=scale)

    call(0)
    torch.cuda.synchronize()
    if device_only:
        return device_ms(call, lambda i: (i % n_stack,), n_stack)
    return statistics.median(_time_ms(call, lambda i: (i % n_stack,), reps))


def paged_kernel_case(results: dict, card: str, gen: torch.Generator,
                      dtype: torch.dtype = torch.bfloat16) -> None:
    """The paged kernel at Vicuna-13B serving shapes over ``dtype`` pools
    against its plain version, the dense kernel on the gathered cache (bits)
    and SDPA."""
    from minigpt4_tpu_torch.ops import flash_decode as fd

    b, h, dh, n_pages, maxp = 8, 40, 128, 64, 4
    w = maxp + 1
    shape = (STACK_13B, n_pages + 1, h, 128, dh)
    pk = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    pv = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    e4m3 = dtype == torch.float8_e4m3fn
    tol, tag = (E4M3_FLASH_TOL, "e4m3 ") if e4m3 else (1e-3, "")
    table = torch.full((b, w), n_pages, dtype=torch.int32, device="cuda")
    perm = torch.randperm(n_pages, generator=gen, device="cuda")[: b * maxp]
    table[:, :maxp] = perm.reshape(b, maxp).int()
    # a fresh lane, page edges, a full lane, and lane 7 past its capacity
    pos = torch.tensor([0, 37, 127, 128, 255, 300, 511, 600], dtype=torch.int32, device="cuda")
    # the gathered dense caches [L, B, H, 128 W, Dh] for the comparisons
    ck, cv = (p[:, table.long()].permute(0, 1, 3, 2, 4, 5).reshape(STACK_13B, b, h, w * 128, dh)
              .contiguous() for p in (pk, pv))
    last, scale = STACK_13B - 1, dh ** -0.5
    for s in (1, 8):
        q = torch.randn((b, h, s, dh), generator=gen, device="cuda")
        got = fd.paged_flash_decode_attention(q, pk, pv, last, pos, table, scale)
        want = fd.paged_flash_decode_ref(q, pk, pv, last, pos, table, scale)
        dense = fd.flash_decode_attention(q, ck, cv, last, pos, scale)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        dense_diff = float((got - dense).abs().max())
        k_ms, p_ms = compare_times(fd.paged_flash_decode_attention, fd.paged_flash_decode_ref,
                                   lambda i: (q, pk, pv, i % STACK_13B, pos, table, scale))
        keys = int((pos + s).clamp(max=w * 128).sum())
        b_ms, b_by = attention_bound(b, h, s, dh, keys, pk.element_size())
        lib_ms = sdpa_ms(q, ck, cv, pos, scale, STACK_13B)
        results["paged_flash_decode"].append(dict(
            shape=f"{tag}B={b} S={s} pos0={pos.tolist()}", max_abs_err=err, tol=tol,
            dense_bits_equal=dense_diff == 0.0, dense_max_diff=dense_diff, ms=k_ms,
            plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms))
        log(f"[kernels] paged_flash_decode {tag}B={b} H={h} S={s} pages {n_pages}+1 table "
            f"{maxp}+1 pos0={pos.tolist()}  max_abs_err={err:.3e} (tol {tol:g})  dense kernel on "
            f"the gathered cache: {'bit-equal' if dense_diff == 0 else f'max diff {dense_diff:.3e}'}"
            f"  kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})  "
            f"sdpa{' on the bf16 cache' if e4m3 else ''} {lib_ms:.4f} ms  [{card}]")
        if not err <= tol:
            raise AssertionError(f"paged_flash_decode {tag}S={s}: abs err {err} > {tol}")
        if dense_diff != 0.0:
            raise AssertionError(f"paged_flash_decode S={s}: differs from the dense kernel on "
                                 f"the gathered cache by {dense_diff}")
        device_row(results["paged_flash_decode"][-1],
                   f"paged_flash_decode {tag}B={b} H={h} S={s}",
                   device_ms(fd.paged_flash_decode_attention,
                             lambda i: (q, pk, pv, i % STACK_13B, pos, table, scale), STACK_13B),
                   sdpa_ms(q, ck, cv, pos, scale, STACK_13B, device_only=True),
                   "sdpa" + (" on the bf16 cache" if e4m3 else ""), card)
    del pk, pv, ck, cv
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 4: synthetic full-width model files
# ---------------------------------------------------------------------------


def _rand_u8(n: int, gen: torch.Generator) -> np.ndarray:
    return torch.randint(0, 256, (n,), generator=gen, device=DEVICE, dtype=torch.uint8).cpu().numpy()


def _randn_f16(shape, std: float, gen: torch.Generator) -> np.ndarray:
    t = torch.randn(shape, generator=gen, device=DEVICE) * std
    return t.half().cpu().numpy()


def _q5k_bytes(n: int, k: int, gen: torch.Generator) -> np.ndarray:
    """Raw q5_k blocks of an [n, k] weight: random code and scale bytes, a
    fixed f16 d and dmin = 15.5 * d, so every group has zero mean weight in
    expectation (a common-mode mean collapses a deep random model)."""
    blk = _rand_u8(n * k // 256 * 176, gen).reshape(-1, 176)
    blk[:, 0:2] = np.array([Q5K_D], np.float16).view(np.uint8)
    blk[:, 2:4] = np.array([15.5 * Q5K_D], np.float16).view(np.uint8)
    return blk.reshape(-1)


def _q6k_bytes(n: int, k: int, gen: torch.Generator) -> np.ndarray:
    """Raw q6_k blocks of an [n, k] weight: random ql, qh and signed sub-scale
    bytes (zero mean weight in expectation) and a fixed f16 d, Q6K_D, that
    matches the q5_k weights' spread."""
    blk = _rand_u8(n * k // 256 * 210, gen).reshape(-1, 210)
    blk[:, 208:210] = np.array([Q6K_D], np.float16).view(np.uint8)
    return blk.reshape(-1)


def _q5_1_bytes(n: int, k: int, gen: torch.Generator) -> np.ndarray:
    """Raw q5_1 blocks of an [n, k] weight: random code and high-bit bytes, a
    fixed f16 d = Q51_D and m = -15.5 d (zero mean weight, std 0.02, the f16
    container's spread)."""
    blk = _rand_u8(n * k // 32 * 24, gen).reshape(-1, 24)
    blk[:, 0:2] = np.array([Q51_D], np.float16).view(np.uint8)
    blk[:, 2:4] = np.array([-15.5 * Q51_D], np.float16).view(np.uint8)
    return blk.reshape(-1)


def _q4k_bytes(n: int, k: int, gen: torch.Generator) -> np.ndarray:
    """Raw q4_k blocks of an [n, k] weight: random code and scale bytes, a
    fixed f16 d = Q4K_D and dmin = 7.5 d (zero mean weight in expectation)."""
    blk = _rand_u8(n * k // 256 * 144, gen).reshape(-1, 144)
    blk[:, 0:2] = np.array([Q4K_D], np.float16).view(np.uint8)
    blk[:, 2:4] = np.array([7.5 * Q4K_D], np.float16).view(np.uint8)
    return blk.reshape(-1)


def _q4_0_bytes(n: int, k: int, gen: torch.Generator) -> np.ndarray:
    """Raw q4_0 blocks of an [n, k] weight: random code bytes and a fixed f16
    d = Q40_D (w = d (q - 8): zero mean weight)."""
    blk = _rand_u8(n * k // 32 * 18, gen).reshape(-1, 18)
    blk[:, 0:2] = np.array([Q40_D], np.float16).view(np.uint8)
    return blk.reshape(-1)


# container formats: (DataType name, block elements, raw block writer)
CONTAINER_QUANTS = {"q5_k": ("Q5_K", 256, _q5k_bytes), "q5_1": ("Q5_1", 32, _q5_1_bytes)}


def more_bits(i: int, n_layer: int) -> bool:
    """llama.cpp's use_more_bits: the layers whose wv and w2 Q5_K_M makes q6_k."""
    return i < n_layer // 8 or i >= 7 * n_layer // 8 or (i - n_layer // 8) % 3 == 2


def write_llm(path: Path, gen: torch.Generator, geo: dict) -> None:
    """ggjt-v3 LLaMA with a vocab of the 3 specials, the 256 byte tokens and
    filler pieces.  Layout "q5_k": every projection q5_k, f16 token
    embeddings.  Layout "q5_k_m", what llama.cpp's quantizer writes for
    "q5_k": output q6_k, wv and w2 q6_k on the more_bits layers, every other
    2-D weight q5_k, token embeddings included.  Layout "q4_mix": wq, wk,
    wv, w1 and w3 q4_k, wo q5_1, w2 q4_0, output q6_k, f16 token
    embeddings."""
    from minigpt4_tpu_torch.formats import DataType, LlamaFileWriter, LlamaHParams, LlamaVocab

    d, n_layer, v = geo["n_embd"], geo["n_layer"], geo["n_vocab"]
    km, mix = geo["layout"] == "q5_k_m", geo["layout"] == "q4_mix"
    hp = LlamaHParams(n_vocab=v, n_embd=d, n_mult=geo["n_mult"], n_head=geo["n_head"],
                      n_layer=n_layer, n_rot=d // geo["n_head"], ftype=17 if km else 16)
    ff = hp.n_ff
    toks = [b"<unk>", b"<s>", b"</s>"] + [bytes([i]) for i in range(256)]
    toks += [f"w{i}".encode() for i in range(v - len(toks))]
    w = LlamaFileWriter(path, hp, LlamaVocab(tokens=toks, scores=[0.0] * v))

    def f32(name, a):
        a = np.ascontiguousarray(a, "<f4")
        w.add_tensor(name, a.shape, DataType.F32, a.view(np.uint8).reshape(-1))

    def quant(name, n, k, q6=False):
        fmt = "Q6_K" if q6 else "Q5_K"
        if mix:  # by the name without its "layers.<i>." prefix
            fmt = Q4_MIX.get(name.split(".", 2)[-1] if name.startswith("layers.") else name, "Q4_K")
        writer = {"Q6_K": _q6k_bytes, "Q5_K": _q5k_bytes, "Q4_K": _q4k_bytes, "Q5_1": _q5_1_bytes,
                  "Q4_0": _q4_0_bytes}[fmt]
        w.add_tensor(name, (n, k), DataType[fmt], writer(n, k, gen))

    if km:
        quant("tok_embeddings.weight", v, d)
    else:
        emb = _randn_f16((v, d), 1.0, gen)
        w.add_tensor("tok_embeddings.weight", (v, d), DataType.F16, emb.view(np.uint8).reshape(-1))
    f32("norm.weight", np.ones(d))
    quant("output.weight", v, d, q6=km)
    for i in range(n_layer):
        p = f"layers.{i}."
        big = km and more_bits(i, n_layer)
        f32(p + "attention_norm.weight", np.ones(d))
        for t in ("wq", "wk", "wv", "wo"):
            quant(p + f"attention.{t}.weight", d, d, q6=big and t == "wv")
        f32(p + "ffn_norm.weight", np.ones(d))
        quant(p + "feed_forward.w1.weight", ff, d)
        quant(p + "feed_forward.w2.weight", d, ff, q6=big)
        quant(p + "feed_forward.w3.weight", ff, d)
    w.write()


def write_container(path: Path, gen: torch.Generator, geo: dict) -> None:
    """Container with ViT-G (depth 39, d 1408, 16 heads of 88, MLP 6144, 224
    px / patch 14), ln_vision, the Q-Former (12 layers, hidden 768, 32
    queries, cross-attention on even layers) and llama_proj from 768 to the
    decoder's width (``geo["out"]``).  All f16, or with ``geo["quant"]``
    ("q5_k", "q5_1") random blocks of that format in every weight the
    reference's quantizer would quantize (quantize.py ``_eligible``: the ViT
    and Q-Former projection weights) whose K divides into its blocks."""
    from minigpt4_tpu_torch.formats import ContainerWriter, DataType

    vd, depth, mlp = geo["width"], geo["depth"], geo["mlp"]
    hid, qf_layers, nq = geo["hidden"], geo["qf_layers"], geo["queries"]
    inter, out_d = geo["intermediate"], geo["out"]
    quant = CONTAINER_QUANTS.get(geo.get("quant"))
    cfg = {"ftype": "f16", "vit": {"head_dim": 88},
           "Qformer": {"encoder_width": vd, "query_length": nq, "num_hidden_layers": qf_layers,
                       "hidden_size": hid, "num_attention_heads": geo["qf_heads"],
                       "intermediate_size": inter}}
    cw = ContainerWriter(path, ftype=0, config=cfg)

    def add(lst, name, shape, std=0.02, const=None):
        if quant and name.endswith(".weight") and len(shape) == 2 and shape[1] % quant[1] == 0:
            lst.append((name, tuple(shape), DataType[quant[0]], quant[2](*shape, gen)))
            return
        a = (np.full(shape, const, np.float16) if const is not None
             else _randn_f16(shape, std, gen))
        lst.append((name, tuple(shape), DataType.F16, a.view(np.uint8).reshape(-1)))

    def ln(lst, pfx, width):
        add(lst, pfx + ".weight", (width,), const=1.0)
        add(lst, pfx + ".bias", (width,), const=0.0)

    ve = []
    add(ve, "patch_embed.proj.weight", (vd, 3, 14, 14))
    add(ve, "patch_embed.proj.bias", (vd,))
    add(ve, "cls_token", (vd,))
    add(ve, "pos_embed", (257, vd))
    for i in range(depth):
        p = f"blocks.{i}."
        ln(ve, p + "norm1", vd)
        add(ve, p + "attn.qkv.weight", (3 * vd, vd))
        add(ve, p + "attn.q_bias", (vd,))
        add(ve, p + "attn.v_bias", (vd,))
        add(ve, p + "attn.proj.weight", (vd, vd))
        add(ve, p + "attn.proj.bias", (vd,))
        ln(ve, p + "norm2", vd)
        add(ve, p + "mlp.fc1.weight", (mlp, vd))
        add(ve, p + "mlp.fc1.bias", (mlp,))
        add(ve, p + "mlp.fc2.weight", (vd, mlp))
        add(ve, p + "mlp.fc2.bias", (vd,))
    cw.add_model("visual_encoder", ve)
    lv = []
    add(lv, "weight", (vd,), const=1.0)
    add(lv, "bias", (vd,), const=0.0)
    cw.add_model("ln_vision", lv)
    qt = []
    add(qt, "weight", (nq, hid), std=1.0)
    cw.add_model("query_tokens", qt)
    qf = []
    ln(qf, "bert.embeddings.LayerNorm", hid)
    for i in range(qf_layers):
        p = f"bert.encoder.layer.{i}."
        for blk, width in [("attention.", hid)] + ([("crossattention.", vd)] if i % 2 == 0 else []):
            add(qf, p + blk + "self.query.weight", (hid, hid))
            add(qf, p + blk + "self.query.bias", (hid,))
            add(qf, p + blk + "self.key.weight", (hid, width))
            add(qf, p + blk + "self.key.bias", (hid,))
            add(qf, p + blk + "self.value.weight", (hid, width))
            add(qf, p + blk + "self.value.bias", (hid,))
            add(qf, p + blk + "output.dense.weight", (hid, hid))
            add(qf, p + blk + "output.dense.bias", (hid,))
            ln(qf, p + blk + "output.LayerNorm", hid)
        add(qf, p + "intermediate_query.dense.weight", (inter, hid))
        add(qf, p + "intermediate_query.dense.bias", (inter,))
        add(qf, p + "output_query.dense.weight", (hid, inter))
        add(qf, p + "output_query.dense.bias", (hid,))
        ln(qf, p + "output_query.LayerNorm", hid)
    cw.add_model("Qformer", qf)
    pj = []
    add(pj, "weight", (out_d, hid))
    add(pj, "bias", (out_d,))
    cw.add_model("llama_proj", pj)
    cw.write()


def _write_once(path: Path, writer, geo: dict, seed: int) -> Path:
    if path.exists():
        log(f"[engine] reusing {path.relative_to(ROOT)}")
        return path
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    t0 = time.perf_counter()
    tmp = path.with_suffix(".tmp")
    writer(tmp, gen, geo)
    tmp.replace(path)
    log(f"[engine] wrote {path.relative_to(ROOT)} ({path.stat().st_size / 1e9:.2f} GB) "
        f"in {time.perf_counter() - t0:.1f} s")
    return path


def smoke_container(out_d: int, quant: str | None = None) -> Path:
    """The vision container projecting to ``out_d``, f16 or with ``quant``
    weights, written once."""
    out = ROOT / "build" / "smoke_models"
    out.mkdir(parents=True, exist_ok=True)
    vg = dict(VISION_GEOMETRY, out=out_d, quant=quant)
    model = out / (f"minigpt4-{quant or 'f16'}-vit{vg['width']}x{vg['depth']}-qformer"
                   f"{vg['hidden']}x{vg['qf_layers']}-proj{vg['out']}-seed{SEED}.bin")
    return _write_once(model, write_container, vg, SEED + 1)


def smoke_models(lg: dict, vision_quant: str | None = None) -> tuple[Path, Path]:
    """The (container, LLM) pair for decoder geometry ``lg``, written once."""
    out = ROOT / "build" / "smoke_models"
    out.mkdir(parents=True, exist_ok=True)
    log(f"[engine] {shutil.disk_usage(out).free / 1e9:.1f} GB free under {out.relative_to(ROOT)}")
    llm = out / (f"llama-{lg['layout']}-d{lg['n_embd']}-h{lg['n_head']}-L{lg['n_layer']}"
                 f"-v{lg['n_vocab']}-seed{SEED}.bin")
    _write_once(llm, write_llm, lg, SEED)
    return smoke_container(lg["n_embd"], vision_quant), llm


# ---------------------------------------------------------------------------
# phase 4: the main paths
# ---------------------------------------------------------------------------

KERNELS = ("gq_decode", "gq_prefill", "gq_decode_generic", "gq_prefill_generic", "flash_decode",
           "paged_flash_decode", "rq_decode", "rq_prefill", "i8_decode", "i8_prefill")
CHAT_KERNELS = KERNELS[:5]
SERVING_KERNELS = KERNELS[:6]
GQ_KERNELS = KERNELS[:4]
# the packed gq entries, counted per packing: "gq_decode[p5]" is
# gq.gq_decode.packed_launches["p5"] (the JAX package has no exact-plane p6
# and packs no generic code of group size 16 in 4 or 5 bits)
PACKED_KERNELS = ("gq_decode[p4]", "gq_decode[p5]", "gq_prefill[p4]", "gq_prefill[p5]",
                  "gq_decode_generic[p4]", "gq_decode_generic[p5]", "gq_decode_generic[p6]",
                  "gq_prefill_generic[p4]", "gq_prefill_generic[p5]", "gq_prefill_generic[p6]")
PACKED_13B_KERNELS = ("gq_decode[p5]", "gq_prefill[p5]", "gq_decode_generic[p6]",
                      "gq_prefill_generic[p6]", "flash_decode")
# (its q6_k output head takes one row, so its p6 runs only in decode)
PACKED_MIX_KERNELS = ("gq_decode[p4]", "gq_prefill[p4]", "gq_decode_generic[p4]",
                      "gq_decode_generic[p5]", "gq_decode_generic[p6]", "gq_prefill_generic[p4]",
                      "gq_prefill_generic[p5]", "flash_decode")
REPACK_CHAT_KERNELS = ("rq_decode", "rq_prefill", "flash_decode")
REPACK_LABEL = "13B L8 repack + q5_k container"
# the stats mode of flash decode (sequence-parallel partials), counted apart
STATS = "flash_decode[stats]"
W8A8_KERNELS = ("i8_decode", "i8_prefill", "rq_prefill", "flash_decode", "paged_flash_decode")
W8A8_LABEL = "13B L8 w8a8 + f8 cache"
DECODE_MATMULS = ("gq_decode", "gq_decode_generic", "rq_decode", "i8_decode") + tuple(
    k for k in PACKED_KERNELS if "_decode" in k)


def launch_counts() -> dict:
    from minigpt4_tpu_torch.ops import counters

    return counters.named()


def reset_launch_counts() -> None:
    from minigpt4_tpu_torch.ops import counters

    counters.reset()


def uncounted(fn):
    """``fn()``, with its launches taken back out of the counters: the eager
    and captured runs of an A/B are not the main path's."""
    from minigpt4_tpu_torch.ops import counters

    before = counters.counts()
    try:
        return fn()
    finally:
        counters.add({k: n - before.get(k, 0) for k, n in counters.counts().items()}, -1)


# captured CUDA graphs against the same steps run eagerly: the same kernels
# in the same order, so the logits should agree bit for bit; held to this
# share of max|logit| (and max|embedding|)
GRAPH_TOL = 1e-5
GRAPH_ROUNDS = 2  # turns captured, eager, eager, captured of the timed chunk


def _rel_d(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max |d|, max |d| / max |want|)."""
    d = float((got.float() - want.float()).abs().max())
    return d, d / float(want.float().abs().max())


def log_warmup(label: str, stats: dict, card: str) -> None:
    log(f"[graphs {label}] warmup {stats['warmup_s']:.2f} s (the kernel library "
        f"{stats['build_s']:.2f} s before it): {stats['graphs']} graphs, their memory pool "
        f"holds {stats['pool_bytes'] / 1e9:.3f} GB  [{card}]")


def graph_ab(eng, label: str, card: str) -> dict:
    """The engine's captured steps against the same steps run eagerly
    (``graphs_enabled`` off), each pair from the same state: the image
    encoder; the system prompt and image turn from position 0, profiled
    (wall, device busy, idle); from the state after it a greedy 16-token
    chunk (ids equal, final logits within GRAPH_TOL), a sampled one (temp
    0.8, the generator seeded alike: ids equal), then the greedy chunk timed
    in turns captured, eager, eager, captured (GRAPH_ROUNDS times) and
    profiled each way (tok/s, device activities per token, idle share).
    Fails unless the captured chunk's idle share is below the eager one's."""
    from minigpt4_tpu_torch.engine import SamplingParams
    from minigpt4_tpu_torch.image import preprocess
    from minigpt4_tpu_torch.profiling import profile_window

    sync = torch.cuda.synchronize
    st = eng._st
    greedy = SamplingParams(temp=0.0)
    pixels = preprocess(chat_image(), size=eng.vision_cfg.vit.image_size)
    res: dict = {True: {}, False: {}}
    for mode in (True, False):
        eng.graphs_enabled = mode
        res[mode]["emb"] = torch.from_numpy(eng.encode_image(pixels))
        eng.reset()

        def prefill():
            eng.system_prompt()
            eng.begin_chat_image(res[True]["emb"].numpy(), "What is in this picture?")

        res[mode]["prefill_prof"] = profile_window(prefill, sync)
        res[mode]["prefill"] = st.logits.clone()
    # the eager prefill's state: both modes decode from its cache contents
    n0, logits0 = st.n_past, st.logits.clone()

    def restore():
        st.n_past = n0
        del st.tokens[n0:]
        st.logits = logits0.clone()

    for mode in (True, False):
        eng.graphs_enabled = mode
        restore()
        res[mode]["ids"] = eng.decode_chunk(16, greedy)
        res[mode]["logits"] = st.logits.clone()
        restore()
        st.generator.manual_seed(SEED + 5)
        res[mode]["sampled"] = eng.decode_chunk(16, SamplingParams(temp=0.8))
    times: dict = {True: [], False: []}
    for mode in (True, False, False, True) * GRAPH_ROUNDS:
        eng.graphs_enabled = mode
        restore()
        sync()
        t0 = time.perf_counter()
        eng.decode_chunk(16, greedy)
        sync()
        times[mode].append((time.perf_counter() - t0) * 1e3 / 16)
    for mode in (True, False):
        eng.graphs_enabled = mode
        restore()
        res[mode]["prof"] = profile_window(lambda: eng.decode_chunk(16, greedy), sync)
    eng.graphs_enabled = True
    restore()
    cap, eag = res[True], res[False]
    errs = {k: _rel_d(cap[k], eag[k]) for k in ("emb", "prefill", "logits")}
    out = {"errs": errs, "greedy_equal": cap["ids"] == eag["ids"],
           "sampled_equal": cap["sampled"] == eag["sampled"]}
    for mode, name in ((True, "captured"), (False, "eager")):
        ms = statistics.median(times[mode])
        pf, pp = res[mode]["prof"], res[mode]["prefill_prof"]
        out[name] = dict(ms_per_token=ms, tok_s=1e3 / ms, ms=times[mode],
                         ops_per_token=pf["device_ops"] / 16, idle=pf["idle"],
                         busy_ms=pf["busy_ms"], wall_ms=pf["wall_ms"],
                         prefill_wall_ms=pp["wall_ms"], prefill_busy_ms=pp["busy_ms"],
                         prefill_idle=pp["idle"], prefill_ops=pp["device_ops"])
        log(f"[graphs {label}] {name}: 16-token greedy chunk {ms:.2f} ms per token (median of "
            f"{[round(x, 2) for x in times[mode]]}) = {1e3 / ms:.2f} tok/s; profiled: "
            f"{pf['device_ops'] / 16:g} device activities per token, device busy "
            f"{pf['busy_ms']:.1f} of {pf['wall_ms']:.1f} ms, idle {100 * pf['idle']:.1f} %; "
            f"system prompt + image turn ({n0} positions): wall {pp['wall_ms']:.1f} ms, busy "
            f"{pp['busy_ms']:.1f} ms, idle {100 * pp['idle']:.1f} %, {pp['device_ops']} device "
            f"activities  [{card}]")
    log(f"[graphs {label}] captured vs eager: greedy ids equal {out['greedy_equal']} "
        f"({cap['ids'][:8]}...), sampled ids equal {out['sampled_equal']}; max |d| (/ max) "
        + ", ".join(f"{k} {d:.3e} ({r:.3e})" for k, (d, r) in errs.items())
        + f" (tol {GRAPH_TOL:g})  [{card}]")
    bad = [k for k, (_, r) in errs.items() if not r <= GRAPH_TOL]
    if not (out["greedy_equal"] and out["sampled_equal"]) or bad:
        raise AssertionError(f"{label}: captured and eager steps differ: {out}")
    if not out["captured"]["idle"] < out["eager"]["idle"]:
        raise AssertionError(f"{label}: the captured chunk is no less idle than the eager one: "
                             f"{out['captured']['idle']} >= {out['eager']['idle']}")
    return out


def chat(label: str, lg: dict, card: str, expect: tuple, quant_mode: str = "auto",
         vision_quant: str | None = None, forbid: tuple = (), keep: bool = False,
         graphs: bool = True):
    """One image chat on the synthetic files of geometry ``lg`` (the container
    f16, or with ``vision_quant`` weights) through an engine of ``quant_mode``;
    the kernels of ``expect`` must launch in it, those of ``forbid`` must not.
    Returns its launch counts and times, and with ``keep`` the engine, open,
    beside them.  With ``graphs`` the engine's ``warmup()`` runs before the
    chat and :func:`graph_ab` after it."""
    from minigpt4_tpu_torch.engine import MiniGPT4Engine

    model, llm = smoke_models(lg, vision_quant)
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    eng = MiniGPT4Engine(model, llm, device=DEVICE, quant_mode=quant_mode)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    mem_gb = (torch.cuda.memory_allocated() - mem0) / 1e9
    codes = (f", gq codes {'packed' if eng.gq_packed else 'unpacked'}"
             if eng.quant_mode == "gq" else "")
    log(f"[engine {label}] quant_mode {quant_mode} -> {eng.quant_mode}{codes}; {mem_gb:.3f} GB "
        f"allocated by the load  [{card}]")
    try:
        warm = None
        if graphs:
            warm = eng.warmup()
            log_warmup(label, warm, card)
        reset_launch_counts()  # the chat's own launches
        out = chat_on(eng, label, card)
        out = check_launches(label, dict(out, load_s=t_load, mem_gb=mem_gb), expect, forbid,
                             card)
        if graphs:
            out["graphs"] = dict(uncounted(lambda: graph_ab(eng, label, card)), warmup=warm)
    except BaseException:
        eng.close()
        raise
    if keep:
        return out, eng
    eng.close()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def decode_ab(engines: dict, card: str, rounds: int = 3) -> dict:
    """ms per token of a 16-token greedy decode chunk on each of two loaded
    engines, in turns a, b, b, a, ``rounds`` times, so that a host that
    speeds up or slows down during the call weighs on both alike."""
    from minigpt4_tpu_torch.engine import SamplingParams

    greedy = SamplingParams(temp=0.0)
    la, lb = engines
    for eng in engines.values():
        eng.begin_chat("Go on.")  # fresh logits, whatever the last turn left
    t = {la: [], lb: []}
    for label in (la, lb, lb, la) * rounds:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engines[label].decode_chunk(16, greedy)
        torch.cuda.synchronize()
        t[label].append((time.perf_counter() - t0) * 1e3 / 16)
    med = {k: statistics.median(v) for k, v in t.items()}
    log(f"[engine A/B] ms per token of a 16-token chunk, turns {la} / {lb} / {lb} / {la} x "
        f"{rounds}: " + "; ".join(f"{k} median {med[k]:.2f} ({[round(x, 2) for x in v]}), "
                                  f"{1e3 / med[k]:.2f} tok/s" for k, v in t.items())
        + f"  [{card}]")
    return dict(ms=t, median_ms=med)


def check_launches(label: str, out: dict, expect: tuple, forbid: tuple, card: str) -> dict:
    """Read the launch counts of a path into ``out``; fail if a kernel of
    ``expect`` never launched or one of ``forbid`` did; log the path's times."""
    counts = launch_counts()
    log(f"[engine {label}] launches during the path: {counts}")
    missing = [k for k in expect if counts[k] <= 0]
    if missing:
        raise AssertionError(f"{label}: kernels never launched on the main path: {missing}")
    stray = [k for k in forbid if counts[k] != 0]
    if stray:
        raise AssertionError(f"{label}: kernels launched that this path must not use: {stray}")
    step = ("not measured (the greedy turn stopped early)" if out["step_ms"] is None else
            f"{out['step_ms']:.2f} ms per token in a 16-token chunk, "
            f"{out['matmuls_per_token']:g} matmul launches per token")
    log(f"[engine {label}] load {out['load_s']:.2f} s  encode {out['encode_ms']:.1f} ms  prefill "
        f"{out['prefill_ms']:.1f} ms ({out['prompt']} positions)  decode {out['decode_ms']:.1f} ms "
        f"for {out['n_decoded']} tokens = {out['decode_tok_s']:.2f} tok/s; {step}  [{card}]")
    return dict(out, counts=counts)


def chat_image() -> np.ndarray:
    return np.random.default_rng(SEED).integers(0, 256, (480, 640, 3), dtype=np.uint8)


def chat_on(eng, label: str, card: str) -> dict:
    """The chat of :func:`chat` on a loaded engine: encode, system prompt,
    image turn, a greedy generate(limit=32), a timed and a profiled 16-token
    chunk, a sampled second turn; returns its times."""
    from minigpt4_tpu_torch.engine import SamplingParams
    from minigpt4_tpu_torch.image import preprocess
    from minigpt4_tpu_torch.profiling import profile_window

    sync = torch.cuda.synchronize
    n_vocab = eng.llm_cfg.n_vocab
    per_token = step_ms = prof = None
    img = chat_image()
    t0 = time.perf_counter()
    emb = eng.encode_image(preprocess(img, size=eng.vision_cfg.vit.image_size))
    t_encode = time.perf_counter() - t0
    want_shape = (eng.vision_cfg.qformer.query_length, eng.llm_cfg.n_embd)
    if emb.shape != want_shape or not np.isfinite(emb).all():
        raise AssertionError(f"image embedding {emb.shape}, finite={np.isfinite(emb).all()}")

    t0 = time.perf_counter()
    eng.system_prompt()
    eng.begin_chat_image(emb, "What is in this picture?")
    logits = eng._st.logits.float()
    sync()
    t_prefill = time.perf_counter() - t0
    n_prompt = eng.n_past
    if logits.shape != (n_vocab,) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"prefill logits are not finite [{n_vocab}]")

    greedy = SamplingParams(temp=0.0)
    t0 = time.perf_counter()
    text = list(eng.generate(limit=32, params=greedy))
    sync()
    t_decode = time.perf_counter() - t0
    ids = eng._st.tokens[n_prompt:]
    if eng._st.logits is not None:
        # one more chunk, timed, with the matmul launches it takes per token
        before = launch_counts()
        t0 = time.perf_counter()
        eng.decode_chunk(16, greedy)
        sync()
        step_ms = (time.perf_counter() - t0) * 1e3 / 16
        after = launch_counts()
        per_token = sum(after[k] - before[k] for k in DECODE_MATMULS) / 16
        prof = profile_window(lambda: eng.decode_chunk(16, greedy), sync)
        log_profile(f"[engine {label}] a 16-token decode chunk", prof, card)
        log(f"[engine {label}] {prof['device_ops'] / 16:g} device activities per token, "
            f"{per_token:g} matmul launches per token")
    eng.begin_chat("Tell me more.")
    before = eng.n_past
    text2 = list(eng.generate(limit=8, params=SamplingParams(temp=0.8)))
    sync()
    ids2 = eng._st.tokens[before:]
    if eng._st.logits is not None and not bool(torch.isfinite(eng._st.logits).all()):
        raise AssertionError("decode logits are not finite")
    # the same system prompt and image turn once more, from position 0,
    # profiled: how the prefill of time to first token splits
    eng.reset()

    def prefill():
        eng.system_prompt()
        eng.begin_chat_image(emb, "What is in this picture?")

    prefill_prof = profile_window(prefill, sync)
    log_profile(f"[engine {label}] the system prompt and image turn ({eng.n_past} positions)",
                prefill_prof, card)
    if not bool(torch.isfinite(eng._st.logits).all()):
        raise AssertionError("the profiled prefill's logits are not finite")
    if not ids or not all(0 <= t < n_vocab for t in ids + ids2):
        raise AssertionError(f"token ids out of range: {ids} {ids2}")
    log(f"[engine {label}] prompt {n_prompt} positions; greedy {len(ids)} tokens {ids[:12]}...; "
        f"sampled turn {len(ids2)} tokens; text {''.join(text)[:60]!r} / {''.join(text2)[:30]!r}")
    return dict(encode_ms=t_encode * 1e3, prefill_ms=t_prefill * 1e3, prompt=n_prompt,
                decode_ms=t_decode * 1e3, n_decoded=len(ids), decode_tok_s=len(ids) / t_decode,
                step_ms=step_ms, matmuls_per_token=per_token, profile=prof,
                prefill_profile=prefill_prof, greedy_ids=ids, prefill_logits=logits.cpu().numpy())


# the q5_1 container's embedding against the same weights dequantized to
# dense f32: the kernel path rounds x and w to bf16 (2^-9 each) in every
# prefill matmul, 4 in each of the 39 ViT-G blocks and 6 to 10 in each of the
# 12 Q-Former layers, and those roundings compound through the residual
# streams and LayerNorms
ENCODE_TOL = 5e-2


def encode_check(card: str) -> dict:
    """A 13B q5_1 container, every ViT-G and Q-Former projection quantized
    (K = 1408 included): one image through the kernels (repacked weights)
    and through the same weights dequantized to dense f32 on the card."""
    from minigpt4_tpu_torch.formats import ContainerReader, DataType
    from minigpt4_tpu_torch.image import preprocess
    from minigpt4_tpu_torch.models import minigpt4 as vision_mod
    from minigpt4_tpu_torch.ops import repack as rp

    model = smoke_container(LLM_13B["n_embd"], "q5_1")
    reset_launch_counts()
    t0 = time.perf_counter()
    with ContainerReader(model) as r:
        params, cfg = vision_mod.load_params(r, torch.float32, DEVICE, "repack")
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0

    def quantized(tree):
        if isinstance(tree, dict):
            return [w for v in tree.values() for w in quantized(v)]
        if isinstance(tree, list):
            return [w for v in tree for w in quantized(v)]
        return [tree] if isinstance(tree, rp.RepackedQuant) else []

    weights = quantized(params)
    blocks = params["visual_encoder"]["blocks"]
    if not all(isinstance(blocks[n]["w"], rp.RepackedQuant) and blocks[n]["w"].dtype == DataType.Q5_1
               for n in ("qkv", "proj", "fc1", "fc2")):
        raise AssertionError("q5_1 container: a ViT-G projection did not load repacked")
    img = np.random.default_rng(SEED + 3).integers(0, 256, (480, 640, 3), dtype=np.uint8)
    pixels = torch.from_numpy(preprocess(img, size=cfg.vit.image_size)[None]).to(DEVICE)
    with torch.no_grad():
        vision_mod.encode_image(params, pixels, cfg)  # warm
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        got = vision_mod.encode_image(params, pixels, cfg)
        torch.cuda.synchronize()
        t_kernels = time.perf_counter() - t0
        counts = launch_counts()

        def dense(tree):
            if isinstance(tree, dict):
                return {k: dense(v) for k, v in tree.items()}
            if isinstance(tree, list):
                return [dense(v) for v in tree]
            if isinstance(tree, rp.RepackedQuant):
                return tree.dequantize().transpose(-1, -2).contiguous()  # [(L,) K, N]
            return tree

        dparams = dense(params)
        vision_mod.encode_image(dparams, pixels, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = vision_mod.encode_image(dparams, pixels, cfg)
        torch.cuda.synchronize()
        t_dense = time.perf_counter() - t0
    err = rel_err(got, want)
    del params, dparams
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[encode q5_1] {len(weights)} repacked weights ({sum(nbytes(*w.tensors().values()) for w in weights) / 1e9:.3f} GB),"
        f" load {t_load:.2f} s; embedding {tuple(got.shape)} through the kernels "
        f"{t_kernels * 1e3:.1f} ms, dense f32 {t_dense * 1e3:.1f} ms; max |d| / max |emb| = "
        f"{err:.3e} (tol {ENCODE_TOL:g}); launches {counts}  [{card}]")
    if got.shape != (1, cfg.qformer.query_length, LLM_13B["n_embd"]) or not bool(
            torch.isfinite(got).all()):
        raise AssertionError(f"q5_1 encode: embedding {tuple(got.shape)} not finite")
    if not err <= ENCODE_TOL:
        raise AssertionError(f"q5_1 encode: kernels and dense f32 differ by {err} > {ENCODE_TOL}")
    if counts["rq_prefill"] <= 0:
        raise AssertionError(f"q5_1 encode: rq_prefill never launched: {counts}")
    return dict(counts=counts, rel_err=err, kernels_ms=t_kernels * 1e3, dense_ms=t_dense * 1e3,
                load_s=t_load)


# ---------------------------------------------------------------------------
# phase 5: batched HTTP serving over the page pool
# ---------------------------------------------------------------------------

QUESTIONS = ["Hi.", "What is the capital of France?",
             "Write a short poem about the sea and the wind over it.",
             "Explain in a few sentences why the sky is blue during the day and red at sunset.",
             "List three fruits.", "How do airplanes stay in the air, and what keeps them stable "
             "when the wind changes direction suddenly during a long flight?",
             "Tell me a joke about programmers.", "What is in this picture?"]


def _request(base: str, path: str, data: bytes | None = None, method: str = "POST"):
    req = urllib.request.Request(base + path, data=data, method=method)
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.status, r.read()


def _png(img: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def _clone(pool, s):
    """A new session of ``pool`` in the state of ``s`` (cache copied)."""
    c = pool.new_session()
    st, src = c.state, s.state
    st.cache = {kv: v.clone() for kv, v in src.cache.items()}
    st.n_past, st.n_keep, st.tokens = src.n_past, src.n_keep, list(src.tokens)
    st.logits = src.logits.clone()
    return c


def paged_vs_dense(pool, sessions: list, card: str, sync) -> dict:
    """Copies of ``sessions`` decode one step as a paged group and as a dense
    group (max |dlogit| / max |logit| <= 1e-3), then 31 more greedy tokens
    each way: the identical-token prefix per lane and the paged group's
    tok/s."""
    from minigpt4_tpu_torch.engine import SamplingParams
    from minigpt4_tpu_torch.profiling import profile_window

    greedy = SamplingParams(temp=0.0)
    paged, dense = sessions, [_clone(pool, s) for s in sessions]
    profiled = [_clone(pool, s) for s in sessions]
    n0 = [s.n_past for s in paged]
    free0 = pool.paged_pool.free_pages
    pool.generate_batch(paged, limit=1, params=greedy, decode_chunk=1)
    pool.generate_batch(dense, limit=1, params=greedy, decode_chunk=1, paged=False)
    got = torch.stack([s.state.logits for s in paged]).float()
    want = torch.stack([s.state.logits for s in dense]).float()
    rel = float((got - want).abs().max() / want.abs().max())
    log(f"[serving] first decode step, paged group vs dense group of {len(paged)} lanes: "
        f"max |dlogit| / max |logit| = {rel:.3e} (tol 1e-3)  [{card}]")
    if not rel <= 1e-3:
        raise AssertionError(f"paged and dense first steps differ by {rel} > 1e-3")
    sync()
    t0 = time.perf_counter()
    pool.generate_batch(paged, limit=31, params=greedy, decode_chunk=16)
    sync()
    t_paged = time.perf_counter() - t0
    t0 = time.perf_counter()
    pool.generate_batch(dense, limit=31, params=greedy, decode_chunk=16, paged=False)
    sync()
    t_dense = time.perf_counter() - t0
    same = []
    for a, b, n in zip(paged, dense, n0):
        ta, tb = a.state.tokens[n:], b.state.tokens[n:]
        k = next((i for i, (x, y) in enumerate(zip(ta, tb)) if x != y), min(len(ta), len(tb)))
        same.append(f"{k}/{max(len(ta), len(tb))}")
    n_tok = sum(len(s.state.tokens) - n for s, n in zip(paged, n0)) - len(paged)
    log(f"[serving] identical-token prefix per lane (paged vs dense): {same}")
    log(f"[serving] 8-lane group, 31 tokens: paged {t_paged:.3f} s = {n_tok / t_paged:.2f} tok/s "
        f"aggregate, dense {t_dense:.3f} s  [{card}]")
    prof = profile_window(lambda: pool.generate_batch(profiled, limit=16, params=greedy,
                                                      decode_chunk=16), sync)
    log_profile("[serving] a 16-token chunk of the 8-lane paged group", prof, card)
    if pool.paged_pool.free_pages != free0:
        raise AssertionError("the paged group did not return its pages")
    for s in paged + dense + profiled:
        s.close()
    return dict(first_step_rel=rel, same_prefix=same, group_tok_s=n_tok / t_paged,
                paged_s=t_paged, dense_s=t_dense, group_profile=prof)


def paged_graph_ab(pool, sessions: list, card: str) -> dict:
    """The paged group of copies of ``sessions`` replayed from its graphs and
    run eagerly (``graphs_enabled`` off), each from fresh copies of the same
    sessions: a greedy 16-token chunk (ids equal, the lanes' final logits
    within GRAPH_TOL), a sampled one (temp 0.8, each lane's generator seeded
    alike: ids equal), the greedy chunk timed in turns captured, eager,
    eager, captured (GRAPH_ROUNDS times) and profiled each way.  The paged
    kernel must run each way, and the captured chunk's idle share must be
    below the eager one's."""
    from minigpt4_tpu_torch.engine import SamplingParams
    from minigpt4_tpu_torch.ops import flash_decode as fd
    from minigpt4_tpu_torch.profiling import profile_window

    sync = torch.cuda.synchronize
    eng = pool.engine
    greedy, sampled = SamplingParams(temp=0.0), SamplingParams(temp=0.8)
    n0 = [s.n_past for s in sessions]

    def group(mode: bool, params, profiled: bool = False):
        eng.graphs_enabled = mode
        lanes = [_clone(pool, s) for s in sessions]
        for i, s in enumerate(lanes):
            s.state.generator.manual_seed(SEED + 100 + i)
        paged0 = fd.paged_flash_decode_attention.launches
        sync()
        t0 = time.perf_counter()
        prof = None
        if profiled:
            prof = profile_window(lambda: pool.generate_batch(
                lanes, limit=16, params=params, decode_chunk=16), sync)
        else:
            pool.generate_batch(lanes, limit=16, params=params, decode_chunk=16)
            sync()
        dt = time.perf_counter() - t0
        if fd.paged_flash_decode_attention.launches == paged0:
            raise AssertionError("the 8-lane group did not decode paged")
        ids = [s.state.tokens[n:] for s, n in zip(lanes, n0)]
        logits = [s.state.logits for s in lanes]
        for s in lanes:
            s.close()
        return ids, logits, dt * 1e3 / 16, prof

    res = {}
    for mode in (True, False):
        ids, logits, _, _ = group(mode, greedy)
        res[mode] = dict(ids=ids, logits=logits, sampled=group(mode, sampled)[0])
    times: dict = {True: [], False: []}
    for mode in (True, False, False, True) * GRAPH_ROUNDS:
        times[mode].append(group(mode, greedy)[2])
    for mode in (True, False):
        res[mode]["prof"] = group(mode, greedy, profiled=True)[3]
    eng.graphs_enabled = True
    cap, eag = res[True], res[False]
    pairs = [(a, b) for a, b in zip(cap["logits"], eag["logits"]) if a is not None and b is not None]
    d, rel = max((_rel_d(a, b) for a, b in pairs), key=lambda x: x[1], default=(0.0, 0.0))
    out = {"greedy_equal": cap["ids"] == eag["ids"], "sampled_equal": cap["sampled"] == eag["sampled"],
           "logits_max_d": d, "logits_rel": rel, "lanes_compared": len(pairs),
           "keys": [list(map(str, k)) for k in pool._paged_graphs.graphs]}
    n_tok = 16 * len(sessions)
    for mode, name in ((True, "captured"), (False, "eager")):
        ms = statistics.median(times[mode])
        pf = res[mode]["prof"]
        out[name] = dict(ms_per_step=ms, tok_s=1e3 * len(sessions) / ms, ms=times[mode],
                         ops_per_token=pf["device_ops"] / n_tok, idle=pf["idle"],
                         busy_ms=pf["busy_ms"], wall_ms=pf["wall_ms"])
        log(f"[graphs serving] {name}: the {len(sessions)}-lane paged group's 16-token chunk "
            f"{ms:.2f} ms per step (median of {[round(x, 2) for x in times[mode]]}) = "
            f"{1e3 * len(sessions) / ms:.2f} tok/s aggregate; profiled: "
            f"{pf['device_ops'] / n_tok:g} device activities per token, device busy "
            f"{pf['busy_ms']:.1f} of {pf['wall_ms']:.1f} ms, idle {100 * pf['idle']:.1f} %  "
            f"[{card}]")
    log(f"[graphs serving] captured vs eager: greedy ids equal {out['greedy_equal']}, sampled "
        f"ids equal {out['sampled_equal']}; lanes' final logits max |d| {d:.3e} ({rel:.3e} of "
        f"max, {len(pairs)} lanes, tol {GRAPH_TOL:g}); graph keys {out['keys']}  [{card}]")
    if not (out["greedy_equal"] and out["sampled_equal"]) or not rel <= GRAPH_TOL:
        raise AssertionError(f"serving: the captured and eager paged groups differ: {out}")
    if not out["captured"]["idle"] < out["eager"]["idle"]:
        raise AssertionError("serving: the captured paged chunk is no less idle than the eager one")
    return out


SESSION_TOKENS = 64  # of phase 5's session captured against eager


def session_graph_ab(pool, card: str) -> dict:
    """Phase 5's first step: one session's system prompt, image turn and
    SESSION_TOKENS greedy ids through the pool, its steps replayed from the
    engine's session graphs over the resident cache and run eagerly
    (``graphs_enabled`` off), each from a new session: one captured run
    that captures the keys, then captured, eager, eager, captured.  Ids
    equal; the image turn's and the final pending logits within GRAPH_TOL
    (the same kernels in the same order: bit-equal expected); the prefill
    (system prompt and image turn) wall ms, the decode tok/s and the graph
    replays each way; the session keys (the same for every session) and the
    resident buffers' bytes.  Leaves graphs on."""
    from minigpt4_tpu_torch.engine import SamplingParams

    eng = pool.engine
    greedy = SamplingParams(temp=0.0)
    emb = pool.encode_image(_preprocess(chat_image(), pool))
    sync = torch.cuda.synchronize

    def run(mode: bool) -> dict:
        eng.graphs_enabled = mode
        s = pool.new_session()
        r0 = eng.graph_stats()["replays"]
        sync()
        t0 = time.perf_counter()
        pool.system_prompt(s)
        pool.begin_chat_image(s, emb, "What is in this picture?")
        sync()
        t1 = time.perf_counter()
        prefill, n0 = s.state.logits.clone(), s.n_past
        "".join(pool.generate(s, SESSION_TOKENS, greedy))
        sync()
        t2 = time.perf_counter()
        ids = s.state.tokens[n0:]
        out = dict(ids=ids, prefill=prefill, positions=n0,
                   logits=None if s.state.logits is None else s.state.logits.clone(),
                   prefill_ms=(t1 - t0) * 1e3, tok_s=len(ids) / (t2 - t1),
                   replays=eng.graph_stats()["replays"] - r0)
        s.close()
        return out

    try:
        warm = run(True)
        runs: dict = {True: [], False: []}
        for mode in (True, False, False, True):
            runs[mode].append(run(mode))
    finally:
        eng.graphs_enabled = True
    cap, eag = runs[True][-1], runs[False][0]
    same = all(r["ids"] == eag["ids"] for r in runs[True] + runs[False] + [warm])
    errs = {"prefill": _rel_d(cap["prefill"], eag["prefill"])}
    if cap["logits"] is not None and eag["logits"] is not None:
        errs["final"] = _rel_d(cap["logits"], eag["logits"])
    res = eng._resident[pool.session_ctx]
    keys = key_replays(res.steps)
    buf_gb = sum(t.numel() * t.element_size() for t in res.bufs["cache"].values()) / 1e9
    out = {"ids_equal": same, "errs": errs, "keys": keys, "resident_gb": buf_gb,
           "spare": "cache" in res.spare, "positions": cap["positions"]}
    for mode, name in ((True, "captured"), (False, "eager")):
        out[name] = {k: statistics.median(r[k] for r in runs[mode])
                     for k in ("prefill_ms", "tok_s")}
        out[name]["replays"] = [r["replays"] for r in runs[mode]]
    log(f"[graphs session] one session of the window server's pool: system prompt + image "
        f"turn ({cap['positions']} positions) and {len(cap['ids'])} greedy ids: captured "
        f"prefill {out['captured']['prefill_ms']:.1f} ms, decode {out['captured']['tok_s']:.2f} "
        f"tok/s ({out['captured']['replays']} graph replays); eager prefill "
        f"{out['eager']['prefill_ms']:.1f} ms, decode {out['eager']['tok_s']:.2f} tok/s (medians "
        f"of 2); ids equal {same}; max |d| (/ max) "
        + ", ".join(f"{k} {d:.3e} ({r:.3e})" for k, (d, r) in errs.items())
        + f" (tol {GRAPH_TOL:g}); session keys and replays {keys}; resident cache "
        f"{buf_gb:.3f} GB and a spare of the same size {out['spare']}  [{card}]")
    bad = [k for k, (_, r) in errs.items() if not r <= GRAPH_TOL]
    if not same or bad or min(out["captured"]["replays"]) <= 0 or not keys:
        raise AssertionError(f"session graphs: captured and eager differ or nothing replayed: "
                             f"{out}")
    return out


def serving(card: str, device: str = DEVICE, lg: dict = LLM_13B, pages: int = 32,
            limit: int = 32) -> dict:
    """One session captured against eager (:func:`session_graph_ab`), then
    eight concurrent HTTP chats through the port's server (their sessions'
    steps replaying the session graphs), then the paged-vs-dense
    comparison on the same pool."""
    from minigpt4_tpu_torch import serve

    model, llm = smoke_models(lg) if isinstance(lg, dict) else lg
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    httpd = serve.start_server(model, llm, port=0, session_ctx=512, batch_window_s=0.03,
                               paged_pages=pages, device=device)
    sync()
    t_load = time.perf_counter() - t0
    pool = httpd.pool
    warm = httpd.warmup
    if cuda:
        log(f"[graphs serving] the server's start captured the paged group's greedy and "
            f"sampled 16-token chunks for 1 to 8 lanes: {warm['warmup_s']:.2f} s, "
            f"{warm['graphs']} graphs, the engine's graph memory pool holds "
            f"{warm['pool_bytes'] / 1e9:.3f} GB  [{card}]")
    session = uncounted(lambda: session_graph_ab(pool, card)) if cuda else None
    gen0 = pool.metrics["tokens_generated"]  # the HTTP chats' own tokens
    reset_launch_counts()  # the HTTP chats' own launches
    groups: list[int] = []
    decode_from: dict[int, int] = {}  # session id -> cursor where its decode began
    batch_stream = pool.generate_batch_stream

    def spy(sessions, *a, **k):
        groups.append(len(sessions))
        decode_from.update((s.session_id, s.n_past) for s in sessions)
        return batch_stream(sessions, *a, **k)

    pool.generate_batch_stream = spy
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    img = np.random.default_rng(SEED + 2).integers(0, 256, (480, 640, 3), dtype=np.uint8)
    body = _png(img)
    results: list = [None] * len(QUESTIONS)
    start = threading.Barrier(len(QUESTIONS))

    def client(i: int) -> None:
        try:
            _, raw = _request(base, "/v1/sessions")
            sid = json.loads(raw)["session_id"]
            if i == len(QUESTIONS) - 1:
                st, _ = _request(base, f"/v1/sessions/{sid}/image", body)
                if st != 200:
                    raise AssertionError(f"image upload: HTTP {st}")
            start.wait(timeout=600)
            t1 = time.perf_counter()
            st, raw = _request(base, f"/v1/sessions/{sid}/chat", json.dumps(
                {"message": QUESTIONS[i], "limit": limit, "temp": 0.0}).encode())
            results[i] = dict(status=st, text=json.loads(raw).get("text", ""), sid=sid,
                              t0=t1, t1=time.perf_counter())
        except Exception as e:  # reported below, never ignored
            start.abort()  # release the other clients
            results[i] = dict(status=None, error=f"{type(e).__name__}: {e}")

    try:
        clients = [threading.Thread(target=client, args=(i,)) for i in range(len(QUESTIONS))]
        for c in clients:
            c.start()
        for c in clients:
            c.join()
        sync()
        counts = launch_counts()
        bad = [(i, r) for i, r in enumerate(results) if r["status"] != 200 or not r["text"]]
        if bad:
            raise AssertionError(f"serving: failed or empty responses: {bad}")
        _, raw = _request(base, "/v1/health", method="GET")
        health = json.loads(raw)
        if health["paged"]["free_pages"] != pages or health["paged"]["broken"]:
            raise AssertionError(f"serving: pages not returned: {health['paged']}")
        lane_tok = [len(pool._sessions[r["sid"]].state.tokens) for r in results]
        span = max(r["t1"] for r in results) - min(r["t0"] for r in results)
        n_gen = health["metrics"]["tokens_generated"] - gen0
        if any(r["sid"] not in decode_from for r in results):
            raise AssertionError(f"serving: a request bypassed the window batcher: {groups}")
        # tokens each request generated (its cursor after the chat, past the
        # prompt it prefilled), over the request's span
        n_req = [pool._sessions[r["sid"]].n_past - decode_from[r["sid"]] for r in results]
        per_lane = [n / (r["t1"] - r["t0"]) for n, r in zip(n_req, results)]
        log(f"[serving] {len(QUESTIONS)} concurrent chats (a PNG upload on the last), "
            f"batch groups {groups}, launches {counts}")
        log(f"[serving] load {t_load:.2f} s; {n_gen} tokens in {span:.3f} s = "
            f"{n_gen / span:.2f} tok/s aggregate; per request (prefill, waits and decode) "
            f"{[round(x, 2) for x in per_lane]} tok/s of {n_req} tokens; "
            f"positions per session {lane_tok}; "
            f"/v1/health {health['paged']}, tok_s_30s {health['tok_s_30s']}  [{card}]")
        for r, q in zip(results, QUESTIONS):
            log(f"[serving]   {q[:32]!r:36s} -> {r['text'][:40]!r}")
        pool.generate_batch_stream = batch_stream
        prepared = []
        for i, q in enumerate(QUESTIONS):
            s = pool.new_session()
            if i == len(QUESTIONS) - 1:
                s.upload_image(_preprocess(img, pool))
            s.ask(q)
            prepared.append(s)
        # (on copies of the prepared sessions, before paged_vs_dense moves them on)
        graph_cmp = (dict(uncounted(lambda: paged_graph_ab(pool, prepared, card)), warmup=warm)
                     if cuda else None)
        spec = spec_batch(pool, prepared, card, sync) if cuda else None
        cmp = dict(paged_vs_dense(pool, prepared, card, sync), graphs=graph_cmp, spec_batch=spec)
        peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else float("nan")
        log(f"[serving] peak device memory {peak:.2f} GB  [{card}]")
    finally:
        httpd.shutdown()
        server.join(timeout=60)
        httpd.server_close()  # stops the batcher, whose thread holds the pool
        pool.close()
        del pool, httpd
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    return dict(counts=counts, load_s=t_load, groups=groups, agg_tok_s=n_gen / span, warmup=warm,
                per_request_tok_s=per_lane, peak_gb=peak, session=session, **cmp)


# ---------------------------------------------------------------------------
# phase 4'': speculative decoding
# ---------------------------------------------------------------------------

SPEC_K = 8  # verify width: S = 8 rows, M = 8 at one lane
SPEC_TOKENS = 64
SPEC_EAGER_TOKENS = 32  # of the eager single streams
SPEC_DRAFT_TOKENS = 16  # of the drafted streams, whose draft steps run eagerly
SPEC_ACCEPT_TOKENS = 48  # of the self-drafted stream, whose drafts hold
SPEC_BATCH_TOKENS = 32
SAMPLED = dict(temp=0.8, top_k=40)
# where speculative ids leave plain greedy's, the plain top-2 logit margin at
# that position must be below this share of max|logit|: a tie the two
# paths' roundings may break either way.  A verify of at most 8 rows runs
# the decode matmuls as a plain step does (last-bit differences between
# M = 8 and M = 1 rows and S = 8 and S = 1 attention); a batched verify of
# B * k > 8 rows runs the bf16 prefill matmul, as the JAX package's does
SPEC_TIE_DECODE = 1e-4
SPEC_TIE_PREFILL = 2e-2


def _margin(logits: torch.Tensor) -> tuple[float, float]:
    """(top-2 gap, max |logit|) of pending logits [V]."""
    top = logits.float().topk(2).values
    return float(top[0] - top[1]), float(logits.float().abs().max())


def spec_ids_check(label: str, got: list, want: list, margin_at, tie: float, card: str) -> dict:
    """Speculative ids ``got`` against plain greedy's ``want``: equal, or
    equal up to a position j where ``margin_at(j)`` (the plain path's top-2
    gap and max |logit| there) shows a tie within ``tie``; else raise."""
    n = min(len(got), len(want))
    j = next((i for i in range(n) if got[i] != want[i]), None)
    if j is None and len(got) == len(want):
        return {"equal": True, "n": n}
    j = n if j is None else j
    gap, top = margin_at(j)
    log(f"[speculative {label}] ids equal to plain greedy's for {j} of {len(want)}; at {j} the "
        f"plain top-2 margin is {gap:.4g} = {gap / top:.3e} of max|logit| (tie bound {tie:g})"
        f"  [{card}]")
    if not gap <= tie * top:
        raise AssertionError(f"{label}: speculative ids {got} leave plain greedy's {want} at {j}, "
                             f"where the plain margin {gap} is no tie ({gap / top:.3e} > {tie})")
    return {"equal": False, "first_diff": j, "margin": gap, "max_logit": top, "n": n}


class SpecStreams:
    """Single speculative streams of a loaded engine on its image turn (the
    system prompt and the chat image) or, with ``image`` False, on a text
    turn, through ``generate``.  While open it records each speculative
    dispatch (its kind, verify passes and tokens emitted) by wrapping the
    engine's three dispatch functions."""

    def __init__(self, eng, image: bool = True):
        import minigpt4_tpu_torch.engine.engine as engine_mod
        from minigpt4_tpu_torch.image import preprocess

        self.eng, self.engine_mod = eng, engine_mod
        self.emb = (eng.encode_image(preprocess(chat_image(), size=eng.vision_cfg.vit.image_size))
                    if image else None)
        self.dispatches: list = []  # (kind, passes, tokens emitted)

    def _rec(self, kind: str, fn, passes_at: int):
        def rec(*a):
            ids = fn(*a)
            self.dispatches.append((kind, a[passes_at], len(ids)))
            return ids
        return rec

    def __enter__(self):
        eng, mod = self.eng, self.engine_mod
        self._draft = mod._draft_chunk
        eng.decode_chunk_spec = self._rec("spec", eng.decode_chunk_spec, 1)
        eng.decode_chunk_spec_stoch = self._rec("spec_stoch", eng.decode_chunk_spec_stoch, 1)
        mod._draft_chunk = self._rec("draft", self._draft, 3)
        return self

    def __exit__(self, *exc):
        del self.eng.decode_chunk_spec, self.eng.decode_chunk_spec_stoch
        self.engine_mod._draft_chunk = self._draft
        self.eng.graphs_enabled = True

    def turn(self) -> int:
        eng = self.eng
        eng.reset()
        eng.system_prompt()
        if self.emb is None:
            eng.begin_chat("Tell me a story about a picture.")
        else:
            eng.begin_chat_image(self.emb, "What is in this picture?")
        return eng.n_past

    def run(self, k: int, graphs: bool = True, limit: int = SPEC_TOKENS, params=None,
            seed: int | None = None) -> dict:
        """One stream of ``limit`` ids at ``speculative_k`` = ``k`` (0: the
        plain chunks; the drafter where the engine has one), greedy unless
        ``params``; ``seed`` reseeds the state's generator after the turn.
        Its ids, seconds, tok/s, dispatches, tokens per pass, launch counts
        (set to 0 just before) and graph replays."""
        from minigpt4_tpu_torch.engine import SamplingParams

        eng = self.eng
        eng.graphs_enabled = graphs
        n0 = self.turn()
        if seed is not None:
            eng._st.generator.manual_seed(seed)
        self.dispatches.clear()
        replays0 = eng.graph_stats()["replays"]
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        list(eng.generate(limit=limit, params=params or SamplingParams(temp=0.0),
                          speculative_k=k))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        ids = eng._st.tokens[n0:]
        passes = sum(p for _, p, _ in self.dispatches)
        emitted = sum(e for _, _, e in self.dispatches)
        return dict(ids=ids, s=dt, tok_s=len(ids) / dt, passes=passes, emitted=emitted,
                    tokens_per_pass=emitted / passes if passes else None,
                    dispatches=list(self.dispatches), counts=launch_counts(),
                    replays=eng.graph_stats()["replays"] - replays0, ban=eng._st.spec_ban)

    def plain_margin(self, j: int) -> tuple[float, float]:
        """The plain greedy stream's top-2 margin at its j-th id."""
        from minigpt4_tpu_torch.engine import SamplingParams

        self.eng.graphs_enabled = True
        self.turn()
        if j:
            self.eng.decode_chunk(j, SamplingParams(temp=0.0))
        return _margin(self.eng._st.logits)


KEEP = ("s", "tok_s", "passes", "emitted", "tokens_per_pass", "dispatches", "replays")


def speculative(eng, card: str) -> dict:
    """Speculative decoding on the loaded 13B Q5_K_M engine (gq, graphs
    warmed up; then its speculative dispatches warmed up at k = 8, as a
    server with --speculative-k does), every stream through ``generate``:
    (a) greedy n-gram drafts
    at k = 8 on the image turn, eager and captured, against the plain
    captured chunks; (b) sampled n-gram speculation (temp 0.8, top-k 40),
    eager and captured from the same generator state: equal ids, a
    ("spec_stoch", ...) graph replayed; (c) the 7B q5_k file as the
    drafter; (d) a random draft head (init_draft_head, d_main 5120) saved
    and loaded.  Every greedy stream must give plain greedy's ids
    (spec_ids_check).  Returns each sub-path's launch counts and times."""
    from minigpt4_tpu_torch.engine import SamplingParams
    from minigpt4_tpu_torch.train import draft as draft_mod

    cfg = eng.llm_cfg
    out: dict = {}
    # what a server started with --speculative-k captures: the n-gram
    # dispatches of the first dispatch's passes, greedy and sampled
    eng.speculative_k = SPEC_K
    try:
        warm = eng.warmup(prefill_buckets=(), decode_chunks=())
    finally:
        eng.speculative_k = 0
    log(f"[speculative] warmup of the speculative dispatches {warm['warmup_s']:.2f} s: keys "
        f"{[k for k in warm['keys'] if str(k[0]).startswith('spec')]}  [{card}]")
    with SpecStreams(eng) as ss:
        # (a) n-gram drafts: the plain captured chunks, an eager run, then
        # two captured runs: the first meets each key not warmed up twice
        # (eager, then captured), the second replays every dispatch
        plain = ss.run(0)
        out["plain"] = {k: plain[k] for k in ("s", "tok_s", "replays")}
        a = {"eager": ss.run(SPEC_K, graphs=False, limit=SPEC_EAGER_TOKENS),
             "captured 1": ss.run(SPEC_K), "captured": ss.run(SPEC_K)}
        keys = [k for k in eng.graph_stats()["keys"] if k[0] == "spec"]
        cap = a["captured"]
        n_flash, n_gq = cap["counts"]["flash_decode"], cap["counts"]["gq_decode"]
        n_gqg = cap["counts"]["gq_decode_generic"]
        log(f"[speculative a] 13B image turn, {SPEC_TOKENS} greedy ids, n-gram drafts at k = "
            f"{SPEC_K}: plain captured chunks {plain['tok_s']:.2f} tok/s; speculative eager "
            f"{a['eager']['tok_s']:.2f} ({SPEC_EAGER_TOKENS} ids), captured {cap['tok_s']:.2f} "
            f"tok/s ({cap['tokens_per_pass']:.3f} tokens per pass: {cap['emitted']} in "
            f"{cap['passes']} passes over {len(cap['dispatches'])} dispatches "
            f"{[d[1:] for d in cap['dispatches']]}; {cap['replays']} graph replays); launches: "
            f"flash_decode at S = {SPEC_K} {n_flash} (= {cfg.n_layer} x {cap['passes']} "
            f"passes), gq_decode at M = {SPEC_K} {n_gq}, gq_decode_generic at M = {SPEC_K} "
            f"{n_gqg}; spec graph keys {keys}  [{card}]")
        if n_flash != cfg.n_layer * cap["passes"] or n_gq <= 0 or n_gqg <= 0:
            raise AssertionError(f"speculative a: launches {cap['counts']} for "
                                 f"{cap['passes']} verify passes")
        if not keys or cap["replays"] < len(cap["dispatches"]):
            raise AssertionError(f"speculative a: the n-gram dispatches did not replay graphs "
                                 f"({keys}, {cap['replays']} replays)")
        checks = {name: spec_ids_check(f"a {name}", r["ids"], plain["ids"][:len(r["ids"])],
                                       ss.plain_margin, SPEC_TIE_DECODE, card)
                  for name, r in a.items()}
        out["a"] = {name: {k: r[k] for k in KEEP} for name, r in a.items()}
        out["a"].update(keys=[list(map(str, k)) for k in keys], checks=checks,
                        counts=cap["counts"])

        # (b) sampled n-gram speculation, eager then captured, each from the
        # generator seeded alike after the turn: the same draws
        sampled = SamplingParams(**SAMPLED)
        b = {name: ss.run(SPEC_K, graphs=graphs, limit=SPEC_EAGER_TOKENS, params=sampled,
                          seed=SEED + 1)
             for name, graphs in (("eager", False), ("captured 1", True), ("captured", True))}
        keys_b = [k for k in eng.graph_stats()["keys"] if k[0] == "spec_stoch"]
        cap = b["captured"]
        kinds = {d[0] for r in b.values() for d in r["dispatches"]}
        log(f"[speculative b] 13B image turn, {SPEC_EAGER_TOKENS} ids sampled (temp 0.8, top-k "
            f"40) by n-gram speculation at k = {SPEC_K}: eager {b['eager']['tok_s']:.2f} tok/s, "
            f"captured {cap['tok_s']:.2f} ({cap['tokens_per_pass']:.3f} tokens per pass: "
            f"{cap['emitted']} in {cap['passes']} passes, dispatches "
            f"{[d[1:] for d in cap['dispatches']]}, {cap['replays']} graph replays, residual ban "
            f"after the stream {cap['ban']}); captured ids equal to eager: "
            f"{cap['ids'] == b['captured 1']['ids'] == b['eager']['ids']} (the first captured "
            f"run, which captures a key, {b['captured 1']['tok_s']:.2f} tok/s); spec_stoch graph "
            f"keys {keys_b}; launches "
            f"flash_decode {cap['counts']['flash_decode']}, gq_decode "
            f"{cap['counts']['gq_decode']}  [{card}]")
        if not cap["ids"] == b["captured 1"]["ids"] == b["eager"]["ids"]:
            raise AssertionError(f"speculative b: captured sampled ids {cap['ids']} differ from "
                                 f"the eager ones {b['eager']['ids']}")
        if kinds != {"spec_stoch"} or not keys_b or cap["replays"] <= 0:
            raise AssertionError(f"speculative b: the sampled dispatches ({kinds}) did not replay "
                                 f"a spec_stoch graph ({keys_b}, {cap['replays']} replays)")
        # (a key's capture runs its step once eagerly: those launches count too)
        if cap["counts"]["flash_decode"] < cfg.n_layer * cap["passes"]:
            raise AssertionError(f"speculative b: launches {cap['counts']} for "
                                 f"{cap['passes']} verify passes")
        out["b"] = {name: {k: r[k] for k in KEEP + ("ban",)} for name, r in b.items()}
        out["b"].update(keys=[list(map(str, k)) for k in keys_b], counts=cap["counts"])

        # (c) the 7B q5_k file (8 layers, the same vocabulary) drafts; (d) a
        # random draft head over the 13B embedding, saved and loaded
        _, llm7 = smoke_models(LLM_7B)
        head = ROOT / "build" / "smoke_models" / f"draft-head-d{cfg.n_embd}-seed{SEED}.npz"
        hcfg = draft_mod.DraftHeadConfig()
        art = draft_mod.init_draft_head(torch.Generator(device=eng.device).manual_seed(SEED),
                                        cfg.n_embd, hcfg)
        draft_mod.save_artifact(head, art, hcfg)
        del art
        for name, kw in (("c", {"draft_llm_path": llm7}), ("d", {"draft_head_path": head})):
            what = "7B q5_k L8 file" if name == "c" else f"draft head {hcfg}"
            out[name] = drafted(eng, ss, f"{name} 13B", what, kw, plain["ids"],
                                SPEC_DRAFT_TOKENS, plain["tok_s"], card, ab=True)
    return out


def key_replays(steps) -> dict:
    """A StepGraphs' captured keys (as strings) and each one's replays."""
    return {} if steps is None else {str(k): g.replays for k, g in steps.graphs.items()}


def drafted(eng, ss: SpecStreams, label: str, what: str, drafter: dict, want: list, limit: int,
            plain_tok_s: float, card: str, ab: bool = False) -> dict:
    """A greedy stream of ``limit`` ids drafted by ``drafter``
    (``set_drafter``'s arguments, dropped afterwards): plain greedy's ids
    ``want`` (spec_ids_check), its kernels launched.  With ``ab`` (phase
    4''), ``warmup()`` first captures the drafter's catch-up buckets and its
    drafted dispatch of the first pass count, then the stream runs captured
    twice (the first meets the later dispatches' pass count once, the second
    captures it), eagerly (``graphs_enabled`` off) and captured again, all
    from the same turn: ids equal, a drafted pass's ms each way, and the
    drafter's keys with their replays."""
    t0 = time.perf_counter()
    eng.set_drafter(**drafter)
    t_load = time.perf_counter() - t0
    runs, warm = {}, None
    try:
        if ab:
            warm = eng.warmup(prefill_buckets=(), decode_chunks=())
            for name, graphs in (("captured 1", True), ("captured 2", True), ("eager", False),
                                 ("captured", True)):
                runs[name] = ss.run(0, graphs=graphs, limit=limit)
        r = runs.get("captured") or ss.run(0, limit=limit)
        own = eng._resident.get("own")
        keys = key_replays(own.dsteps if own is not None else None)
    finally:
        eng.set_drafter()
    log(f"[speculative {label}] {what} as the drafter (loaded in {t_load:.2f} s), draft_k "
        f"{SPEC_K}: {r['tok_s']:.2f} tok/s against plain {plain_tok_s:.2f}; "
        f"{r['tokens_per_pass']:.3f} tokens per pass ({r['emitted']} in {r['passes']} passes); "
        f"launches {r['counts']}  [{card}]")
    if r["counts"]["flash_decode"] <= 0 or r["counts"]["gq_decode"] <= 0:
        raise AssertionError(f"speculative {label}: the kernels did not launch: {r['counts']}")
    out = {k: r[k] for k in KEEP + ("counts",)}
    out.update(load_s=t_load, keys=keys, check=spec_ids_check(
        label, r["ids"], want[:limit], ss.plain_margin, SPEC_TIE_DECODE, card))
    if ab:
        eag = runs["eager"]
        same = all(x["ids"] == eag["ids"] for x in runs.values())
        pass_ms = {name: x["s"] / x["passes"] * 1e3 for name, x in runs.items()}
        out.update(ab={name: {k: x[k] for k in KEEP} for name, x in runs.items()},
                   pass_ms=pass_ms, ids_equal=same, warmup_s=warm["warmup_s"])
        log(f"[graphs {label}] drafted passes captured against eager: ids equal {same} "
            f"({len(eag['ids'])} ids); a drafted pass {pass_ms['captured']:.2f} ms captured "
            f"({r['passes']} passes, {r['replays']} graph replays), "
            f"{pass_ms['eager']:.2f} ms eager ({eag['passes']} passes); the warmup captured "
            f"the drafter's steps in {warm['warmup_s']:.2f} s; drafter keys and replays {keys}  "
            f"[{card}]")
        if not same or r["replays"] <= 0 or not any(k.startswith("('draft'") and n > 0
                                                     for k, n in keys.items()):
            raise AssertionError(f"speculative {label}: the captured drafted stream differs from "
                                 f"the eager one or replayed no drafted graph: {out}")
    return out


def spec_accepted(eng, llm: Path, card: str) -> dict:
    """(f) Drafts that hold: the loaded 7B engine drafted by its own file
    (``set_drafter(draft_llm_path=llm)``) on a text turn (a drafter sees an
    image's rows as zero embeddings, so on an image turn its drafts would
    not hold), so that most of each pass's drafts are accepted: several
    tokens per pass, cursors advancing by more, the accepted drafts' cache
    rows kept and the drafter's last step filling its cache.  The ids must
    be plain greedy's and the stream must average more than 2 tokens per
    pass."""
    with SpecStreams(eng, image=False) as ss:
        plain = ss.run(0, limit=SPEC_ACCEPT_TOKENS)
        out = drafted(eng, ss, "f 7B", "its own file", {"draft_llm_path": llm}, plain["ids"],
                      SPEC_ACCEPT_TOKENS, plain["tok_s"], card)
    if not out["tokens_per_pass"] > 2:
        raise AssertionError(f"speculative f: {out['tokens_per_pass']} tokens per pass with a "
                             f"drafter equal to the model")
    return out


def only_speculative(card: str) -> None:
    """``--only-speculative``: (a)-(d) on a 13B Q5_K_M engine (warmed up),
    (f) on a 7B q5_k engine, then (e) on a session pool of the 13B files
    (32 pages, its paged group captured for 8 lanes) with the eight serving
    questions."""
    from minigpt4_tpu_torch.engine import MiniGPT4Engine
    from minigpt4_tpu_torch.engine.sessions import SessionPool

    model, llm = smoke_models(LLM_13B)
    for lg in (LLM_13B, LLM_7B):
        m, l = smoke_models(lg)
        eng = MiniGPT4Engine(m, l, device=DEVICE)
        try:
            if lg is LLM_13B:
                eng.warmup()
                speculative(eng, card)
            else:
                spec_accepted(eng, l, card)
        finally:
            eng.close()
            del eng
            gc.collect()
            torch.cuda.empty_cache()
    pool = SessionPool(model, llm, session_ctx=512, paged_pool_pages=32, device=DEVICE)
    try:
        pool.warmup(lanes=(8,))
        prepared = []
        for q in QUESTIONS:
            s = pool.new_session()
            s.ask(q)
            prepared.append(s)
        spec_batch(pool, prepared, card, torch.cuda.synchronize)
    finally:
        pool.close()


def spec_batch(pool, sessions: list, card: str, sync) -> dict:
    """(e) Copies of the eight prepared serving sessions: a plain greedy
    paged group of SPEC_BATCH_TOKENS, then with the engine's speculative_k
    at SPEC_K the same paged group and a continuous batcher of eight lanes
    (paged; counts set to 0 before these two and read after): both give
    the plain group's ids (spec_ids_check, the bf16 tie bound: B * k =
    64 rows); aggregate tok/s and the governor's demotions.  The paged
    group's verify passes replay their captured graph (key ("spec", 8,
    passes, k, None, table width)); the same group run eagerly gives its
    ids.  Then (b') the first two sessions as one speculative group of a
    greedy and a sampled lane (temp 0.8, top-k 40; counts set to 0 just
    before), captured and eager from generators seeded alike: equal ids
    (the sampled verify passes and, where the governor demotes a group
    that carries a residual ban, the banned chunk replay their graphs),
    the greedy lane gives its plain ids, and each lane's tokens per
    lane-pass of the sampled verify steps is printed."""
    from minigpt4_tpu_torch.engine import SamplingParams
    from minigpt4_tpu_torch.engine.sessions import ContinuousBatcher

    greedy = SamplingParams(temp=0.0)
    eng = pool.engine
    n0 = [s.n_past for s in sessions]

    def group(k: int, continuous: bool = False, sources=sessions, params=greedy,
              graphs: bool = True):
        eng.speculative_k = k
        eng.graphs_enabled = graphs
        lanes = [_clone(pool, s) for s in sources]
        for i, s in enumerate(lanes):
            s.state.generator.manual_seed(SEED + 200 + i)
        d0 = pool.metrics["spec_demotions"]
        sync()
        t0 = time.perf_counter()
        if continuous:
            cb = ContinuousBatcher(pool, max_batch=len(lanes))
            try:
                outs = [cb.submit(s, SPEC_BATCH_TOKENS, params) for s in lanes]
                for q in outs:
                    _drain_batcher(cb, q)
            finally:
                cb.close()
        else:
            pool.generate_batch(lanes, limit=SPEC_BATCH_TOKENS, params=params, decode_chunk=16)
        sync()
        dt = time.perf_counter() - t0
        ids = [s.state.tokens[n:] for s, n in zip(lanes, n0)]
        for s in lanes:
            s.close()
        eng.graphs_enabled = True
        return dict(ids=ids, s=dt, tok_s=sum(map(len, ids)) / dt,
                    demotions=pool.metrics["spec_demotions"] - d0)

    margins: dict = {}  # (lane, position) -> the plain margin, shared by both batchers

    def margin_at(lane: int):
        def at(j: int):
            if (lane, j) not in margins:
                c = _clone(pool, sessions[lane])
                try:
                    if j:
                        eng.decode_chunk(j, greedy, st=c.state)
                    margins[lane, j] = _margin(c.state.logits)
                finally:
                    c.close()
            return margins[lane, j]
        return at

    try:
        plain = group(0)
        reset_launch_counts()
        spec = {"window": group(SPEC_K), "continuous": group(SPEC_K, continuous=True)}
        counts = launch_counts()
        window_eager = uncounted(lambda: group(SPEC_K, graphs=False))
    finally:
        eng.speculative_k = 0
    out = {"plain_tok_s": plain["tok_s"], "counts": counts}
    for name, r in spec.items():
        checks = [spec_ids_check(f"e {name} lane {i}", got, want, margin_at(i), SPEC_TIE_PREFILL,
                                 card) for i, (got, want) in enumerate(zip(r["ids"], plain["ids"]))]
        out[name] = dict(s=r["s"], tok_s=r["tok_s"], demotions=r["demotions"],
                         lanes_equal=sum(c["equal"] for c in checks), checks=checks)
        log(f"[speculative e] {name} batcher, {len(sessions)} paged lanes x {SPEC_BATCH_TOKENS} "
            f"greedy ids at k = {SPEC_K}: {r['tok_s']:.2f} tok/s aggregate against the plain "
            f"paged group's {plain['tok_s']:.2f}; spec_demotions {r['demotions']}; lanes equal to "
            f"plain {out[name]['lanes_equal']} of {len(checks)}  [{card}]")
    log(f"[speculative e] launches of the two speculative batchers: {counts}  [{card}]")
    if counts["paged_flash_decode"] <= 0 or counts["gq_prefill"] <= 0:
        raise AssertionError(f"speculative e: the batched verify's kernels did not launch: "
                             f"{counts}")
    keys = {k: n for k, n in key_replays(pool._paged_graphs).items()
            if k.startswith(("('spec'", "('spec_stoch'", "('decode_ban'"))}
    same = spec["window"]["ids"] == window_eager["ids"]
    out["window_eager"] = dict(s=window_eager["s"], tok_s=window_eager["tok_s"], ids_equal=same)
    log(f"[graphs speculative e] the {len(sessions)}-lane paged speculative group captured "
        f"{spec['window']['tok_s']:.2f} tok/s aggregate against eager "
        f"{window_eager['tok_s']:.2f}; ids equal {same}; the group's verify keys and replays "
        f"{keys}  [{card}]")
    if not same or not any(k.startswith("('spec'") and n > 0 for k, n in keys.items()):
        raise AssertionError(f"speculative e: the captured speculative group differs from the "
                             f"eager one or replayed no verify graph: {keys}")

    # (b') a greedy and a sampled lane in one group: the sampled verify
    # steps, recorded by wrapping the group's step
    steps: list = []  # (verify passes, tokens per lane) of each sampled step
    step = pool._group_step

    def rec(group, *a):
        res = step(group, *a)
        if a[5] and group["rows"].traced is not None:  # verify passes of a sampled group
            steps.append((a[5], [len(t) for t in res[0]]))
        return res

    pool._group_step = rec
    pair_params = [greedy, SamplingParams(**SAMPLED)]
    try:
        reset_launch_counts()
        pair = group(SPEC_K, sources=sessions[:2], params=pair_params)
        pair_counts = launch_counts()
        n_steps = len(steps)
        # again captured (a key the first run met once is captured and
        # replayed now), then eagerly
        pair2, pair_eager = (uncounted(lambda g=g: group(SPEC_K, sources=sessions[:2],
                                                         params=pair_params, graphs=g))
                             for g in (True, False))
        del steps[n_steps:]
    finally:
        del pool._group_step
        eng.speculative_k = 0
    passes = sum(p for p, _ in steps)
    per_lane = [sum(t[i] for _, t in steps) / passes if passes else None for i in range(2)]
    log(f"[speculative b'] paged group of a greedy and a sampled lane (temp 0.8, top-k 40), "
        f"{SPEC_BATCH_TOKENS} ids each at k = {SPEC_K} (M = {2 * SPEC_K}): {pair['tok_s']:.2f} "
        f"tok/s aggregate; {len(steps)} sampled verify steps of {passes} passes, tokens per "
        f"lane-pass {per_lane}; spec_demotions {pair['demotions']}; launches "
        f"gq_prefill {pair_counts['gq_prefill']}, paged_flash_decode "
        f"{pair_counts['paged_flash_decode']}  [{card}]")
    if not steps or pair_counts["gq_prefill"] <= 0 or pair_counts["paged_flash_decode"] <= 0:
        raise AssertionError(f"speculative b': no sampled verify step ran ({steps}) or its "
                             f"kernels did not launch ({pair_counts})")
    keys = {k: n for k, n in key_replays(pool._paged_graphs).items()
            if k.startswith(("('spec_stoch'", "('decode_ban'"))}
    pair_same = pair["ids"] == pair2["ids"] == pair_eager["ids"]
    log(f"[graphs speculative b'] the greedy + sampled pair captured {pair['tok_s']:.2f} and "
        f"{pair2['tok_s']:.2f} tok/s aggregate against eager {pair_eager['tok_s']:.2f}, from "
        f"generators seeded alike: ids equal {pair_same}; sampled verify and banned-chunk keys "
        f"and replays {keys}  [{card}]")
    if not pair_same or not any(k.startswith("('spec_stoch'") and n > 0
                                for k, n in keys.items()):
        raise AssertionError(f"speculative b': the captured pair differs from the eager one or "
                             f"replayed no sampled verify graph: {keys}")
    out["pair"] = dict(s=pair["s"], tok_s=pair["tok_s"], demotions=pair["demotions"],
                       steps=steps, tokens_per_lane_pass=per_lane, counts=pair_counts,
                       replayed_tok_s=pair2["tok_s"], eager_tok_s=pair_eager["tok_s"],
                       ids_equal=pair_same, keys=keys,
                       check=spec_ids_check("b' greedy lane", pair["ids"][0], plain["ids"][0],
                                            margin_at(0), SPEC_TIE_PREFILL, card))
    return out


# ---------------------------------------------------------------------------
# phase 5, continued: continuous batching, the prefix cache and parking
# ---------------------------------------------------------------------------

CONT_LANES = 8
CONT_STAGGER_S = 0.25  # between the eight requests' starts: later ones join a running group
CONT_KERNELS = ("gq_decode", "gq_decode_generic", "paged_flash_decode")
PARK_TOKENS = 16


def _stream_chat(base: str, messages: list, limit: int) -> dict:
    """One streamed /v1/chat/completions request (greedy): its text, the
    content chunks it streamed (one a token), the seconds to the first one
    and in all."""
    req = urllib.request.Request(base + "/v1/chat/completions", method="POST", data=json.dumps(
        {"messages": messages, "temperature": 0.0, "max_tokens": limit,
         "stream": True}).encode())
    t0 = time.perf_counter()
    first, parts = None, []
    with urllib.request.urlopen(req, timeout=600) as r:
        for line in r:
            line = line.strip()
            if not line.startswith(b"data: ") or line == b"data: [DONE]":
                continue
            content = json.loads(line[6:])["choices"][0]["delta"].get("content")
            if content:
                first = first if first is not None else time.perf_counter() - t0
                parts.append(content)
    return dict(text="".join(parts), n=len(parts), ttft=first, s=time.perf_counter() - t0)


def _drain_batcher(cb, out) -> str:
    parts = []
    while (t := out.get(timeout=600)) is not cb._DONE:
        if isinstance(t, Exception):
            raise t
        parts.append(t)
    return "".join(parts)


def _batcher_run(cb, sessions: list, limit) -> tuple[list, float]:
    """Every session through the batcher at once, greedy: texts and seconds."""
    from minigpt4_tpu_torch.engine import SamplingParams

    limits = limit if isinstance(limit, list) else [limit] * len(sessions)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [cb.submit(s, n, SamplingParams(temp=0.0)) for s, n in zip(sessions, limits)]
    texts = [_drain_batcher(cb, o) for o in outs]
    torch.cuda.synchronize()
    return texts, time.perf_counter() - t0


def prefix_times(pool, card: str) -> dict:
    """The system prompt on a miss (prefill and capture, the cache emptied
    first) and on two hits (rows and logits installed), on the pool's
    lock."""
    with pool._lock:
        pool._prefix_cache.clear()
        pool._prefix_bytes = 0
    ms = []
    sessions = [pool.new_session() for _ in range(3)]
    hits0 = pool.metrics["prefix_cache_hits"]
    for s in sessions:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pool.system_prompt(s)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    same = all(s.state.tokens == sessions[0].state.tokens
               and torch.equal(s.state.logits, sessions[0].state.logits) for s in sessions[1:])
    n = sessions[0].n_past
    log(f"[continuous] the system prompt ({n} positions): {ms[0]:.2f} ms on a miss (prefill and "
        f"capture), {ms[1]:.2f} and {ms[2]:.2f} ms on two hits (installed); pending logits equal "
        f"{same}  [{card}]")
    if pool.metrics["prefix_cache_hits"] != hits0 + 2 or not same:
        raise AssertionError("continuous: the later system prompts did not install the first")
    for s in sessions:
        s.close()
    return dict(miss_ms=ms[0], hit_ms=ms[1:], positions=n)


def forced_preemption(pool, cb, sources: list, card: str) -> dict:
    """Two sessions through the server's paged batcher, each generating past
    its next page edge, while all but one spare page of what they hold is
    taken: the younger lane is preempted and resumes.  Its text and history
    must equal those of the same two sessions with the pool free."""
    from minigpt4_tpu_torch.engine.paged import PAGE

    ppool = pool.paged_pool
    limit = max(PAGE * ppool.pages_for(s.n_past) - s.n_past for s in sources) + 24
    runs = {}
    for tight in (True, False):
        lanes = [_clone(pool, s) for s in sources]
        held = []
        if tight:
            with pool._lock:
                spare = ppool.free_pages - sum(ppool.pages_for(s.n_past) for s in lanes) - 1
                held = ppool.alloc(spare)
        pre0 = cb.preemptions
        try:
            texts, dt = _batcher_run(cb, lanes, limit)
        finally:
            if held:
                with pool._lock:
                    ppool.free(held)
        runs[tight] = dict(texts=texts, tokens=[list(s.state.tokens) for s in lanes],
                           preemptions=cb.preemptions - pre0, s=dt)
        for s in lanes:
            s.close()
    same = runs[True]["texts"] == runs[False]["texts"] and \
        runs[True]["tokens"] == runs[False]["tokens"]
    log(f"[continuous] forced preemption: two lanes of {[s.n_past for s in sources]} positions, "
        f"{limit} tokens each, one spare page: {runs[True]['preemptions']} preemption(s) "
        f"({runs[True]['s']:.2f} s); with the pool free {runs[False]['preemptions']} "
        f"({runs[False]['s']:.2f} s); texts and histories equal {same}  [{card}]")
    if runs[True]["preemptions"] < 1 or runs[False]["preemptions"] or not same:
        raise AssertionError(f"continuous: the forced preemption failed: {runs}")
    return dict(limit=limit, preemptions=runs[True]["preemptions"], tight_s=runs[True]["s"],
                free_s=runs[False]["s"])


def park_check(pool, source, card: str) -> dict:
    """Park a 13B session and put it back (seconds and bytes), then its next
    PARK_TOKENS greedy ids against those of an unparked copy."""
    from minigpt4_tpu_torch.engine import SamplingParams
    from minigpt4_tpu_torch.engine.hostcopy import STAGE_BYTES

    s, twin = _clone(pool, source), _clone(pool, source)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.park()
    t_park = time.perf_counter() - t0
    nbytes = s.state.parked["k"].nbytes + s.state.parked["v"].nbytes
    t0 = time.perf_counter()
    with pool._lock:
        s.state.ensure_device()
    torch.cuda.synchronize()
    t_unpark = time.perf_counter() - t0
    n0 = s.n_past
    for x in (s, twin):
        list(x.generate(limit=PARK_TOKENS, params=SamplingParams(temp=0.0)))
    same = s.state.tokens[n0:] == twin.state.tokens[n0:]
    log(f"[continuous] park of a {n0}-position 13B session: {nbytes / 1e6:.2f} MB to pageable "
        f"host memory (through {2 * STAGE_BYTES / 2**20:.0f} MiB of page-locked staging) in {t_park * 1e3:.2f} ms, back in {t_unpark * 1e3:.2f} ms; next "
        f"{len(s.state.tokens) - n0} greedy ids equal to an unparked copy's: {same}  [{card}]")
    if not same:
        raise AssertionError("continuous: a parked session decoded other ids than its copy")
    for x in (s, twin):
        x.close()
    return dict(park_s=t_park, unpark_s=t_unpark, bytes=nbytes, positions=n0)


def continuous_serving(card: str, window: dict, lg: dict = LLM_13B, pages: int = 32,
                       limit: int = 32) -> dict:
    """Continuous batching on the 13B files: a server of CONT_LANES lanes
    over a pool of ``pages`` pages with --park-idle (start seconds beside the
    window server's), the eight QUESTIONS streamed through the OpenAI route
    CONT_STAGGER_S apart (joins, aggregate and per-request tok/s, time to
    the first token, prefix-cache hits), then on its pool: the system
    prompt on a miss and a hit, the eight prepared sessions through the
    paged batcher and a dense one (ids equal), a forced preemption and a
    park."""
    from minigpt4_tpu_torch import serve
    from minigpt4_tpu_torch.engine.sessions import ContinuousBatcher

    t_pass = time.perf_counter()
    model, llm = smoke_models(lg)
    t0 = time.perf_counter()
    httpd = serve.start_server(model, llm, port=0, session_ctx=512, continuous=True,
                               max_batch=CONT_LANES, paged_pages=pages, park_idle=True,
                               device=DEVICE)
    torch.cuda.synchronize()
    t_start = time.perf_counter() - t0
    pool, cb, warm = httpd.pool, httpd.batcher, httpd.warmup
    log(f"[continuous] start {t_start:.2f} s, of it the warmup {warm['warmup_s']:.2f} s capturing "
        f"{warm['graphs']} graphs (all-greedy and traced rows at {CONT_LANES} lanes); the window "
        f"server's start {window['load_s']:.2f} s with {window['warmup']['graphs']} graphs in "
        f"{window['warmup']['warmup_s']:.2f} s  [{card}]")
    if warm["graphs"] != 2:
        raise AssertionError(f"continuous: the start captured {warm['graphs']} graphs, not 2")
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    img = np.random.default_rng(SEED + 2).integers(0, 256, (480, 640, 3), dtype=np.uint8)
    url = "data:image/png;base64," + base64.b64encode(_png(img)).decode()
    results: list = [None] * len(QUESTIONS)

    def client(i: int) -> None:
        time.sleep(i * CONT_STAGGER_S)
        content = QUESTIONS[i] if i < len(QUESTIONS) - 1 else [
            {"type": "text", "text": QUESTIONS[i]}, {"type": "image_url", "image_url": {"url": url}}]
        t1 = time.perf_counter()
        try:
            results[i] = dict(_stream_chat(base, [{"role": "user", "content": content}], limit),
                              t0=t1, t1=time.perf_counter())
        except Exception as e:  # reported below, never ignored
            results[i] = dict(error=f"{type(e).__name__}: {e}")

    try:
        reset_launch_counts()  # the HTTP requests' own launches
        gen0 = pool.metrics["tokens_generated"]
        clients = [threading.Thread(target=client, args=(i,)) for i in range(len(QUESTIONS))]
        for c in clients:
            c.start()
        for c in clients:
            c.join()
        torch.cuda.synchronize()
        counts = launch_counts()
        joins = cb.joins
        bad = [(i, r) for i, r in enumerate(results) if "error" in r or not r["text"]]
        if bad:
            raise AssertionError(f"continuous: failed or empty responses: {bad}")
        n_gen = pool.metrics["tokens_generated"] - gen0
        span = max(r["t1"] for r in results) - min(r["t0"] for r in results)
        per_req = [r["n"] / r["s"] for r in results]
        ttft = [r["ttft"] * 1e3 for r in results]
        _, raw = _request(base, "/v1/health", method="GET")
        health = json.loads(raw)
        hits = health["metrics"]["prefix_cache_hits"]
        log(f"[continuous] {len(QUESTIONS)} streamed OpenAI requests {CONT_STAGGER_S} s apart (a "
            f"PNG in the last): joins {joins}, launches {counts}")
        log(f"[continuous] {n_gen} tokens in {span:.3f} s = {n_gen / span:.2f} tok/s aggregate; "
            f"per request {[round(x, 2) for x in per_req]} tok/s of {[r['n'] for r in results]} "
            f"streamed tokens; first token after {[round(x, 1) for x in ttft]} ms; prefix cache "
            f"hits {hits}, misses {health['metrics']['prefix_cache_misses']}, "
            f"{health['prefix_cache']}; /v1/health {health['paged']}  [{card}]")
        for r, q in zip(results, QUESTIONS):
            log(f"[continuous]   {q[:32]!r:36s} -> {r['text'][:40]!r}")
        res = pool.engine._resident.get(pool.session_ctx)
        log(f"[graphs continuous] the requests' sessions replayed {res.steps.replays} graphs of "
            f"{len(res.steps.graphs)} keys over the resident cache: "
            f"{key_replays(res.steps)}  [{card}]")
        missing = [k for k in CONT_KERNELS if counts.get(k, 0) <= 0]
        if joins < 1 or hits < 7 or missing or health["paged"]["free_pages"] != pages:
            raise AssertionError(f"continuous: joins {joins}, prefix hits {hits}, kernels never "
                                 f"launched {missing}, pages {health['paged']}")
        # a stateless request gives its text again after a longer
        # conversation that opens with it was captured (which prunes its entry)
        one = [{"role": "user", "content": QUESTIONS[1]}]
        before = _stream_chat(base, one, limit)["text"]
        _stream_chat(base, one + [{"role": "assistant", "content": before},
                                  {"role": "user", "content": "Go on."}], limit)
        hits0 = pool.metrics["prefix_cache_hits"]
        after = _stream_chat(base, one, limit)["text"]
        log(f"[continuous] a stateless request before and after a longer conversation of the same "
            f"opening: texts equal {after == before}, exact hits "
            f"{pool.metrics['prefix_cache_hits'] - hits0}  [{card}]")
        if after != before:
            raise AssertionError(f"continuous: {after!r} != {before!r} after a longer conversation")
        prefix = prefix_times(pool, card)
        prepared = []
        for i, q in enumerate(QUESTIONS):
            s = pool.new_session()
            if i == len(QUESTIONS) - 1:
                s.upload_image(_preprocess(img, pool))
            else:
                pool.system_prompt(s)
            s.ask(q)
            prepared.append(s)
        paged_lanes = [_clone(pool, s) for s in prepared]
        dense_lanes = [_clone(pool, s) for s in prepared]
        # one chunk each way: the dense batcher's first use of its key runs eagerly
        paged_texts, t_paged = _batcher_run(cb, paged_lanes, cb.decode_chunk)
        dense_cb = ContinuousBatcher(pool, max_batch=CONT_LANES, paged=False)
        try:
            dense_texts, t_dense = _batcher_run(dense_cb, dense_lanes, cb.decode_chunk)
        finally:
            dense_cb.close()
        same = ([s.state.tokens for s in paged_lanes] == [s.state.tokens for s in dense_lanes]
                and paged_texts == dense_texts)
        log(f"[continuous] the eight prepared sessions through the batcher, {cb.decode_chunk} "
            f"greedy tokens: paged (captured) {t_paged:.3f} s, dense (stacked cache, eager) "
            f"{t_dense:.3f} s; ids equal {same}  [{card}]")
        if not same:
            raise AssertionError("continuous: the paged and dense batchers gave other ids")
        for s in paged_lanes + dense_lanes:
            s.close()
        del dense_cb
        preempt = forced_preemption(pool, cb, prepared[:2], card)
        park = park_check(pool, prepared[-1], card)
        for s in prepared:
            s.close()
    finally:
        httpd.shutdown()
        server.join(timeout=60)
        httpd.server_close()  # stops the batcher, whose thread holds the pool
        pool.close()
        del pool, httpd, cb
        gc.collect()
        torch.cuda.empty_cache()
    t_all = time.perf_counter() - t_pass
    log(f"[continuous] the pass took {t_all:.1f} s  [{card}]")
    return dict(counts=counts, start_s=t_start, warmup=warm, joins=joins,
                agg_tok_s=n_gen / span, per_request_tok_s=per_req, ttft_ms=ttft, hits=hits,
                prefix=prefix, paged_s=t_paged, dense_s=t_dense, preemption=preempt, park=park,
                pass_s=t_all)


# ---------------------------------------------------------------------------
# phase 7: w8a8 over an e4m3 cache, and the quality harness
# ---------------------------------------------------------------------------

CALIB_TOKENS = 32  # one calibration sequence for the smooth-quant scales


def smooth_scales_13b(llm: Path, card: str) -> dict:
    """Smooth-quant scales of a 13B-width file from quality.compute_smooth_scales
    (qtensor params on the card, freed before it returns) on one
    calibration sequence."""
    from minigpt4_tpu_torch import quality

    calib = [np.random.default_rng(SEED + 4).integers(3, LLM_13B["n_vocab"], CALIB_TOKENS)]
    t0 = time.perf_counter()
    scales = quality.compute_smooth_scales(llm, calib, device=DEVICE)
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter() - t0
    bad = [k for k, v in scales.items() if not (np.isfinite(v).all() and (v > 0).all())]
    if set(scales) != {"attn", "ffn", "w2", "head"} or bad:
        raise AssertionError(f"smooth scales: sites {sorted(scales)}, not finite/positive {bad}")
    log(f"[w8a8] smooth scales of {llm.name} from {CALIB_TOKENS} calibration tokens in "
        f"{t:.1f} s (qtensor load, calibration forward, weight column maxima): "
        + ", ".join(f"{k} {v.shape} [{v.min():.3g}, {v.max():.3g}]" for k, v in scales.items())
        + f"  [{card}]")
    return scales


def w8a8_f8(card: str) -> dict:
    """The 13B Q5_K_M geometry cut to 8 layers (LLM_13B_L8, for the script's
    time limit) in quant_mode="w8a8" with smooth-quant scales over
    an e4m3 cache, behind the 13B q5_1 container (ViT-G fc2 and the Q-Former
    and llama_proj weights of K % 256 == 0 become i8, the K = 1408 weights
    repacked): a SessionPool (32 pages of e4m3 pools) whose engine runs the
    chat of :func:`chat_on`, then eight sessions decode as a paged group
    (its graphs captured first, as a server's start does) and as a dense
    group, token for token equal.  i8_decode, i8_prefill,
    rq_prefill and both flash kernels must launch, no gq kernel may."""
    from minigpt4_tpu_torch.engine import SamplingParams
    from minigpt4_tpu_torch.engine.sessions import SessionPool
    from minigpt4_tpu_torch.ops import i8_matmul as i8

    _, llm = smoke_models(LLM_13B_L8)
    model = smoke_container(LLM_13B["n_embd"], "q5_1")
    scales = smooth_scales_13b(llm, card)
    label = W8A8_LABEL
    t0 = time.perf_counter()
    pool = SessionPool(model, llm, session_ctx=512, paged_pool_pages=32, device=DEVICE,
                       quant_mode="w8a8", cache_dtype="f8", smooth_scales=scales)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    try:
        eng = pool.engine
        layers = eng.llm_params["layers"]
        if not (all(isinstance(layers[n]["w"], i8.I8SBQuant) for n in ("wqkv", "wo", "w13", "w2"))
                and eng.cache_dtype == torch.float8_e4m3fn):
            raise AssertionError(f"{label}: decoder weights {[type(layers[n]['w']).__name__ for n in layers]}"
                                 f", cache {eng.cache_dtype}")
        warm = eng.warmup()
        log_warmup(label, warm, card)
        group_warm = pool.warmup(lanes=(len(QUESTIONS),))  # as a server warms its groups
        log(f"[graphs {label}] the paged group's greedy and sampled chunks of "
            f"{len(QUESTIONS)} lanes captured in {group_warm['warmup_s']:.2f} s; the pool holds "
            f"{group_warm['pool_bytes'] / 1e9:.3f} GB  [{card}]")
        tools = w8a8_tools(eng, card)
        reset_launch_counts()  # the chat's and the paged group's own launches
        out = chat_on(eng, label, card)
        out["graphs"] = dict(uncounted(lambda: graph_ab(eng, label, card)), warmup=warm)
        sessions = []
        for q in QUESTIONS:
            s = pool.new_session()
            s.ask(q)
            sessions.append(s)
        dense = [_clone(pool, s) for s in sessions]
        n0 = [s.n_past for s in sessions]
        greedy = SamplingParams(temp=0.0)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pool.generate_batch(sessions, limit=32, params=greedy, decode_chunk=16)
        torch.cuda.synchronize()
        t_paged = time.perf_counter() - t1
        pool.generate_batch(dense, limit=32, params=greedy, decode_chunk=16, paged=False)
        got = [s.state.tokens[n:] for s, n in zip(sessions, n0)]
        want = [s.state.tokens[n:] for s, n in zip(dense, n0)]
        n_tok = sum(len(t) for t in got)
        log(f"[w8a8] 8-lane group over e4m3 pools, 32 greedy tokens: paged {t_paged:.3f} s = "
            f"{n_tok / t_paged:.2f} tok/s aggregate; paged tokens equal to the dense group's: "
            f"{got == want}  [{card}]")
        if got != want or not all(got):
            raise AssertionError(f"{label}: the paged group's tokens differ from the dense "
                                 f"group's: {got} vs {want}")
        if pool.paged_pool.free_pages != 32:
            raise AssertionError(f"{label}: the paged group did not return its pages")
        for s in sessions + dense:
            s.close()
    finally:
        pool.close()
        del pool
        gc.collect()
        torch.cuda.empty_cache()
    out = check_launches(label, dict(out, load_s=t_load, group_tok_s=n_tok / t_paged),
                         W8A8_KERNELS, GQ_KERNELS + PACKED_KERNELS, card)
    return dict(out, tools=tools)


def quality_run(card: str) -> dict:
    """python -m minigpt4_tpu_torch.quality at the small geometry on the card:
    all five rows, the table, both gates and its JSON line."""
    from minigpt4_tpu_torch import quality

    reset_launch_counts()
    t0 = time.perf_counter()
    res = quality.main(["--geometry", "small", "--device", DEVICE,
                        "--workdir", str(ROOT / "build" / "smoke_models" / "quality-small")])
    t = time.perf_counter() - t0
    counts = launch_counts()
    bad = [k for k, m in res.items() if not all(np.isfinite(m[c]) for c in
                                                 ("kl_mean", "kl_p95", "top1", "d_ppl_pct"))]
    if list(res) != list(quality.PATHS) or bad:
        raise AssertionError(f"quality: rows {list(res)}, not finite {bad}")
    log(f"[quality] five rows at the small geometry in {t:.1f} s; launches {counts}  [{card}]")
    return dict(counts=counts, seconds=t, rows=res)


# ---------------------------------------------------------------------------
# phase 9: tensor parallelism, two ranks on one card
# ---------------------------------------------------------------------------

# Vicuna-13B at full width, every projection q5_k (one format per name, so
# every weight splits; a Q5_K_M file's mixed wv / w2 lists cannot), cut to 8
# layers for the script's time limit: at full depth two ranks over gloo on one
# card decode at ~4 tok/s and the phase took 216 s (H100 80GB HBM3, 700 W)
LLM_13B_Q5K = dict(LLM_13B, layout="q5_k", n_layer=8)
TP = 2
# the tp=2 / tp=1 logit gap against depth: the same geometry cut to these
# depths; at the first, max |dlogit| / max |logit| <= TP_LOGIT_TOL.  A rank's
# sums differ from tp=1's only in f32 order (the wo / w2 K halves, and
# kernels at half the output rows), but such differences flip bf16 roundings
# of later matmul inputs and grow with depth; a fault of the split (a wrong
# K slice) moves the logits by a share of their size already at one layer
TP_DEPTHS = (1, 4)
TP_LOGIT_TOL = 1e-3
TP_PREFIX = 8  # greedy ids that must agree from the first
TP_KERNELS = ("rq_decode", "rq_prefill", "flash_decode")


# the second tp slice: the sharded encoder, the sharded training step,
# serving over the ranks and speculation under tp, on the phase's engine
TP_ENCODE_TOL = 1e-4  # of max|emb|: f32 sums of ViT-G's split proj / fc2 in another order
TP_TRAIN_STEPS = 3
TP_TRAIN_LR = 1e-4
TP_TRAIN_LOSS_RTOL = 1e-4  # per step, against tp=1 (f32 sums in another order)
TP_TRAIN_GRAD_TOL = 1e-4  # of max|grad|, the first step's gradient against tp=1's
# llama_proj after the steps, the mean |d| over its elements: Adam moves an
# element by about lr a step whatever the size of its gradient, so the few
# elements whose gradient is near 0 follow the f32 noise of the two sums'
# orders, while a wrong gradient turns a share of the elements the other way
# (2 lr each): more than one element in 2000 so turned exceeds this bound
TP_TRAIN_PROJ_TOL = 1e-3 * TP_TRAIN_LR
TP_ADAM_EPS = 1e-8  # torch.optim.Adam's default
TP_SERVE_PROMPTS = ["Hi.", "What is the capital of France?", "List three fruits.",
                    "What is in this picture?"]  # the last with the PNG
TP_SERVE_TOKENS = 32
TP_SERVE_PAGES = 32
TP_SPEC_TOKENS = 32


def tp_train_batch(vcfg) -> tuple:
    """The train phase's batch: 2 images of the chat's size and 24-token
    captions (BOS first), from the seed."""
    rng = np.random.default_rng(SEED + 11)
    size = vcfg.vit.image_size
    pixels = rng.normal(0, 1, (2, 3, size, size)).astype(np.float32)
    tokens = np.concatenate([np.ones((2, 1), np.int64), rng.integers(3, 32000, (2, 23))], axis=1)
    return pixels, tokens, np.ones((2, 24), np.float32)


def tp_train(vision: dict, vcfg, llm: dict, lcfg, tp, label: str, card: str) -> dict:
    """TP_TRAIN_STEPS Adam steps of ``llama_proj`` through ``vision`` /
    ``llm`` (this rank's shards under ``tp``), forward and backward timed
    apart; no kernel may launch (the trainers run plain torch)."""
    from minigpt4_tpu_torch.profiling import device_memory_stats
    from minigpt4_tpu_torch.train.projection import caption_loss

    dev = torch.device(DEVICE, torch.cuda.current_device())
    pixels, tokens, mask = (torch.from_numpy(a).to(dev) for a in tp_train_batch(vcfg))
    proj = {k: v.detach().clone().requires_grad_(True) for k, v in vision["llama_proj"].items()}
    frozen = {"vision": {k: v for k, v in vision.items() if k != "llama_proj"}, "llm": llm}
    opt = torch.optim.Adam(list(proj.values()), lr=TP_TRAIN_LR)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    losses, fwd, bwd, grad = [], [], [], None
    for _ in range(TP_TRAIN_STEPS):
        opt.zero_grad(set_to_none=True)
        t0 = time.perf_counter()
        loss = caption_loss(proj, frozen, pixels, tokens, mask, vcfg, lcfg, tp)
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize(dev)
        fwd.append(t1 - t0)
        bwd.append(time.perf_counter() - t1)
        if grad is None:
            grad = {k: v.grad.cpu().numpy() for k, v in proj.items()}
        opt.step()
        losses.append(float(loss))
    counts = launch_counts()
    if any(counts.values()):
        raise AssertionError(f"{label}: kernels launched in the training step: {counts}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{label}: losses {losses}")
    mem = device_memory_stats(dev)
    log(f"[{label}] {TP_TRAIN_STEPS} Adam steps of llama_proj (2 images, 24-token captions): "
        f"losses {[round(x, 6) for x in losses]}; forward {statistics.median(fwd):.3f} s, "
        f"backward {statistics.median(bwd):.3f} s a step (median); peak "
        f"{mem['peak_bytes_in_use'] / 1e9:.2f} GB of {mem['bytes_limit'] / 1e9:.1f} GB; no "
        f"kernel launched  [{card}]")
    return dict(losses=losses, fwd_s=fwd, bwd_s=bwd, peak_gb=mem["peak_bytes_in_use"] / 1e9,
                proj={k: v.detach().cpu().numpy() for k, v in proj.items()}, grad=grad,
                counts=counts)


def tp_grad_without_copy(vision: dict, vcfg, llm: dict, lcfg, tp) -> dict:
    """The first step's gradient of ``llama_proj`` with ``copy_to_tp`` taken
    out of the decoder, so that its column-parallel inputs keep this rank's
    partial gradient: the wrong update that TP_TRAIN_PROJ_TOL must see."""
    from minigpt4_tpu_torch.models import llama as llama_mod
    from minigpt4_tpu_torch.train.projection import caption_loss

    dev = torch.device(DEVICE, torch.cuda.current_device())
    pixels, tokens, mask = (torch.from_numpy(a).to(dev) for a in tp_train_batch(vcfg))
    proj = {k: v.detach().clone().requires_grad_(True) for k, v in vision["llama_proj"].items()}
    frozen = {"vision": {k: v for k, v in vision.items() if k != "llama_proj"}, "llm": llm}
    saved = llama_mod.copy_to_tp
    llama_mod.copy_to_tp = lambda x, group: x
    try:
        caption_loss(proj, frozen, pixels, tokens, mask, vcfg, lcfg, tp).backward()
    finally:
        llama_mod.copy_to_tp = saved
    return {k: v.grad.cpu().numpy() for k, v in proj.items()}


def adam_first_step_gap(a: dict, b: dict) -> float:
    """The mean |d| over every element between Adam's first updates from the
    gradients ``a`` and ``b`` (lr g / (|g| + eps) after bias correction)."""
    def step(g):
        return TP_TRAIN_LR * g / (np.abs(g) + TP_ADAM_EPS)

    total = sum(float(np.abs(step(a[k]) - step(v)).sum()) for k, v in b.items())
    return total / sum(v.size for v in b.values())


def tp_refs(eng, llm: str, card: str) -> dict:
    """What the tp ranks are held to, from the tp=1 engine of the same files:
    the chat image's embedding, the training steps (the decoder loaded
    again as qtensor, f32) and the greedy ids of the served requests."""
    from minigpt4_tpu_torch.engine import SamplingParams
    from minigpt4_tpu_torch.formats import LlamaFileReader
    from minigpt4_tpu_torch.image import preprocess
    from minigpt4_tpu_torch.models import llama as llama_mod
    from minigpt4_tpu_torch.models import minigpt4 as vision_mod

    px = preprocess(chat_image(), size=eng.vision_cfg.vit.image_size)
    with torch.no_grad():
        emb = vision_mod.encode_image(eng.vision_params, torch.from_numpy(px[None]).to(
            eng.device), eng.vision_cfg).cpu().numpy()
    with LlamaFileReader(llm) as r:
        qt, qcfg = llama_mod.load_params(r, torch.float32, n_ctx=64, device=eng.device,
                                         quant_mode="qtensor")
    train = tp_train(eng.vision_params, eng.vision_cfg, qt, qcfg, None, "tp=1 train", card)
    del qt
    ids, prompts = [], []
    for i, q in enumerate(TP_SERVE_PROMPTS):  # as the server's session routes feed them
        eng.reset()
        if i == len(TP_SERVE_PROMPTS) - 1:
            eng.system_prompt()
            eng.begin_chat_image(eng.encode_image(px), q)
        else:
            eng.begin_chat(q)
        prompts.append(eng.n_past)
        list(eng.generate(limit=TP_SERVE_TOKENS, params=SamplingParams(temp=0.0)))
        ids.append(eng._st.tokens[prompts[-1]:])
    gc.collect()
    torch.cuda.empty_cache()
    return {"emb": emb, "train": train, "serve_ids": ids, "serve_prompts": prompts}


def tp_serve(g, eng, model: str, llm: str, label: str, server: dict, refs: dict,
             card: str) -> dict:
    """``start_server(tp=2)`` over a pool on this rank's engine: rank 0
    serves the four requests of TP_SERVE_PROMPTS at once (the last after a
    PNG upload), 32 greedy ids each, profiled; the others follow.  The
    requests are held at the batcher until all four have prefilled (their
    prefills run one after another under the controller's order), so that
    they decode together: some group (window) or step (continuous) must
    hold two lanes or more.  Rank 0's ids (its sessions' tokens) against
    tp=1's: the first TP_PREFIX must agree.  Every operation's ids agreed
    across the ranks, or the request failed (``parallel/controller.py``)."""
    from minigpt4_tpu_torch import serve
    from minigpt4_tpu_torch.engine.sessions import SessionPool
    from minigpt4_tpu_torch.profiling import collective_seconds

    pool = SessionPool(model, llm, session_ctx=512, paged_pool_pages=TP_SERVE_PAGES, engine=eng)
    reset_launch_counts()
    httpd = serve.start_server(model, llm, port=0, tp=g.size, pool=pool, **server)
    if httpd is None:  # a follower: rank 0 closed the server
        return {"counts": launch_counts()}
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    results = [None] * len(TP_SERVE_PROMPTS)
    lanes = []  # lanes of each window group, or active lanes of each continuous step
    batcher = httpd.batcher
    submit, together = batcher.submit, threading.Barrier(len(TP_SERVE_PROMPTS), timeout=300)

    def held_submit(*a, **k):
        together.wait()
        return submit(*a, **k)

    batcher.submit = held_submit
    if server.get("continuous"):
        step = batcher._step
        batcher._step = lambda: (lanes.append(batcher._n_active()), step())[1]
    else:
        stream = pool.generate_batch_stream
        pool.generate_batch_stream = lambda sessions, *a, **k: (
            lanes.append(len(sessions)), stream(sessions, *a, **k))[1]

    def client(i):
        try:
            _, raw = _request(base, "/v1/sessions")
            sid = json.loads(raw)["session_id"]
            if i == len(TP_SERVE_PROMPTS) - 1:
                _request(base, f"/v1/sessions/{sid}/image", _png(chat_image()))
            st, raw = _request(base, f"/v1/sessions/{sid}/chat", json.dumps(
                {"message": TP_SERVE_PROMPTS[i], "limit": TP_SERVE_TOKENS,
                 "temp": 0.0}).encode())
            results[i] = dict(status=st, sid=sid)
        except Exception as e:  # reported below
            results[i] = dict(status=None, error=f"{type(e).__name__}: {e}")

    def run():
        clients = [threading.Thread(target=client, args=(i,)) for i in range(len(results))]
        for c in clients:
            c.start()
        for c in clients:
            c.join()

    try:
        c0, n0 = collective_seconds()
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
        coll_s, n_coll = (a - b for a, b in zip(collective_seconds(), (c0, n0)))
        bad = [r for r in results if r["status"] != 200]
        if bad or httpd.ranks.ctl.broken:
            raise AssertionError(f"{label}: failed requests {bad}; {httpd.ranks.ctl.broken}")
        ids = [pool._sessions[r["sid"]].state.tokens[n0:]
               for r, n0 in zip(results, refs["serve_prompts"])]
        ops = httpd.ranks.ctl.ops
    finally:
        httpd.shutdown()
        httpd.server_close()
        for obj, name in ((batcher, "submit"), (batcher, "_step"),
                          (pool, "generate_batch_stream")):
            obj.__dict__.pop(name, None)
    counts = launch_counts()
    agree = [next((j for j, (a, b) in enumerate(zip(x, y)) if a != b), min(len(x), len(y)))
             for x, y in zip(ids, refs["serve_ids"])]
    n_tok = sum(len(x) for x in ids)
    log(f"[{label}] 4 requests of {TP_SERVE_TOKENS} greedy ids (one with the PNG): "
        f"{n_tok / wall:.2f} tok/s aggregate over {wall:.2f} s (uploads and prefills "
        f"included); collectives {coll_s:.2f} s in {n_coll} all-reduces "
        f"({100 * coll_s / wall:.0f} % of the wall, every thread of rank 0); "
        f"{'steps' if server.get('continuous') else 'groups'} of "
        f"{dict(sorted(collections.Counter(lanes).items()))} lanes (must reach 2); ids agree "
        f"with tp=1's on the first {agree} of "
        f"{TP_SERVE_TOKENS} (must: {TP_PREFIX}); {ops} operations agreed across the ranks; "
        f"launches {counts}  [{card}]")
    if min(agree) < TP_PREFIX:
        raise AssertionError(f"{label}: ids {ids} agree with tp=1's {refs['serve_ids']} on "
                             f"{agree}")
    if max(lanes, default=0) < 2:
        raise AssertionError(f"{label}: the requests never decoded together: {lanes}")
    return dict(counts=counts, ids=ids, agree=agree, tok_s=n_tok / wall, wall_s=wall,
                collective_s=coll_s, collectives=n_coll, ops=ops, lanes=lanes)


def tp_spec(g, eng, label: str, card: str) -> dict:
    """n-gram speculation at k = SPEC_K on the rank's engine, on a text
    turn: greedy against plain greedy at tp=2 (equal, or leaving it only at
    a plain top-2 margin below SPEC_TIE_PREFILL of max|logit|), and a
    sampled stream from a seeded generator (the ranks compare it after)."""
    from minigpt4_tpu_torch.engine import SamplingParams

    greedy = SamplingParams(temp=0.0)
    q = "Tell me a story about a cat."

    def turn():
        eng.reset()
        eng.system_prompt()
        eng.begin_chat(q)
        return eng.n_past

    n0 = turn()
    list(eng.generate(limit=TP_SPEC_TOKENS, params=greedy))
    plain = eng._st.tokens[n0:]
    reset_launch_counts()
    t0 = time.perf_counter()
    n0 = turn()
    list(eng.generate(limit=TP_SPEC_TOKENS, params=greedy, speculative_k=SPEC_K))
    t_spec = time.perf_counter() - t0
    spec = eng._st.tokens[n0:]
    n0 = turn()
    eng._st.generator.manual_seed(SEED + 5)
    list(eng.generate(limit=TP_SPEC_TOKENS, params=SamplingParams(**SAMPLED),
                      speculative_k=SPEC_K))
    sampled = eng._st.tokens[n0:]
    counts = launch_counts()

    def margin_at(j):  # the plain path's pending logits after j of its ids
        turn()
        if j:
            eng.add_tokens(plain[:j])
        top = eng._st.logits.float().topk(2).values
        return float(top[0] - top[1]), float(eng._st.logits.float().abs().max())

    check = spec_ids_check(label, spec, plain, margin_at, SPEC_TIE_PREFILL, card)
    log(f"[{label}] k={SPEC_K}: greedy {len(spec)} ids in {t_spec:.2f} s, equal to plain tp=2 "
        f"greedy: {check['equal']}; sampled {sampled[:8]}...; launches {counts}  [{card}]")
    return dict(counts=counts, spec=spec, plain=plain, sampled=sampled, check=check)


def tp_slice(g, eng, model: str, llm: str, refs: dict, card: str) -> dict:
    """The second tp slice on this rank, on the phase's loaded engine: (a)
    the chat image through the ViT-G split over the ranks against tp=1's
    embedding, (b) TP_TRAIN_STEPS Adam steps of llama_proj over the sharded
    encoder and the sharded qtensor decoder, (c) a window and a continuous
    server over the ranks, (d) n-gram speculation."""
    from minigpt4_tpu_torch import debug
    from minigpt4_tpu_torch.formats import LlamaFileReader
    from minigpt4_tpu_torch.image import preprocess
    from minigpt4_tpu_torch.models import llama as llama_mod
    from minigpt4_tpu_torch.models import minigpt4 as vision_mod
    from minigpt4_tpu_torch.parallel import sharding, spmd

    label = f"tp={g.size} rank {g.rank}"
    out = {}
    # (a) the sharded encoder
    vshards = sharding.shard_vision_params(eng.vision_params, eng.vision_cfg, g)
    px = torch.from_numpy(preprocess(chat_image(), size=eng.vision_cfg.vit.image_size)[None])
    px = px.to(g.device)
    with torch.no_grad():
        ms = []
        for _ in range(2):  # the first builds nothing: plain torch, f32
            torch.cuda.synchronize(g.device)
            t0 = time.perf_counter()
            emb = vision_mod.encode_image(vshards, px, eng.vision_cfg, g)
            torch.cuda.synchronize(g.device)
            ms.append((time.perf_counter() - t0) * 1e3)
    emb = emb.cpu().numpy()
    gap = float(np.abs(emb - refs["emb"]).max() / np.abs(refs["emb"]).max())
    kinds = sharding.vit_placement(eng.vision_params["visual_encoder"], eng.vision_cfg.vit, g.size)
    log(f"[{label}] ViT-G split over {g.size} ranks ({kinds}): encode {ms[-1]:.1f} ms "
        f"(first {ms[0]:.1f} ms); embedding against tp=1's: max |d| / max |emb| {gap:.3e} "
        f"(tol {TP_ENCODE_TOL:g})  [{card}]")
    if not gap <= TP_ENCODE_TOL:
        path = Path(ROOT, "build", f"tp_dump_rank{g.rank}")
        debug.save_dump(debug.dump_vision_stages(vshards, px, eng.vision_cfg, g), f"{path}_tp.npz")
        debug.save_dump(debug.dump_vision_stages(eng.vision_params, px, eng.vision_cfg),
                        f"{path}_whole.npz")
        first = debug.first_divergence(debug.compare_dumps(f"{path}_tp.npz", f"{path}_whole.npz"))
        raise AssertionError(f"{label}: sharded embedding {gap} > {TP_ENCODE_TOL}; first "
                             f"divergence {first}")
    out["encode"] = dict(ms=ms, gap=gap, kinds=kinds)
    # (b) the sharded training step
    with LlamaFileReader(llm) as r:
        qt, qcfg = llama_mod.load_params(r, torch.float32, n_ctx=64, device=g.device,
                                         quant_mode="qtensor")
    qt = spmd.shard_llama_params(qt, g)
    train = tp_train(vshards, eng.vision_cfg, qt, qcfg, g, f"{label} train", card)
    wrong_grad = tp_grad_without_copy(vshards, eng.vision_cfg, qt, qcfg, g)
    del qt, vshards
    gc.collect()
    torch.cuda.empty_cache()
    one = refs["train"]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(train["losses"], one["losses"]))
    grad_gap = max(float(np.abs(train["grad"][k] - v).max() / np.abs(v).max())
                   for k, v in one["grad"].items())
    proj_max = max(float(np.abs(train["proj"][k] - v).max()) for k, v in one["proj"].items())
    proj_mean = (sum(float(np.abs(train["proj"][k] - v).sum()) for k, v in one["proj"].items())
                 / sum(v.size for v in one["proj"].values()))
    # the same reading between the first updates from tp=1's gradient and
    # from this rank's (sound) or the one without copy_to_tp (wrong)
    first_mean = adam_first_step_gap(train["grad"], one["grad"])
    wrong_mean = adam_first_step_gap(wrong_grad, one["grad"])
    wrong_gap = max(float(np.abs(wrong_grad[k] - v).max() / np.abs(v).max())
                    for k, v in one["grad"].items())
    log(f"[{label} train] against tp=1: losses {loss_gap:.3e} relative (tol "
        f"{TP_TRAIN_LOSS_RTOL:g}); the first step's gradient {grad_gap:.3e} of max|grad| (tol "
        f"{TP_TRAIN_GRAD_TOL:g}); llama_proj after {TP_TRAIN_STEPS} steps mean |d| "
        f"{proj_mean:.3e} (tol {TP_TRAIN_PROJ_TOL:g}), max |d| {proj_max:.3e}; the first "
        f"update's mean |d| {first_mean:.3e}, without copy_to_tp {wrong_mean:.3e} (its "
        f"gradient {wrong_gap:.3e} of max|grad|: the bound must refuse it)  [{card}]")
    if not (loss_gap <= TP_TRAIN_LOSS_RTOL and grad_gap <= TP_TRAIN_GRAD_TOL
            and proj_mean <= TP_TRAIN_PROJ_TOL):
        raise AssertionError(f"{label}: training step off tp=1's: {loss_gap}, {grad_gap}, "
                             f"{proj_mean}")
    if not (wrong_mean > TP_TRAIN_PROJ_TOL and wrong_gap > TP_TRAIN_GRAD_TOL):
        raise AssertionError(f"{label}: the bounds pass an update without copy_to_tp: "
                             f"{wrong_mean}, {wrong_gap}")
    out["train"] = dict(train, loss_gap=loss_gap, grad_gap=grad_gap, proj_max=proj_max,
                        proj_mean=proj_mean, first_mean=first_mean, wrong_mean=wrong_mean,
                        wrong_gap=wrong_gap)
    del out["train"]["proj"], out["train"]["grad"]
    # (c) serving over the ranks, then (d) speculation, on the same engine
    out["serve window"] = tp_serve(g, eng, model, llm, f"{label} window server",
                                   dict(batch_window_s=0.03), refs, card)
    out["serve continuous"] = tp_serve(g, eng, model, llm, f"{label} continuous server",
                                       dict(continuous=True, max_batch=8), refs, card)
    out["spec"] = tp_spec(g, eng, f"{label} speculative", card)
    return out


def _local_shapes(eng) -> dict:
    """The rank's local decoder shapes: (N, K) of each projection of layer 0
    and of the head, the KV cache's heads."""
    def nk(w):
        if isinstance(w, list):
            w = w[0]
        return (w.n_out, w.n_in) if hasattr(w, "n_in") else tuple(w.shape[-1:] + w.shape[-2:-1])

    out = {n: nk(v["w"]) for n, v in eng.llm_params["layers"].items() if isinstance(v, dict)}
    out["output"] = nk(eng.llm_params["output"]["w"])
    out["cache_heads"] = eng._st.cache["k"].shape[2]
    return out


def text_turn_logits(eng) -> np.ndarray:
    """The prefill logits of a fresh text turn: system prompt, one question."""
    eng.reset()
    eng.system_prompt()
    eng.begin_chat("What is in this picture?")
    return eng._st.logits.float().cpu().numpy()


def depth_logits(files: list, tp: int) -> list:
    """text_turn_logits of each (model, llm) pair of ``files`` through an
    engine of tp ranks (quant_mode="repack"), loaded and closed in turn."""
    from minigpt4_tpu_torch.engine import MiniGPT4Engine

    out = []
    for model, llm in files:
        eng = MiniGPT4Engine(model, llm, device=DEVICE, quant_mode="repack", tp=tp)
        try:
            out.append(text_turn_logits(eng))
        finally:
            eng.close()
            del eng
            gc.collect()
            torch.cuda.empty_cache()
    return out


def tp_rank(g, model: str, llm: str, shallow: list, refs: dict, card: str) -> dict:
    """One rank of the tp phase: text_turn_logits on the ``shallow`` files,
    the chat of phase 4 through MiniGPT4Engine(tp=2, quant_mode="repack") on
    this rank's shards (the repacked and flash kernels at the local shapes,
    no gq kernel) and its text turn, then sp_flash_decode_attention over the
    ranks at the 13B attention shape against the normalized kernel on the
    whole cache (the stats kernel's launches counted as the "sp" path)."""
    from minigpt4_tpu_torch.engine import MiniGPT4Engine
    from minigpt4_tpu_torch.engine.engine import disable_tf32
    from minigpt4_tpu_torch.ops import flash_decode as fd

    disable_tf32()
    label = f"tp={g.size} rank {g.rank}"
    log(f"[{label}] backend {g.backend}, device {g.device} ({torch.cuda.get_device_name(g.device)})")
    text = depth_logits(shallow, g.size)
    reset_launch_counts()
    mem0 = torch.cuda.memory_allocated(g.device)
    t0 = time.perf_counter()
    eng = MiniGPT4Engine(model, llm, device=DEVICE, quant_mode="repack", tp=g.size)
    torch.cuda.synchronize(g.device)
    t_load = time.perf_counter() - t0
    mem_gb = (torch.cuda.memory_allocated(g.device) - mem0) / 1e9
    torch.cuda.empty_cache()  # the whole decoder, freed after sharding, for the other rank
    try:
        shapes = _local_shapes(eng)
        log(f"[{label}] local shapes {shapes}; {mem_gb:.3f} GB allocated by the load")
        out = chat_on(eng, label, card)
        text.append(text_turn_logits(eng))
        out = check_launches(label, dict(out, load_s=t_load, mem_gb=mem_gb, shapes=shapes,
                                         text=text, backend=g.backend), TP_KERNELS,
                             GQ_KERNELS + PACKED_KERNELS, card)
        out["slice"] = tp_slice(g, eng, model, llm, refs, card)
    finally:
        eng.close()
    prof = out["profile"]
    log(f"[{label}] load {t_load:.2f} s, greedy {out['decode_tok_s']:.2f} tok/s, collectives "
        f"{prof['collective_ms']:.1f} of {prof['wall_ms']:.1f} ms of a profiled 16-token chunk "
        f"({100 * prof['collective_ms'] / prof['wall_ms']:.0f} %), backend {g.backend}  [{card}]")
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    gen = torch.Generator(device=g.device)
    gen.manual_seed(SEED + 7)  # the same cache and queries on every rank
    h, dh, c = 40, 128, 2048
    cl, scale = c // g.size, dh ** -0.5
    ck, cv = (torch.randn((1, 1, h, c, dh), generator=gen, device=g.device).to(torch.bfloat16)
              for _ in range(2))
    kl, vl = (t[:, :, :, g.rank * cl:(g.rank + 1) * cl].contiguous() for t in (ck, cv))
    reset_launch_counts()
    sp = []
    for s, pos in ((1, 700), (1, 2015), (8, 1500)):
        q = torch.randn((1, h, s, dh), generator=gen, device=g.device)
        got = fd.sp_flash_decode_attention(q, kl, vl, 0, pos, scale, g, g.rank * cl)
        want = fd.flash_decode_attention(q, ck, cv, 0, pos, scale)
        torch.cuda.synchronize(g.device)
        err = float((got - want).abs().max())
        sp.append(dict(shape=f"B=1 H={h} S={s} C={c} pos0={pos}", max_abs_err=err))
        log(f"[{label}] sp_flash_decode_attention S={s} pos0={pos} over {g.size} ranks of {cl} "
            f"positions: max abs err {err:.3e} against the kernel on the whole cache "
            f"(tol {SP_TOL:g})  [{card}]")
        if not err <= SP_TOL:
            raise AssertionError(f"{label}: SP attention pos0={pos} err {err} > {SP_TOL}")
    sp_counts = launch_counts()
    if sp_counts[STATS] <= 0:
        raise AssertionError(f"{label}: the stats kernel never launched on the SP path")
    return dict(out, sp=sp, sp_counts=sp_counts)


# ---------------------------------------------------------------------------
# phase 3': the dequant-matmul probes (minigpt4_tpu_torch/tools/)
# ---------------------------------------------------------------------------

# (tool module, entry arguments): each tool's main at the 13B shapes, M = 1
# and 8, the fewest timed launches (the default); the matvec tools with
# 16-byte loads (every width: the tools' defaults), the int4 probe without
# its SASS read-out (cuobjdump over the whole library takes ~20 s), the op
# chains at the probe's REPS
_M = ["--m", "1,8"]
# qmm_group_i8's gq, rq and w8a8 arms time gq_decode_generic, rq_decode and
# i8_decode at the 13B decode shapes, which phase 3 holds and times already
# (gq_decode beside this probe's same-run time): the probe arm alone here
PROBE_RUNS = (("qmm_group_i8", _M + ["--only", "gi8"]),
              ("qmm_variants", _M + ["--width", "16"]),
              ("unpack_variants", _M + ["--width", "16"]), ("qmm_v3", _M + ["--width", "16"]),
              ("qmm_v3", ["km"] + _M + ["--width", "16"]),
              ("qmm_v3", ["i8"] + _M + ["--width", "16"]), ("qmm_r3", _M + ["--width", "16"]),
              ("probe_int4", _M + ["--no-sass"]), ("probe_i8ops", ["--reps", "8"]))
# kernel -> (source, the TPU call site it stands for, every call site it
# replaces, (tool, case, M) of the representative case)
PROBE_KERNELS = {
    "probe_group_i8": ("minigpt4_tpu_torch/csrc/probe_group_i8.cu", "tools/qmm_group_i8.py:115",
                       ["tools/qmm_group_i8.py:115"], ("qmm_group_i8", "w13 gi8", 8)),
    "dequant_matvec": ("minigpt4_tpu_torch/csrc/probe_qmm.cuh", "tools/qmm_variants.py:48",
                       ["tools/qmm_variants.py:48", "tools/qmm_v3.py:93", "tools/qmm_v3.py:270",
                        "tools/qmm_v3.py:416", "tools/qmm_r3.py:89",
                        "tools/unpack_variants.py:82"], ("qmm_variants", "dense w16", 1)),
    "int_dot": ("minigpt4_tpu_torch/csrc/probe_int.cu", "tools/probe_int4.py:103",
                ["tools/probe_int4.py:103", "tools/qmm_variants.py:48 (i8dot)"],
                ("probe_int4", "s4xs4", 1)),
    "op_chain": ("minigpt4_tpu_torch/csrc/probe_ops.cu", "tools/probe_i8ops.py:50",
                 ["tools/probe_i8ops.py:50", "tools/qmm_v3.py:416 (opsi8, opsi32)"],
                 ("probe_i8ops", "i8aa reps=8", 0)),
}
# the kernels line's "state" of each probe kernel: a direct counterpart of
# the TPU probe, or redesigned for the H100 (PROBE_SASS checks those)
PROBE_STATE = {"probe_group_i8": "redesigned", "dequant_matvec": "redesigned",
               "int_dot": "redesigned", "op_chain": "redesigned"}


def probes_phase(card: str) -> dict:
    """Each probe tool's main() in this process (PROBE_RUNS); returns the
    path's launch counts and the tools' timed cases by kernel."""
    import contextlib
    import importlib

    out_dir = ROOT / "build" / "probes"
    out_dir.mkdir(parents=True, exist_ok=True)
    reset_launch_counts()
    t0 = time.perf_counter()
    records = []
    for name, entry in PROBE_RUNS:
        tool = importlib.import_module(f"minigpt4_tpu_torch.tools.{name}")
        t1 = time.perf_counter()
        label = "_".join([name] + entry[:1] if entry[:1] in (["km"], ["i8"]) else [name])
        with open(out_dir / f"{label}.jsonl", "w") as f, contextlib.redirect_stdout(f):
            recs = tool.main(entry)
        records += [dict(r, tool=name) for r in recs]
        log(f"[probes] {label}: {len(recs)} timed cases, checks passed, "
            f"{time.perf_counter() - t1:.1f} s  [{card}]")
    counts = launch_counts()
    by_kernel = {k: [r for r in records if r.get("kernel") == k] for k in PROBE_KERNELS}
    for kern, (_, _, _, (tool, case, m)) in PROBE_KERNELS.items():
        row = next(r for r in by_kernel[kern] if r["tool"] == tool and r["case"] == case
                   and r["m"] == m)
        log(f"[probes] {kern:15s} {case} M={m}: {row['ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}), plain {row['plain_ms']:.4f} ms, library "
            f"{row['library_ms'] if row['library_ms'] is None else round(row['library_ms'], 4)}, "
            f"launches on the path {counts[kern]}  [{card}]")
        if counts[kern] <= 0:
            raise AssertionError(f"probes: {kern} was never launched")
    log(f"[probes] phase took {time.perf_counter() - t0:.1f} s  [{card}]")
    gc.collect()
    torch.cuda.empty_cache()
    return {"counts": counts, "by_kernel": by_kernel}


def probe_kernel_entries(paths: dict, probe: dict) -> list:
    """The kernels line's entries of the four probe kernels."""
    entries = []
    for kern, (src, replaces, every, (tool, case, m)) in PROBE_KERNELS.items():
        rows = probe["by_kernel"][kern]
        row = next(r for r in rows if r["tool"] == tool and r["case"] == case and r["m"] == m)
        entries.append({
            "name": kern, "route": "cuda", "source": src, "replaces": replaces,
            "state": PROBE_STATE[kern],
            "replaces_all": every, "launches": paths["probes"]["counts"][kern],
            "launches_by_path": {label: p["counts"].get(kern, 0) for label, p in paths.items()},
            "max_abs_err": max(r["max_abs_err"] for r in rows if r.get("max_abs_err") is not None),
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": f"{tool} {case} M={m}",
            "cases": [{k: r.get(k) for k in ("tool", "case", "m", "ms", "plain_ms", "bound_ms",
                                             "library_ms")} for r in rows],
        })
    return entries


def tp_phase(card: str) -> dict:
    """MiniGPT4Engine(tp=2) on one card: two ranks (processes) on cuda:0 over
    gloo, each running the chat of phase 4 on its half of the 13B q5_k file
    (quant_mode="repack") behind the 13B f16 container, held to the same
    files at tp=1 in this process: the first TP_PREFIX greedy ids equal, and
    the text turn's logits at depths TP_DEPTHS and the file's (within
    TP_LOGIT_TOL at the first depth)."""
    from minigpt4_tpu_torch.parallel import dryrun

    # the ranks are other processes: memory this one's allocator still holds
    # from earlier phases would be out of their reach
    gc.collect()
    torch.cuda.empty_cache()
    shallow = [tuple(map(str, smoke_models(dict(LLM_13B_Q5K, n_layer=n)))) for n in TP_DEPTHS]
    text1 = depth_logits(shallow, 1)
    label = "13B q5_k repack tp=1"
    one, eng = chat(label, LLM_13B_Q5K, card, REPACK_CHAT_KERNELS, quant_mode="repack",
                    forbid=GQ_KERNELS + PACKED_KERNELS, keep=True, graphs=False)
    model, llm = smoke_models(LLM_13B_Q5K)
    try:
        text1.append(text_turn_logits(eng))
        refs = tp_refs(eng, str(llm), card)
    finally:
        eng.close()
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    log(f"[tp] this process holds {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
        f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved before the ranks start")
    t0 = time.perf_counter()
    ranks = dryrun.run_ranks(tp_rank, TP, (str(model), str(llm), shallow, refs, card),
                             device="cuda", timeout_s=900)
    wall = time.perf_counter() - t0

    def gap(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    depths = TP_DEPTHS + (LLM_13B_Q5K["n_layer"],)
    for r, out in enumerate(ranks):
        gaps = [gap(a, b) for a, b in zip(out["text"], text1)]
        ids, ref = out["greedy_ids"], one["greedy_ids"]
        agree = next((i for i, (a, b) in enumerate(zip(ids, ref)) if a != b), min(len(ids),
                                                                                    len(ref)))
        out.update(logit_gap_by_depth=dict(zip(depths, gaps)), ids_agree=agree,
                   logit_gap=gap(out["prefill_logits"], one["prefill_logits"]))
        log(f"[tp={TP} rank {r}] text-turn prefill logits against tp=1, max |d| / max |logit| "
            f"at depth " + ", ".join(f"{n}: {x:.3e}" for n, x in zip(depths, gaps))
            + f" (tol {TP_LOGIT_TOL:g} at depth {depths[0]}); image turn at depth {depths[-1]}: "
            f"{out['logit_gap']:.3e}; greedy ids agree with tp=1 on the first {agree} of "
            f"{len(ref)} (must: {TP_PREFIX}); {out['decode_tok_s']:.2f} tok/s against tp=1's "
            f"{one['decode_tok_s']:.2f}  [{card}]")
        if not gaps[0] <= TP_LOGIT_TOL:
            raise AssertionError(f"tp rank {r}: at depth {depths[0]} the prefill logits differ "
                                 f"from tp=1's by {gaps[0]} > {TP_LOGIT_TOL}")
        if agree < TP_PREFIX:
            raise AssertionError(f"tp rank {r}: greedy ids {ids} agree with tp=1's {ref} on "
                                 f"{agree} < {TP_PREFIX}")
    if ranks[0]["greedy_ids"] != ranks[1]["greedy_ids"]:
        raise AssertionError("the two ranks decoded different tokens")
    specs = [r["slice"]["spec"] for r in ranks]
    for key in ("spec", "sampled"):
        if specs[0][key] != specs[1][key]:
            raise AssertionError(f"speculation under tp: the ranks' {key} ids differ: "
                                 f"{specs[0][key]} / {specs[1][key]}")
    for what, need in (("serve window", ("paged_flash_decode", "rq_decode", "rq_prefill")),
                       ("serve continuous", ("paged_flash_decode", "rq_decode", "rq_prefill")),
                       ("spec", ("flash_decode", "rq_decode"))):
        for r, out in enumerate(ranks):
            missing = [k for k in need if out["slice"][what]["counts"][k] <= 0]
            if missing:
                raise AssertionError(f"tp rank {r} {what}: kernels never launched: {missing}")
    log(f"[tp] {TP} ranks done in {wall:.1f} s (spawn, loads, chat, SP)  [{card}]")
    return dict(tp1=one, ranks=ranks)


# ---------------------------------------------------------------------------
# phase 10: the clients (context shift, checkpoints, the C ABI)
# ---------------------------------------------------------------------------

# examples/main.c's engine (n_ctx 512, n_batch 64, seed 1337) and its knobs
CLIENT_CTX, CLIENT_BATCH, CLIENT_QUESTION = 512, 64, "what is this?"
# the 13B Q5_K_M geometry at full width cut to 8 layers for the script's time
# limit: the clients phase loads the model three times (this process,
# examples/main.c, ctypes), ~20 s each at full depth, and what it checks (the
# shift, the checkpoints, the C ABI's text) does not depend on depth; the
# repack chat (phase 6) and the w8a8 path (phase 7) run it too, which pays for
# the train phase
LLM_13B_L8 = dict(LLM_13B, n_layer=8)
CLIENT_KNOBS = (0.0, 40, 0.9, 1.0, 1.0, 64, 1.1, 1.0, 1.0, 0, 5.0, 1.0, 1)
SHIFT_TOKENS = 400  # greedy ids past the 512-position context
# the eager run: from a checkpoint AB_BEFORE decode chunks before the first
# shift, through that shift's chunk and two more
AB_BEFORE = 2
RESTORE_TOKENS = 32
CAPI_TOKENS = 32
CAPI_KERNELS = ("gq_decode", "gq_prefill", "flash_decode")


def _client_params():
    from minigpt4_tpu_torch.engine import SamplingParams

    names = ("temp", "top_k", "top_p", "tfs_z", "typical_p", "repeat_last_n", "repeat_penalty",
             "alpha_presence", "alpha_frequency", "mirostat", "mirostat_tau", "mirostat_eta",
             "penalize_nl")
    return SamplingParams(**dict(zip(names, CLIENT_KNOBS), penalize_nl=True))


def _decode_ids(eng, n: int, clock: dict | None = None, on_chunk=None) -> tuple[list, list]:
    """``n`` greedy ids through ``eng.generate`` (a new "Go on." turn where an
    answer ends first), recorded chunk by chunk: (ids, (clock time, ids so
    far) after each chunk).  The clock is perf_counter less
    ``clock["paused"]``, the seconds the checks' own host work took;
    ``on_chunk(ids)`` runs after each chunk."""
    from minigpt4_tpu_torch.engine import SamplingParams

    clock = {"paused": 0.0} if clock is None else clock
    ids, marks = [], []
    chunk = eng.decode_chunk

    def recorded(k, params, st=None):
        out = chunk(k, params, st)
        ids.extend(out)
        torch.cuda.synchronize()
        marks.append((time.perf_counter() - clock["paused"], len(ids)))
        if on_chunk is not None:
            on_chunk(ids)
        return out

    eng.decode_chunk = recorded
    try:
        while len(ids) < n:
            if eng._st.logits is None:
                eng.begin_chat("Go on.")
            for _ in eng.generate(limit=n - len(ids), params=SamplingParams(temp=0.0)):
                pass
            if eng._st.logits is not None and len(ids) < n:
                eng.begin_chat("Go on.")  # the answer ended: a new turn
    finally:
        del eng.decode_chunk
    return ids, marks


def _cache_to_host(st) -> dict:
    return {kv: t.cpu() for kv, t in st.cache.items()}


def clients_shift(eng, ckpt: Path, card: str) -> dict:
    """Phase 10 a and b on a 13B engine of n_ctx 512 with context_shift:
    the image turn, saved; SHIFT_TOKENS greedy ids captured (every shift
    timed; the first one's cache held to shift_kv_cache on a CPU copy, a
    checkpoint saved AB_BEFORE chunks before it), then AB_BEFORE + 3 chunks
    of ids run eagerly from that checkpoint (ids bit-equal, shifts at the same places);
    then RESTORE_TOKENS ids after restore_state, twice with a reset_chat
    between, from captured replays."""
    from minigpt4_tpu_torch.engine.engine import DECODE_CHUNK
    from minigpt4_tpu_torch.image import preprocess
    from minigpt4_tpu_torch.models import llama as llama_mod

    ab_tokens = (AB_BEFORE + 3) * DECODE_CHUNK
    st = eng._st
    pixels = preprocess(chat_image(), size=eng.vision_cfg.vit.image_size)
    emb = eng.encode_image(pixels)
    eng.system_prompt()
    eng.begin_chat_image(emb, "What is in this picture?")
    n0, keep0 = eng.n_past, st.n_keep
    t0 = time.perf_counter()
    eng.save_state(ckpt)
    save_s = time.perf_counter() - t0
    size_mb = ckpt.stat().st_size / 1e6
    pre_ckpt = ckpt.with_name("clients-pre-shift.npz")
    ptr = st.cache["k"].data_ptr()
    shift = eng.ctx_shift
    clock = {"paused": 0.0}
    events: list = []
    held: dict = {}
    pre: dict = {}

    def paused(fn):
        t = time.perf_counter()
        out = fn()
        clock["paused"] += time.perf_counter() - t
        return out

    def timed(s=None, need=0):
        s = eng._state(s)
        keep, n_past = min(s.n_keep, s.n_past), s.n_past
        if not held:
            held["before"] = paused(lambda: _cache_to_host(s))
        torch.cuda.synchronize()
        t = time.perf_counter()
        drop = shift(s, need)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        if "after" not in held:
            held.update(after=paused(lambda: _cache_to_host(s)), keep=keep, drop=drop,
                        n_past=n_past)
        events.append(dict(keep=keep, drop=drop, n_past=n_past, ms=ms,
                           at=time.perf_counter() - clock["paused"]))
        return drop

    def checkpoint(ids):
        # the first chunk boundary at most AB_BEFORE chunks before a shift
        if not pre and not events and st.n_past + (AB_BEFORE + 1) * DECODE_CHUNK > st.n_ctx:
            paused(lambda: eng.save_state(pre_ckpt))
            pre["at"] = len(ids)

    eng.ctx_shift = timed
    try:
        cap_ids, cap_marks = _decode_ids(eng, SHIFT_TOKENS, clock, checkpoint)
        cap_shifts = [dict(e) for e in events]
        if not pre or not any(e["drop"] for e in cap_shifts):
            raise AssertionError("clients: no context shift (or no checkpoint before it) in the "
                                 "captured run")
        eng.graphs_enabled = False
        eng.restore_state(pre_ckpt)
        events.clear()
        clock["paused"] = 0.0
        eag_ids, eag_marks = uncounted(lambda: _decode_ids(eng, ab_tokens, clock))
        eag_shifts = [dict(e) for e in events]
    finally:
        del eng.ctx_shift
        eng.graphs_enabled = True
        pre_ckpt.unlink(missing_ok=True)
    want = llama_mod.shift_kv_cache(held["before"], held["keep"], held["drop"], held["n_past"],
                                    eng.llm_cfg)
    cache_equal = all(torch.equal(llama_mod._bits(held["after"][kv]), llama_mod._bits(want[kv]))
                      for kv in ("k", "v"))
    first = cap_shifts[0]
    # tok/s over the chunks before the first shift and from it (the shift included)
    before = [(t, n) for t, n in cap_marks if t < first["at"]]
    after = [(t, n) for t, n in cap_marks if t > first["at"]]

    def rate(marks):
        if len(marks) < 2:
            return None
        return (marks[-1][1] - marks[0][1]) / (marks[-1][0] - marks[0][0])

    around = dict(before_tok_s=rate(before[-5:]), after_tok_s=rate(after[:5]))
    key = [(e["drop"], e["n_past"]) for e in eag_shifts]
    out = dict(prompt=n0, n_keep=keep0, ab_from=pre["at"],
               equal=eag_ids == cap_ids[pre["at"]:pre["at"] + ab_tokens],
               same_shifts=bool(key) and key == [(e["drop"], e["n_past"])
                                                 for e in cap_shifts[:len(key)]],
               shifts=[{k: e[k] for k in ("keep", "drop", "n_past", "ms")} for e in cap_shifts],
               eager_shift_ms=[e["ms"] for e in eag_shifts],
               cache=dict(equal=cache_equal, keep=held["keep"], drop=held["drop"],
                          n_past=held["n_past"]),
               ptr_kept=st.cache["k"].data_ptr() == ptr, save_s=save_s, file_mb=size_mb,
               captured_tok_s=rate(cap_marks[1:]), eager_tok_s=rate(eag_marks[1:]), **around)
    log(f"[clients shift] prompt {n0} positions (keep {keep0}); {SHIFT_TOKENS} greedy ids "
        f"captured, shifts (keep, drop, n_past, ms) "
        + ", ".join(f"({e['keep']}, {e['drop']}, {e['n_past']}, {e['ms']:.2f})"
                    for e in cap_shifts)
        + f"; {ab_tokens} ids eager from the checkpoint after id {pre['at']}, shift ms "
        f"{[round(m, 2) for m in out['eager_shift_ms']]}; captured = eager ids {out['equal']}, "
        f"same shifts {out['same_shifts']}; tok/s captured {out['captured_tok_s']:.2f} (before "
        f"the first shift {around['before_tok_s']}, from it {around['after_tok_s']}), eager "
        f"{out['eager_tok_s']:.2f}  [{card}]")
    log(f"[clients shift] the first shift's cache bit-equal (K and V) to shift_kv_cache on a CPU "
        f"copy: {cache_equal}; k data_ptr kept {out['ptr_kept']}  [{card}]")
    if not (out["equal"] and out["same_shifts"] and out["ptr_kept"] and cache_equal):
        raise AssertionError(f"clients: context shift check failed: {out}")

    # b. restore, decode, reset, restore, decode: equal ids from captured replays
    restore = {"ids": [], "replays": [], "restore_s": []}
    for _ in range(2):
        eng.reset_chat()
        t0 = time.perf_counter()
        eng.restore_state(ckpt)
        torch.cuda.synchronize()
        restore["restore_s"].append(time.perf_counter() - t0)
        r0 = eng.graph_stats()["replays"]
        restore["ids"].append(_decode_ids(eng, RESTORE_TOKENS)[0])
        restore["replays"].append(eng.graph_stats()["replays"] - r0)
    ok = (restore["ids"][0] == restore["ids"][1] == cap_ids[:RESTORE_TOKENS]
          and min(restore["replays"]) > 0)
    log(f"[clients restore] save {save_s:.3f} s, {size_mb:.1f} MB file; restore "
        f"{[round(s, 3) for s in restore['restore_s']]} s; {RESTORE_TOKENS} greedy ids after each "
        f"restore equal (and equal to the shift run's first) {ok}, graph replays "
        f"{restore['replays']}  [{card}]")
    if not ok:
        raise AssertionError(f"clients: restore then replay differs: {restore}")
    return dict(out, restore=restore)


def _c_text(tokens: list[str]) -> str:
    """What examples/main.c prints of ``tokens``: each as a C string (up to a
    NUL), the EOS token skipped, up to the end-of-answer suffix."""
    from minigpt4_tpu_torch.engine import MiniGPT4Engine

    chat, out = "", ""
    for token in tokens:
        token = token.split("\0")[0]
        chat += token
        if MiniGPT4Engine.contains_eos_token(token):
            continue
        if MiniGPT4Engine.is_eos(chat):
            break
        out += token
    return out


def clients_capi(model: Path, llm: Path, want: list[str], size: int, n_floats: int,
                 card: str) -> dict:
    """Phase 10 c: examples/main.c, unchanged, compiled against
    libminigpt4_torch.so and run as a process on the same files with no
    MINIGPT4_TPU_DEVICE (the card); then the same library through ctypes in
    this process, its launches counted.  Both must stream ``want``'s text
    (the engine's tokens for a zero image of ``size`` pixels, whose
    embedding has ``n_floats`` values)."""
    import ctypes

    from minigpt4_tpu_torch.c_api import _build

    t0 = time.perf_counter()
    exe = _build.compile_client(ROOT / "examples" / "main.c", _build.BUILD_DIR / "main_c")
    build_s = time.perf_counter() - t0
    env = _build.client_env()
    env.pop("MINIGPT4_TPU_DEVICE", None)
    t0 = time.perf_counter()
    proc = subprocess.run([str(exe), str(model), str(llm), str(size), str(CAPI_TOKENS)], env=env,
                          capture_output=True, timeout=600)
    main_s = time.perf_counter() - t0
    text = _c_text(want)
    expect = f"encoded image -> {n_floats} floats\n{text}\n[done]\n"
    got = proc.stdout.decode("utf-8", "replace")
    main_ok = proc.returncode == 0 and got == expect
    log(f"[clients C ABI] libminigpt4_torch.so + examples/main.c built in {build_s:.1f} s; "
        f"main_c ran {main_s:.1f} s (rc {proc.returncode}), its stream equals the in-process "
        f"engine's greedy text: {main_ok} ({text[:40]!r})  [{card}]")
    if not main_ok:
        raise AssertionError(f"clients: examples/main.c printed {got[-400:]!r}, want "
                             f"{expect[-400:]!r}; stderr {proc.stderr.decode()[-3000:]}")

    lib = ctypes.CDLL(str(_build.build()))

    class CImage(ctypes.Structure):
        _fields_ = [("data", ctypes.c_void_p), ("width", ctypes.c_int),
                    ("height", ctypes.c_int), ("channels", ctypes.c_int),
                    ("format", ctypes.c_int)]

    class CEmbedding(ctypes.Structure):
        _fields_ = [("data", ctypes.POINTER(ctypes.c_float)), ("elements", ctypes.c_size_t)]

    p, i, f, s = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_char_p
    lib.minigpt4_model_load.restype = p
    lib.minigpt4_model_load.argtypes = [s, s, i, i, i, i, ctypes.c_bool]
    lib.minigpt4_encode_image.argtypes = [p, ctypes.POINTER(CImage), ctypes.POINTER(CEmbedding),
                                          ctypes.c_size_t]
    lib.minigpt4_system_prompt.argtypes = [p, ctypes.c_size_t]
    lib.minigpt4_begin_chat_image.argtypes = [p, ctypes.POINTER(CEmbedding), s, ctypes.c_size_t]
    lib.minigpt4_end_chat_image.argtypes = [p, ctypes.POINTER(s), ctypes.c_size_t, f,
                                            ctypes.c_int32, f, f, f, ctypes.c_int32, f, f, f, i,
                                            f, f, i]
    lib.minigpt4_free_embedding.argtypes = [ctypes.POINTER(CEmbedding)]
    lib.minigpt4_free.argtypes = [p]
    t0 = time.perf_counter()
    ctx = lib.minigpt4_model_load(str(model).encode(), str(llm).encode(), 1, 1337, CLIENT_CTX,
                                  CLIENT_BATCH, False)
    load_s = time.perf_counter() - t0
    if not ctx:
        raise AssertionError("clients: minigpt4_model_load failed through ctypes")
    try:
        reset_launch_counts()  # the C-ABI chat's own launches
        pixels = np.zeros((3, size, size), np.float32)
        img = CImage(pixels.ctypes.data_as(ctypes.c_void_p), size, size, 3, 1)
        emb = CEmbedding()
        rcs = [lib.minigpt4_encode_image(ctx, ctypes.byref(img), ctypes.byref(emb), 0),
               lib.minigpt4_system_prompt(ctx, 0)]
        t0 = time.perf_counter()
        rcs.append(lib.minigpt4_begin_chat_image(ctx, ctypes.byref(emb),
                                                 CLIENT_QUESTION.encode(), 0))
        prefill_ms = (time.perf_counter() - t0) * 1e3
        token, tokens, stamps = ctypes.c_char_p(), [], []
        for _ in range(CAPI_TOKENS):
            rcs.append(lib.minigpt4_end_chat_image(ctx, ctypes.byref(token), 0, *CLIENT_KNOBS))
            tokens.append(token.value.decode("utf-8"))
            stamps.append(time.perf_counter())
        counts = launch_counts()
        lib.minigpt4_free_embedding(ctypes.byref(emb))
    finally:
        lib.minigpt4_free(ctx)
    # per-token rate from the 8th token on (the single-step graph captures on its second use)
    tok_s = (len(stamps) - 8) / (stamps[-1] - stamps[7])
    same = _c_text(tokens) == text
    log(f"[clients C ABI] ctypes in this process: load {load_s:.1f} s, image turn prefill "
        f"{prefill_ms:.1f} ms, {CAPI_TOKENS} end_chat_image calls at {tok_s:.2f} tok/s (from the "
        f"8th), rcs all 0 {not any(rcs)}, text equal {same}; launches {counts}  [{card}]")
    missing = [k for k in CAPI_KERNELS if counts[k] <= 0]
    if any(rcs) or not same or missing:
        raise AssertionError(f"clients: the ctypes chat failed: rcs {rcs}, text equal {same}, "
                             f"kernels never launched {missing}")
    return dict(counts=counts, main_s=main_s, build_s=build_s, load_s=load_s,
                prefill_ms=prefill_ms, tok_s=tok_s, text=text)


def clients_phase(card: str) -> dict:
    """Phase 10: the 13B Q5_K_M geometry at 8 layers through a
    context-shifting engine (n_ctx 512, n_batch 64, graphs on): the shift
    and restore checks, then
    examples/main.c's greedy text in this process as the C ABI's yardstick;
    the engine closes before the C ABI runs."""
    from minigpt4_tpu_torch.engine import MiniGPT4Engine

    model, llm = smoke_models(LLM_13B_L8)
    ckpt = ROOT / "build" / "smoke_models" / "clients-chat.npz"
    ckpt.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    eng = MiniGPT4Engine(model, llm, device=DEVICE, n_ctx=CLIENT_CTX, n_batch=CLIENT_BATCH,
                         context_shift=True)
    load_s = time.perf_counter() - t0
    try:
        reset_launch_counts()
        out = clients_shift(eng, ckpt, card)
        out["counts"] = launch_counts()
        eng.reset_chat()
        size = eng.vision_cfg.vit.image_size
        emb = eng.encode_image(np.zeros((3, size, size), np.float32))
        eng.system_prompt()
        eng.begin_chat_image(emb, CLIENT_QUESTION)
        params = _client_params()
        want = uncounted(lambda: [eng.end_chat(params) for _ in range(CAPI_TOKENS)])
    finally:
        eng.close()
        del eng
        ckpt.unlink(missing_ok=True)
        gc.collect()
        torch.cuda.empty_cache()
    log(f"[clients] engine load {load_s:.1f} s; launches during the shift and restore runs: "
        f"{out['counts']}")
    return dict(shift=out, counts=out["counts"], load_s=load_s,
                capi=clients_capi(model, llm, want, size, emb.size, card))


def _preprocess(img: np.ndarray, pool) -> np.ndarray:
    from minigpt4_tpu_torch.image import preprocess

    return preprocess(img, size=pool.engine.vision_cfg.vit.image_size)


# ---------------------------------------------------------------------------
# phase 4''': train (inside phase 4, on the 13B chat's files and engine)
# ---------------------------------------------------------------------------

TRAIN_T = 24  # caption tokens: 32 queries + 24 = 56 decoder rows, past the flash span
TRAIN_STEPS = 5
TRAIN_LR = 1e-2
TRAIN_GRAD_DEPTH = 2  # layers of the Function-vs-plain-autograd gradient check
TRAIN_GRAD_TOL = 1e-5  # of max|grad|
DISTILL_B, DISTILL_T = 4, 128
DISTILL_STEPS = 30
DISTILL_WARM = 8
DISTILL_LR = 3e-3
DISTILL_TOKENS = 16


def _first_layers(params: dict, n: int) -> dict:
    """Decoder ``params`` cut to their first ``n`` layers: stacked tensors
    and QTensors sliced, per-layer lists (the K_M file's wv, w2) cut."""
    from minigpt4_tpu_torch.ops.quant_matmul import QTensor

    def cut(w):
        if isinstance(w, dict):
            return {k: cut(v) for k, v in w.items()}
        if isinstance(w, QTensor):
            return QTensor(w.packed[:n], w.dtype, w.n_in)
        return w[:n]

    return dict(params, layers=cut(params["layers"]))


def _plain_qmatmul(x, qt, layer=None):
    """qmatmul through plain autograd (which saves the dequantized weight):
    the yardstick of the autograd Function's gradients."""
    if qt.stacked:
        qt = qt.layer(layer)
    return x @ qt.dequantize(x.dtype).t()


def train_projection(eng, card: str) -> dict:
    """(a) Stage-1 projection training at Vicuna-13B width and depth: the 13B
    Q5_K_M file loaded again as qtensor (packed bytes: the trainer refuses
    the engine's gq), the chat engine's f16-container vision params frozen,
    its llama_proj copied into f32 leaves.  B = 2 images at 224, captions of
    TRAIN_T random ids.  First the projection's gradient of one step on the
    first TRAIN_GRAD_DEPTH layers, the qtensor Function's against plain
    autograd's (within TRAIN_GRAD_TOL of max|grad|); then TRAIN_STEPS
    torch.optim.Adam steps through make_train_step on one fixed batch at
    full depth: forward and backward seconds apart (caption_loss timed
    inside the step), the loss per step (must fall by 2 %, the projection
    must move) and the peak device memory.  No kernel may launch in the
    steps (launch counts set to 0 just before, read just after)."""
    from minigpt4_tpu_torch.formats import LlamaFileReader
    from minigpt4_tpu_torch.image import preprocess
    from minigpt4_tpu_torch.models import llama as llama_mod
    from minigpt4_tpu_torch.ops import quant_matmul as qm
    from minigpt4_tpu_torch.train import make_train_step, projection

    _, llm = smoke_models(LLM_13B)
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with LlamaFileReader(llm) as r:
        lp, lcfg = llama_mod.load_params(r, torch.float32, n_ctx=512, device=DEVICE,
                                         quant_mode="qtensor")
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    load_gb = (torch.cuda.memory_allocated() - mem0) / 1e9
    vcfg = eng.vision_cfg
    frozen = {"vision": {k: v for k, v in eng.vision_params.items() if k != "llama_proj"},
              "llm": lp}
    proj0 = {k: v.detach().clone() for k, v in eng.vision_params["llama_proj"].items()}
    rng = np.random.default_rng(SEED + 7)
    size = vcfg.vit.image_size
    imgs = (chat_image(), rng.integers(0, 256, (480, 640, 3), dtype=np.uint8))
    pixels = torch.from_numpy(np.stack([preprocess(im, size=size) for im in imgs])).to(DEVICE)
    tokens = torch.from_numpy(rng.integers(1, lcfg.n_vocab, (2, TRAIN_T))).to(DEVICE)
    mask = torch.ones((2, TRAIN_T), device=DEVICE)

    def proj_grad(frozen_, cfg_):
        proj = {k: v.clone().requires_grad_() for k, v in proj0.items()}
        loss = projection.caption_loss(proj, frozen_, pixels, tokens, mask, vcfg, cfg_)
        return torch.autograd.grad(loss, list(proj.values()))

    shallow = (dict(frozen, llm=_first_layers(lp, TRAIN_GRAD_DEPTH)),
               dataclasses.replace(lcfg, n_layer=TRAIN_GRAD_DEPTH))
    g_fn = proj_grad(*shallow)
    qmatmul = qm.qmatmul
    qm.qmatmul = _plain_qmatmul
    try:
        g_plain = proj_grad(*shallow)
    finally:
        qm.qmatmul = qmatmul
    grad_err = max(float((a - b).abs().max()) / float(b.abs().max())
                   for a, b in zip(g_fn, g_plain))
    log(f"[train a] 13B qtensor decoder loaded in {t_load:.2f} s ({load_gb:.3f} GB); the "
        f"projection's first gradient at {TRAIN_GRAD_DEPTH} layers, the qtensor Function "
        f"against plain autograd: max |d| / max|grad| {grad_err:.3e} (tol {TRAIN_GRAD_TOL:g})"
        f"  [{card}]")
    if not grad_err <= TRAIN_GRAD_TOL:
        raise AssertionError(f"train a: Function gradient {grad_err:.3e} from plain autograd's")
    del g_fn, g_plain, shallow

    proj = {k: v.clone().requires_grad_() for k, v in proj0.items()}
    step = make_train_step(vcfg, lcfg, torch.optim.Adam(list(proj.values()), lr=TRAIN_LR))
    forward_s: list = []
    caption_loss = projection.caption_loss

    def timed_loss(*a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = caption_loss(*a)
        torch.cuda.synchronize()
        forward_s.append(time.perf_counter() - t)
        return out

    losses, step_s = [], []
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_launch_counts()
    projection.caption_loss = timed_loss
    try:
        for _ in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            proj, loss = step(proj, frozen, pixels, tokens, mask)
            losses.append(float(loss))
            step_s.append(time.perf_counter() - t)
    finally:
        projection.caption_loss = caption_loss
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    backward_s = [s - f for s, f in zip(step_s, forward_s)]
    moved = float((proj["w"].detach() - proj0["w"]).abs().max())
    launched = {k: n for k, n in counts.items() if n}
    log(f"[train a] {TRAIN_STEPS} Adam({TRAIN_LR:g}) steps at Vicuna-13B width and depth "
        f"(qtensor decoder, f32, B = 2, S = {vcfg.qformer.query_length} + {TRAIN_T}): losses "
        f"{[round(x, 5) for x in losses]}; s/step {[round(x, 3) for x in step_s]} (forward "
        f"{[round(x, 3) for x in forward_s]}, backward + update "
        f"{[round(x, 3) for x in backward_s]}); peak allocated {peak / 1e9:.2f} GB, "
        f"{(peak - base) / 1e9:.2f} GB above the {base / 1e9:.2f} GB held before the steps; "
        f"max |d proj| {moved:.3e}; launches {launched}  [{card}]")
    if launched:
        raise AssertionError(f"train a: kernels launched in the training steps: {launched}")
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0] * 0.98
            and moved > 0):
        raise AssertionError(f"train a: losses {losses} did not fall by 2 % (proj moved {moved})")
    return dict(counts=counts, losses=losses, step_s=step_s, forward_s=forward_s,
                backward_s=backward_s, peak_gb=peak / 1e9, step_gb=(peak - base) / 1e9,
                load_s=t_load, load_gb=load_gb, grad_err=grad_err)


def distill(eng, card: str) -> dict:
    """(b) The draft head's distillation with the loaded 13B Q5_K_M gq engine
    as the teacher: teacher_targets on DISTILL_B random rows of DISTILL_T
    ids (gq_prefill and gq_prefill_generic must launch; row 0's ids those of
    a B = 1 forward of all logits, up to top-2 ties within
    SPEC_TIE_PREFILL), then DISTILL_STEPS AdamW steps of a
    DraftHeadConfig(512, 2, 8, 1408) head over the engine's embedding (the
    loss must fall; no kernel may launch), saved, and a drafted greedy
    stream of DISTILL_TOKENS ids with it as the engine's draft head: plain
    greedy's ids, its tokens per pass."""
    from minigpt4_tpu_torch.models import llama as llama_mod
    from minigpt4_tpu_torch.train import draft as draft_mod

    params, cfg = eng.llm_params, eng.llm_cfg
    rng = np.random.default_rng(SEED + 8)
    toks = torch.from_numpy(rng.integers(3, cfg.n_vocab, (DISTILL_B, DISTILL_T))).to(DEVICE)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    targets = draft_mod.teacher_targets(params, cfg, toks)
    torch.cuda.synchronize()
    t_targets = time.perf_counter() - t0
    t_counts = launch_counts()
    missing = [k for k in ("gq_prefill", "gq_prefill_generic") if t_counts[k] <= 0]
    if missing:
        raise AssertionError(f"train b: teacher_targets never launched {missing}: {t_counts}")

    def row0():
        c1 = dataclasses.replace(cfg, n_ctx=DISTILL_T)
        with torch.no_grad():
            return llama_mod.forward(params, llama_mod.init_cache(c1, 1, torch.bfloat16, DEVICE),
                                     llama_mod.embed_tokens(params, toks[:1]), 0, c1,
                                     all_logits=True)[0]

    l1 = uncounted(row0)
    ties = []
    for j in (l1.argmax(dim=-1).int() != targets[0]).nonzero().flatten().tolist():
        gap, top = _margin(l1[j])
        ties.append((j, gap / top))
        if not gap <= SPEC_TIE_PREFILL * top:
            raise AssertionError(f"train b: teacher target {j} of row 0 differs from a B = 1 "
                                 f"forward's argmax at a margin of {gap / top:.3e}")
    log(f"[train b] teacher_targets B = {DISTILL_B}, T = {DISTILL_T} on the 13B gq engine: "
        f"{t_targets * 1e3:.1f} ms; launches {({k: n for k, n in t_counts.items() if n})}; row "
        f"0 equal to a B = 1 forward's argmax but at {len(ties)} ties {ties}  [{card}]")

    dhc = draft_mod.DraftHeadConfig(512, 2, 8, 1408)
    dcfg = dhc.llama_cfg(cfg.n_vocab, DISTILL_T)
    art = draft_mod.init_draft_head(torch.Generator(device=DEVICE).manual_seed(SEED + 9),
                                    cfg.n_embd, dhc)
    leaves = [t.requires_grad_() for t in draft_mod.art_leaves(art)]
    step = draft_mod.make_distill_step(
        dcfg, torch.optim.AdamW(leaves, lr=DISTILL_LR, weight_decay=1e-4))
    emb = params["tok_embeddings"].float()
    losses, accs = [], []
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DISTILL_STEPS):
        art, loss, acc = step(art, emb, toks, targets, DISTILL_WARM)
        losses.append(float(loss))
        accs.append(float(acc))
    t_distill = time.perf_counter() - t0
    d_counts = launch_counts()
    launched = {k: n for k, n in d_counts.items() if n}
    log(f"[train b] {DISTILL_STEPS} AdamW({DISTILL_LR:g}, weight decay 1e-4) steps of a {dhc} "
        f"head: {t_distill:.2f} s; loss {losses[0]:.4f} -> {losses[-1]:.4f}, agreement "
        f"{accs[0]:.4f} -> {accs[-1]:.4f}; launches {launched}  [{card}]")
    if launched or not losses[-1] < losses[0]:
        raise AssertionError(f"train b: losses {losses}, launches {launched}")
    head = ROOT / "build" / "smoke_models" / f"draft-head-distilled-d{cfg.n_embd}-seed{SEED}.npz"
    draft_mod.save_artifact(head, art, dhc, teacher_mode=f"real:{eng._llm_file.path.name}"
                            f"@{eng.quant_mode}")
    del art, leaves, step, emb
    with SpecStreams(eng) as ss:
        plain = ss.run(0, limit=DISTILL_TOKENS)
        head_out = drafted(eng, ss, "g 13B", f"the distilled {dhc} head",
                           {"draft_head_path": head}, plain["ids"], DISTILL_TOKENS,
                           plain["tok_s"], card)
    return {"teacher": dict(counts=t_counts, ms=t_targets * 1e3, ties=ties),
            "distill": dict(counts=d_counts, s=t_distill, losses=losses, agreement=accs),
            "drafted": head_out}


def train_phase(eng, card: str) -> dict:
    """The train phase on the loaded 13B Q5_K_M engine: (b) distill with it
    as the teacher, then (a) train_projection beside it; every sub-path's
    launch counts, keyed as paths of the kernels line."""
    t0 = time.perf_counter()
    b = distill(eng, card)
    gc.collect()
    torch.cuda.empty_cache()
    a = train_projection(eng, card)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[train] phase {time.perf_counter() - t0:.1f} s  [{card}]")
    return {"train projection 13B qtensor": a, "train teacher targets 13B gq": b["teacher"],
            "train distill draft head": b["distill"],
            "speculative 13B distilled head": b["drafted"]}


# ---------------------------------------------------------------------------
# phase 11: the benchmark's synthetic models and the kernel gate
# ---------------------------------------------------------------------------

SYNTH_LABEL = "synthetic 13B gq teacher"
SYNTH_DISTILL_LABEL = "synthetic 13B distill"
SYNTH_PREFILL = 64
SYNTH_STEPS = 32
SYNTH_STREAM = 512
SYNTH_VMAX = 320  # the draft tool's word-id range
SYNTH_DISTILL = ["--steps", "40", "--teacher-batches", "4", "--batch", "8", "--seq", "128"]
# the entries of the kernels line the gate holds (a gq entry per packing)
GATE_ENTRIES = GQ_KERNELS + ("rq_decode", "rq_prefill", "i8_decode", "i8_prefill") + PACKED_KERNELS


def kernel_gate(card: str) -> dict:
    """(a) minigpt4_tpu_torch.kernel_gate: run_gate (every matmul entry at
    every 7B / 13B weight shape, quant type, packing, M = 1, 8, 9, 512,
    stacked and flat, against the f64 product of the dequantized weight)
    and run_tp_gate (the K shards of 13B w2 and wo at tp = 2 and 4), outside
    the launch counts; one line per case in build/kernel_gate.log, each
    entry's cases and worst error in the log.  Any failed case fails."""
    from minigpt4_tpu_torch import kernel_gate as kg

    log_path = ROOT / "build" / "kernel_gate.log"
    report = []
    t0 = time.perf_counter()
    with open(log_path, "w") as f:
        ok = uncounted(lambda: kg.run_gate(report=report, out=f))
        ok = uncounted(lambda: kg.run_tp_gate(report=report, out=f)) and ok
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    gate = kg.summary(report)
    for entry, st in sorted(gate.items()):
        log(f"[gate] {entry:24s} {st['cases']:4d} cases, {st['failed']} failed, max rel err "
            f"{st['max_rel_err']:.3e}  [{card}]")
    log(f"[gate] {len(report)} cases (the full sweep and tp) in "
        f"{seconds:.1f} s; each case in {log_path.relative_to(ROOT)}  [{card}]")
    failed = [r["tag"] for r in report if not r["ok"]]
    if not ok or failed:
        raise AssertionError(f"kernel gate: {len(failed)} failed cases, e.g. {failed[:5]}")
    missing = [k for k in GATE_ENTRIES if k not in gate]
    if missing:
        raise AssertionError(f"kernel gate: no case for {missing}")
    return {"entries": gate, "cases": len(report), "s": seconds}


def _word_stream(n: int, n_vocab: int) -> np.ndarray:
    """n word ids (benchmark.word_tokenize over the evaluation and the draft
    tool's training prose, in the tool's range: SYNTH_VMAX or the vocabulary)."""
    from minigpt4_tpu_torch import benchmark as B
    from minigpt4_tpu_torch.tools import train_draft

    text = B.REALISTIC_TEXT + train_draft.TRAIN_TEXT_A + train_draft.TRAIN_TEXT_B
    return (B.word_tokenize(text) % min(SYNTH_VMAX, n_vocab))[:n]


def synthetic_models(card: str) -> dict:
    """(b) benchmark.synth_llama_params at Vicuna-13B, full width and depth,
    in gq mode with bench_pack_policy's packing, from default_rng(0), built
    on the card: build seconds and the bytes it holds; a SYNTH_PREFILL-token
    word-id prompt and SYNTH_STEPS greedy steps through models/llama.forward
    (the counts set to 0 just before, read just after: the gq entries of
    its packing and flash decode must launch), and n-gram drafting's
    tokens per pass at k = 8 walked over those greedy ids (printed); over one SYNTH_STREAM-token
    teacher-forced word-id stream, the distinct argmax targets and the modal
    share (printed, not gated: only non-finite logits or a single target, a
    collapsed teacher, fail).  (c) tools/train_draft.run on that teacher
    (SYNTH_DISTILL): teacher-target ms, distill seconds, tokens per pass at
    k = 8 on REALISTIC_TEXT; the artifact's tag is synth_teacher_tag's."""
    from minigpt4_tpu_torch import benchmark as B
    from minigpt4_tpu_torch.formats import DataType
    from minigpt4_tpu_torch.models import llama as llama_mod
    from minigpt4_tpu_torch.tools import train_draft
    from minigpt4_tpu_torch.train import draft as draft_mod

    cfg = B.GEOMETRIES["13B"]
    pack = B.bench_pack_policy(cfg)
    tag = B.synth_teacher_tag("gq", pack)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = B.synth_llama_params(cfg, DataType.Q5_K, np.random.default_rng(0), quant_mode="gq",
                                  device=DEVICE, pack=pack)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    held = torch.cuda.memory_allocated() - mem0
    log(f"[synthetic] {SYNTH_LABEL} ({tag}, {cfg.n_layer} layers, width {cfg.n_embd}) built on "
        f"the card in {build_s:.2f} s, {held / 1e9:.3f} GB  [{card}]")

    ccfg = dataclasses.replace(cfg, n_ctx=SYNTH_STREAM)
    prompt = torch.from_numpy(_word_stream(SYNTH_PREFILL, cfg.n_vocab)).long().to(DEVICE)[None]
    reset_launch_counts()
    with torch.no_grad():
        cache = llama_mod.init_cache(ccfg, 1, torch.bfloat16, DEVICE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = llama_mod.forward(params, cache, llama_mod.embed_tokens(params, prompt), 0, ccfg)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        finite = bool(torch.isfinite(logits).all())
        ids = []
        t0 = time.perf_counter()
        for i in range(SYNTH_STEPS):
            tok = logits.argmax(dim=-1)
            ids.append(tok)
            logits = llama_mod.forward(params, cache, llama_mod.embed_tokens(params, tok[:, None]),
                                       SYNTH_PREFILL + i, ccfg)
            finite = finite and bool(torch.isfinite(logits).all())
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
    counts = launch_counts()
    ids = torch.cat(ids).tolist()
    del cache
    # n-gram drafting at k = 8 walked over the prompt and the teacher's own
    # greedy continuation (benchmark.spec_acceptance_on_stream)
    ngram = B.spec_acceptance_on_stream(np.concatenate([prompt[0].cpu().numpy(), ids]),
                                        k_spec=8, warm=SYNTH_PREFILL)
    log(f"[synthetic] {SYNTH_PREFILL}-token prefill {prefill_ms:.1f} ms, {SYNTH_STEPS} greedy "
        f"steps eager {SYNTH_STEPS / decode_s:.2f} tok/s, {len(set(ids))} distinct ids, n-gram "
        f"acceptance on them {ngram:.2f} tokens per pass at k = 8, finite {finite}; launches "
        f"{({k: v for k, v in counts.items() if v})}  [{card}]")
    if not finite:
        raise AssertionError(f"{SYNTH_LABEL}: non-finite logits")
    want = (("gq_decode[p5]", "gq_prefill[p5]") if pack else ("gq_decode", "gq_prefill")) + (
        "flash_decode",)
    missing = [k for k in want if counts[k] <= 0]
    if missing:
        raise AssertionError(f"{SYNTH_LABEL}: kernels never launched: {missing}")

    stream = torch.from_numpy(_word_stream(SYNTH_STREAM, cfg.n_vocab)).long().to(DEVICE)[None]
    with torch.no_grad():
        cache = llama_mod.init_cache(ccfg, 1, torch.bfloat16, DEVICE)
        all_logits = llama_mod.forward(params, cache, llama_mod.embed_tokens(params, stream), 0,
                                       ccfg, all_logits=True)
    stream_finite = bool(torch.isfinite(all_logits).all())
    targets = all_logits[0].argmax(dim=-1).cpu().numpy()
    del cache, all_logits
    cur = stream[0].cpu().numpy()
    distinct = int(len(np.unique(targets)))
    modal = float(np.bincount(targets).max() / len(targets))
    per_token = [np.bincount(targets[cur == t]).max() / (cur == t).sum() for t in np.unique(cur)]
    weights = [(cur == t).sum() for t in np.unique(cur)]
    modal_per_token = float(np.average(per_token, weights=weights))
    log(f"[synthetic] {SYNTH_STREAM}-token teacher-forced word stream: {distinct} distinct argmax "
        f"targets, modal share {modal:.3f}, modal share per current token {modal_per_token:.3f}, "
        f"finite {stream_finite}  [{card}]")
    if not stream_finite or distinct <= 1:
        raise AssertionError(f"{SYNTH_LABEL}: collapsed or non-finite teacher "
                             f"({distinct} distinct targets, finite {stream_finite})")

    args = train_draft.parse_args(SYNTH_DISTILL + [
        "--model", "13B", "--device", DEVICE, "--out", str(B.DRAFT_ARTIFACT)])
    reset_launch_counts()
    res = train_draft.run(params, cfg, B.word_tokenize, args, tag)
    distill_counts = launch_counts()
    tools = teacher_tools(params, cfg, pack, card)
    del params
    if draft_mod.artifact_teacher_mode(args.out) != tag:
        raise AssertionError(f"{SYNTH_DISTILL_LABEL}: artifact tag is not {tag}")
    target_ms = res["teacher_s"] / args.teacher_batches * 1e3
    log(f"[synthetic] {SYNTH_DISTILL_LABEL}: teacher targets {target_ms:.1f} ms per batch of "
        f"{args.batch} x {args.seq}, {args.steps} steps in {res['distill_s']:.2f} s (loss "
        f"{res['losses'][0]:.3f} -> {res['losses'][-1]:.3f}), EVAL agreement "
        f"{res['agreement']:.3f}, {res['tokens_per_pass']:.2f} tokens per pass at k = 8 "
        f"({res['teacher_distinct']} distinct teacher targets on the eval stream)  [{card}]")
    gc.collect()
    torch.cuda.empty_cache()
    return {"teacher": {"counts": counts, "build_s": build_s, "gb": held / 1e9,
                        "distinct": distinct, "modal": modal, "ngram_tokens_per_pass": ngram},
            "distill": {"counts": distill_counts, **res}, "tools": tools}


def synthetic_phase(card: str) -> dict:
    """Phase 11: (a) the kernel gate, (b) the synthetic 13B teacher, (c) its
    distillation."""
    t0 = time.perf_counter()
    out = {"gate": kernel_gate(card), **synthetic_models(card)}
    log(f"[synthetic] phase took {time.perf_counter() - t0:.1f} s  [{card}]")
    return out


# ---------------------------------------------------------------------------
# the repo-level tools (minigpt4_tpu_torch/tools/): a step in three phases
# ---------------------------------------------------------------------------

TOOLS_TEACHER = "tools 13B gq teacher: prefill split + locality"
TOOLS_W8A8 = "tools 13B L8 w8a8: paged capacity + spec cost"
TOOLS_COLDSTART = "tools coldstart 13B Q5_K_M (subprocess)"
# the prefill split's chains of 2 and 6 calls, the least of 2 (the tool's
# defaults are JAX's 4, 12 and 3): six arms of a 13B 512-row prefill
TOOLS_PREFILL_ARGS = ["--chains", "2,6", "--reps", "2"]
TOOLS_W8A8_KERNELS = ("i8_decode", "i8_prefill", "paged_flash_decode", "flash_decode")
COLDSTART_KEYS = ("build_s", "encode_ms", "ttft_ms", "decode_tok_s", "n_decode")
COLDSTART_KERNELS = ("gq_decode", "gq_decode_generic", "gq_prefill", "flash_decode")
COLDSTART_TIMEOUT_S = 300


def _tool(label: str, fn, card: str):
    """``fn()`` with its stdout (the tool's JSON lines) logged as ``[tools
    label] ...`` lines; returns fn's result."""
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            return fn()
    finally:
        for line in buf.getvalue().splitlines():
            log(f"[tools {label}] {line}")


def _finite_positive(d: dict, keys) -> list[str]:
    return [f"{k} = {d.get(k)}" for k in keys
            if not (isinstance(d.get(k), (int, float)) and math.isfinite(d[k]) and d[k] > 0)]


def teacher_tools(params: dict, cfg, pack: bool, card: str) -> dict:
    """Phase 11's tools step on the synthetic 13B gq teacher (full width and
    depth): profile_prefill_engine.run (each token tile of the prefill
    kernel x attn_len None / 512, chains TOOLS_PREFILL_ARGS, each arm a
    captured graph) and probe_teacher_locality.run (windows 1-16 over
    about 115 lanes, an e4m3 cache).  The counts are set to 0 before and
    read after (path TOOLS_TEACHER): the gq prefill entry of the teacher's
    packing and flash decode must launch.  Fails on a time that is not
    finite and positive, an arm not replayed from its graph, an agreement
    outside [0, 1]."""
    from minigpt4_tpu_torch.ops import qmm_prefill
    from minigpt4_tpu_torch.tools import probe_teacher_locality, profile_prefill_engine

    t0 = time.perf_counter()
    reset_launch_counts()
    pargs = profile_prefill_engine.parse_args(TOOLS_PREFILL_ARGS + ["--device", DEVICE])
    arms = _tool("profile_prefill_engine",
                 lambda: profile_prefill_engine.run(params, cfg, pargs), card)
    largs = probe_teacher_locality.parse_args(["--model", "13B", "--device", DEVICE])
    loc = _tool("probe_teacher_locality",
                lambda: probe_teacher_locality.run(params, cfg, largs), card)
    torch.cuda.synchronize()
    counts = launch_counts()
    s = time.perf_counter() - t0
    problems = [f"arm {a['tn']}/{a['attn_len']}: {p}" for a in arms
                for p in _finite_positive(a, ("prefill512_ms", "prefill_tok_s"))]
    problems += [f"arm {a['tn']}/{a['attn_len']} not captured" for a in arms if not a["captured"]]
    if len(arms) != 2 * len(qmm_prefill.TOKEN_TILES):
        problems.append(f"{len(arms)} prefill arms")
    problems += [f"locality {k} = {v}" for k, v in loc.items()
                 if k.startswith("w") and not 0.0 <= v <= 1.0]
    want = ("gq_prefill[p5]" if pack else "gq_prefill", "flash_decode")
    problems += [f"{k} never launched" for k in want if counts[k] <= 0]
    best = min(arms, key=lambda a: a["prefill512_ms"])
    log(f"[tools] {TOOLS_TEACHER}: fastest arm token tile {best['tn']}, attn_len "
        f"{best['attn_len']}: {best['prefill512_ms']:.2f} ms a 512-row prefill; agreement "
        + ", ".join(f"{k} {v:.3f}" for k, v in loc.items() if k.startswith("w"))
        + f"; launches {({k: v for k, v in counts.items() if v})}; {s:.1f} s  [{card}]")
    if problems:
        raise AssertionError(f"{TOOLS_TEACHER}: " + "; ".join(problems))
    return {"counts": counts, "prefill": arms, "locality": loc, "s": s}


def w8a8_tools(eng, card: str) -> dict:
    """The w8a8 phase's tools step on its engine's decoder (13B width, 8
    layers, smooth-quant scales folded, before the chat): probe_paged_capacity.run
    at 8, 12 and 16 lanes (e4m3 pools, the group chunks captured), then its
    speculative arm at 8 lanes (k = 8, captured verify passes over
    page-crossing spans), then probe_paged_spec_cost.run (arms A-E; C, D and
    E captured, each also eager).  The
    counts are set to 0 before and read after (path TOOLS_W8A8): the i8
    kernels and both flash kernels must launch, no gq kernel may.  Fails on
    an error line, a missing arm or a number that is not finite and
    positive."""
    from minigpt4_tpu_torch.tools import probe_paged_capacity, probe_paged_spec_cost

    params, cfg = eng.llm_params, eng.llm_cfg
    t0 = time.perf_counter()
    reset_launch_counts()
    cap_args = probe_paged_capacity.parse_args(["--lanes", "8,12,16", "--device", DEVICE])
    lines = _tool("probe_paged_capacity", lambda: probe_paged_capacity.run(params, cfg, cap_args),
                  card)
    spec_args = probe_paged_capacity.parse_args(["--lanes", "8", "--spec-k", "8",
                                                 "--device", DEVICE])
    spec = _tool("probe_paged_capacity --spec-k 8",
                 lambda: probe_paged_capacity.run(params, cfg, spec_args), card)
    cost_args = probe_paged_spec_cost.parse_args(["--device", DEVICE])
    cost = _tool("probe_paged_spec_cost", lambda: probe_paged_spec_cost.run(params, cfg, cost_args),
                 card)
    torch.cuda.synchronize()
    counts = launch_counts()
    s = time.perf_counter() - t0
    problems = [f"lanes {ln['lanes']}: {ln['error']}" for ln in lines + spec if "error" in ln]
    problems += [f"lanes {ln['lanes']}: {p}" for ln in lines if "error" not in ln
                 for p in _finite_positive(ln, ("pool_mb", "dense_reservation_mb",
                                                "aggregate_tok_s", "per_lane_tok_s"))]
    problems += [f"spec lanes {ln['lanes']}: {p}" for ln in spec if "error" not in ln
                 for p in _finite_positive(ln, ("plain_step_ms", "spec_pass_ms",
                                                "accept_per_pass"))]
    problems += [f"{ln['lanes']} lanes not captured" for ln in lines
                 if "error" not in ln and not ln["captured"]]
    problems += [f"spec cost: {p}" for p in _finite_positive(
        cost, ("dense_plain_ms", "dense_spec_ms", "dense_spec8_ms", "paged_plain_ms",
               "paged_plain_eager_ms", "paged_spec_cross_ms", "paged_spec_aligned_ms",
               "paged_spec_cross_eager_ms", "paged_spec_aligned_eager_ms"))]
    problems += [f"spec cost arm {a} not captured" for a in
                 ("paged_plain", "paged_spec_cross", "paged_spec_aligned")
                 if a not in cost.get("captured", [])]
    problems += [f"spec lanes {ln['lanes']} verify passes not captured" for ln in spec
                 if "error" not in ln and not ln["captured"]]
    problems += [f"{k} never launched" for k in TOOLS_W8A8_KERNELS if counts[k] <= 0]
    problems += [f"{k} launched" for k in GQ_KERNELS + PACKED_KERNELS if counts[k]]
    log(f"[tools] {TOOLS_W8A8}: "
        + "; ".join(f"{ln['lanes']} lanes {ln.get('aggregate_tok_s', 0):.2f} tok/s aggregate, "
                    f"pool {ln.get('pool_mb', 0):.1f} MB (dense {ln.get('dense_reservation_mb', 0):.1f})"
                    for ln in lines)
        + f"; launches {({k: v for k, v in counts.items() if v})}; {s:.1f} s  [{card}]")
    if "paged_spec_cross_ms" in cost:
        log(f"[graphs tools] a paged verify pass (8 lanes, k = 8, 2 passes a dispatch): "
            f"captured {cost['paged_spec_cross_ms']:.2f} ms crossing a page edge, "
            f"{cost.get('paged_spec_aligned_ms', float('nan')):.2f} ms aligned; eager "
            f"{cost.get('paged_spec_cross_eager_ms', float('nan')):.2f} / "
            f"{cost.get('paged_spec_aligned_eager_ms', float('nan')):.2f} ms; the paged plain "
            f"chunk captured {cost.get('paged_plain_ms', float('nan')):.2f} ms a token, eager "
            f"{cost.get('paged_plain_eager_ms', float('nan')):.2f}  [{card}]")
    if problems:
        raise AssertionError(f"{TOOLS_W8A8}: " + "; ".join(problems))
    return {"counts": counts, "capacity": lines, "spec": spec, "spec_cost": cost, "s": s}


def coldstart_tools(model: Path, llm: Path, chat_out: dict, card: str) -> dict:
    """python -m minigpt4_tpu_torch.tools.coldstart_probe over the 13B
    Q5_K_M pair the chats wrote (full depth, f16 container; --n-decode 32,
    --image-size 224) as a process of its own, with the kernel library
    built (the "warm" start: build/kernels/ holds it).  Fails unless it
    exits 0 with JAX's keys, every number finite and positive, and its
    launch line shows COLDSTART_KERNELS launched (path TOOLS_COLDSTART).
    Its TTFT pieces are printed beside the in-process chat's."""
    cmd = [sys.executable, "-m", "minigpt4_tpu_torch.tools.coldstart_probe", "-m", str(model),
           "-l", str(llm), "--n-decode", "32", "--image-size", "224", "--device", DEVICE]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=COLDSTART_TIMEOUT_S)
    wall = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        log(f"[tools coldstart_probe] {line}")
    if proc.returncode != 0:
        raise AssertionError(f"{TOOLS_COLDSTART}: exit {proc.returncode}: {proc.stderr[-3000:]}")
    lines = proc.stdout.strip().splitlines()
    launch = [ln for ln in lines if ln.startswith("[launches] ")]
    res = json.loads(lines[-1])
    counts = json.loads(launch[-1][len("[launches] "):]) if launch else {}
    problems = [f"keys {sorted(res)}"] if set(res) != set(COLDSTART_KEYS) | {"device"} else []
    problems += _finite_positive(res, COLDSTART_KEYS)
    problems += [f"{k} never launched" for k in COLDSTART_KERNELS if counts.get(k, 0) <= 0]
    log(f"[tools] {TOOLS_COLDSTART}: build {res.get('build_s', 0):.2f} s (the chat's load "
        f"{chat_out['load_s']:.2f} s), encode {res.get('encode_ms', 0):.1f} ms (chat "
        f"{chat_out['encode_ms']:.1f}), ttft {res.get('ttft_ms', 0):.1f} ms: image turn + first "
        f"token, first use eager (the warmed chat's system prompt + image turn "
        f"{chat_out['prefill_ms']:.1f} ms), strict per-token decode "
        f"{res.get('decode_tok_s', 0):.2f} tok/s (the chat's generate "
        f"{chat_out['decode_tok_s']:.2f}); process wall {wall:.1f} s  [{card}]")
    if problems:
        raise AssertionError(f"{TOOLS_COLDSTART}: " + "; ".join(problems))
    return {"counts": counts, **res, "wall_s": wall}


# ---------------------------------------------------------------------------
# phase 12: the benchmark's timing half and the kernel floors
# ---------------------------------------------------------------------------

BENCH_LABEL = "bench"
BENCH_SERVING = "13B_L8"  # the serving riders: Vicuna-13B width, depth cut to 8
BENCH_N = 64  # decode steps and prefill rows, bench.py's headline arm
# the headline decode must reach this share of the captured 13B gq chat's
# tok/s of phase 4 (below it the benchmark would be timing an eager path:
# 26.98 eager against 76.00 captured, PERF.md section 5)
BENCH_CHAT_SHARE = 0.7
BENCH_SERVING_KERNELS = ("i8_decode", "i8_prefill", "flash_decode", "paged_flash_decode")


def _bench_rates(res: dict) -> dict:
    return {k: v for k, v in res.items()
            if ("tok_s" in k or k.endswith(("_ms", "imgs_s", "gb_s"))) and not isinstance(v, str)}


def bench_problems(name: str, res: dict) -> list[str]:
    """What fails a benchmark result: a section's error, a section skipped
    (no deadline is set here), a rate that is not finite and positive."""
    out = [f"{name}: {k} = {res[k]}" for k in res if k.endswith("_error")]
    if res.get("skipped_sections"):
        out.append(f"{name}: sections skipped with no deadline: {res['skipped_sections']}")
    out += [f"{name}: {k} = {v}" for k, v in _bench_rates(res).items()
            if not (math.isfinite(v) and v > 0)]
    return out


def bench_phase(card: str, chat_tok_s: float | None = None) -> dict:
    """Phase 12, in this process: (a) benchmark.chip_state_probe; (b)
    bench_decode("13B", Q5_K, 64, 64, quant_mode="gq", sections="single") at
    full width and depth (its draft_head rider reads the head phase 11
    distilled into benchmark.DRAFT_ARTIFACT); (c) bench_decode over the
    serving riders at 13B width and 8 layers (GEOMETRIES["13B_L8"],
    registered here) with quant_mode="w8a8", an e4m3 cache and 8 lanes; (d)
    bench_encode(5120); (e) kernel_gate.run_floors("check") against the
    committed minigpt4_tpu_torch/kernel_floors.json, outside the counts.
    The counts are set to 0 before (b) and read after (d): path "bench".
    Each result is one "[bench ...]" JSON line.  Fails on a section error,
    a skipped section, a rate not finite and positive, a probe reading
    above PROBE_MAX_SHARE x 3.35 TB/s (chip_state_probe raises), a floor
    under its margin, a kernel of
    (b) or (c) never launched, a missing draft_head rider where the
    artifact exists, and a headline decode_tok_s below BENCH_CHAT_SHARE x
    ``chat_tok_s`` (the captured 13B gq chat of phase 4; not checked with
    --only-bench, which has no phase 4)."""
    from minigpt4_tpu_torch import benchmark as B
    from minigpt4_tpu_torch import kernel_gate as kg
    from minigpt4_tpu_torch.formats import DataType

    t_phase = time.perf_counter()
    B.GEOMETRIES[BENCH_SERVING] = dataclasses.replace(B.GEOMETRIES["13B"], n_layer=8)
    res: dict = {}
    t0 = time.perf_counter()
    gbs = B.chip_state_probe()
    res["chip_state"] = {"chip_state_gb_s": gbs, "s": time.perf_counter() - t0, "device": card}
    artifact = B.DRAFT_ARTIFACT.exists()
    pack = B.bench_pack_policy(B.GEOMETRIES["13B"])
    reset_launch_counts()
    t0 = time.perf_counter()
    res["13B gq single"] = B.bench_decode("13B", DataType.Q5_K, BENCH_N, BENCH_N,
                                          quant_mode="gq", sections="single")
    res["13B gq single"]["s"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res["13B L8 w8a8 serving"] = B.bench_decode(
        BENCH_SERVING, DataType.Q5_K, BENCH_N, BENCH_N, cache_dtype=torch.float8_e4m3fn,
        quant_mode="w8a8", batch=8, sections="serving")
    res["13B L8 w8a8 serving"]["s"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res["encode"] = B.bench_encode(5120)
    res["encode"]["s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = launch_counts()
    gc.collect()
    torch.cuda.empty_cache()
    floors: list = []
    t0 = time.perf_counter()
    floors_ok = uncounted(lambda: kg.run_floors("check", report=floors))
    res["floors"] = {"ok": floors_ok, "s": time.perf_counter() - t0, "device": card,
                     "shapes": floors}
    for name, r in res.items():
        log(f"[bench {name}] {json.dumps(r)}")

    problems = [p for name, r in res.items() if name not in ("floors", "chip_state")
                for p in bench_problems(name, r)]
    if not (math.isfinite(gbs) and gbs > 0):  # (above the card's rate it raised)
        problems.append(f"chip_state_probe {gbs} GB/s")
    recorded = (json.loads(kg.FLOORS_PATH.read_text()).get("ratios", {})
                if kg.FLOORS_PATH.exists() else {})
    if not floors_ok or set(recorded) != set(kg.FLOOR_SHAPES):
        problems.append(f"kernel floors: ok {floors_ok}, recorded {sorted(recorded)}")
    single = res["13B gq single"]
    if artifact and "draft_head_pass_ms" not in single:
        problems.append(f"13B gq single: no draft_head rider although {B.DRAFT_ARTIFACT} exists")
    if not artifact:
        log(f"[bench] the draft-head artifact is absent ({B.DRAFT_ARTIFACT.relative_to(ROOT)}): "
            f"no draft_head_* metrics, as the JAX package reports it  [{card}]")
    if chat_tok_s is not None and single["decode_tok_s"] < BENCH_CHAT_SHARE * chat_tok_s:
        problems.append(f"13B gq single: decode_tok_s {single['decode_tok_s']:.2f} below "
                        f"{BENCH_CHAT_SHARE} x the captured chat's {chat_tok_s:.2f}")
    want = (("gq_decode[p5]", "gq_prefill[p5]") if pack else ("gq_decode", "gq_prefill")
            ) + BENCH_SERVING_KERNELS
    missing = [k for k in want if counts[k] <= 0]
    if missing:
        problems.append(f"kernels never launched in the benchmark: {missing}")
    chat = "not run (--only-bench)" if chat_tok_s is None else f"{chat_tok_s:.2f}"
    log(f"[bench] 13B gq decode {single['decode_tok_s']:.2f} tok/s (the captured chat's "
        f"{chat}), chip state {gbs:.1f} GB/s, floors {[round(f['ratio'], 3) for f in floors]}; "
        f"launches {({k: v for k, v in counts.items() if v})}; phase "
        f"{time.perf_counter() - t_phase:.1f} s  [{card}]")
    if problems:
        raise AssertionError("benchmark: " + "; ".join(problems))
    return {"counts": counts, "results": res}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    card = card_line()
    log(card)
    log(f"[device] torch {torch.__version__} CUDA {torch.version.cuda} "
        f"python {sys.version.split()[0]} devices {torch.cuda.device_count()}")
    from minigpt4_tpu_torch.engine.engine import disable_tf32
    from minigpt4_tpu_torch.ops import _build

    disable_tf32()
    t0 = time.perf_counter()
    _build.load()
    log(f"[build] kernels ready in {time.perf_counter() - t0:.1f} s (nvcc "
        f"{'not run: sources unchanged' if _build.build_seconds is None else f'{_build.build_seconds:.1f} s'})")
    kernel = ""
    for line in (_build.BUILD_DIR / "nvcc.log").read_text().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            unit = next((u for u in ("gq_decode", "gq_prefill", "rq_matmul",
                                     "flash_decode", "i8_matmul") if f"{u}_cu" in name), "")
            at = max(name.find(t) for t in ("qmm_", "flash_", "i8_decode", "i8_prefill",
                                            "gq_decode_i8", "rq_decode", "probe_group_i8",
                                            "int_dot", "op_chain"))
            kernel = f"{unit}: {name[at:][:80]}"
        elif "spill" in line or ("Used" in line and "registers" in line):
            log(f"[build] {kernel}: {line.split(':', 1)[-1].strip()}")

    sass = check_wgmma_sass(card)
    sass.update(check_decode_sass(card))
    sass.update(check_probe_sass(card))
    if "--only-clients" in sys.argv:  # a quick look at phase 10 alone: no result line
        phase("clients")
        clients_phase(card)
        phase("end (--only-clients)")
        return 0
    if "--only-speculative" in sys.argv:  # a quick look at the speculative paths: no result line
        phase("speculative")
        only_speculative(card)
        phase("end (--only-speculative)")
        return 0
    if "--only-train" in sys.argv:  # a quick look at the train phase alone: no result line
        from minigpt4_tpu_torch.engine import MiniGPT4Engine

        phase("train")
        eng = MiniGPT4Engine(*smoke_models(LLM_13B), device=DEVICE)
        try:
            train_phase(eng, card)
        finally:
            eng.close()
        phase("end (--only-train)")
        return 0
    if "--only-synthetic" in sys.argv:  # a quick look at phase 11 alone: no result line
        phase("synthetic models")
        synthetic_phase(card)
        phase("end (--only-synthetic)")
        return 0
    if "--only-bench" in sys.argv:  # a quick look at phase 12 alone: no result line
        phase("bench")
        bench_phase(card)
        phase("end (--only-bench)")
        return 0
    if "--only-tp" in sys.argv:  # a quick look at the tp phase alone: no result line
        phase("tp")
        tp_phase(card)
        phase("end (--only-tp)")
        return 0
    if "--only-serving" in sys.argv:  # a quick look at phase 5 alone: no result line
        phase("serving")
        continuous_serving(card, serving(card, lg=LLM_13B_L8))
        phase("end (--only-serving)")
        return 0
    if "--only-kernels" in sys.argv:  # a quick look at phase 3 alone: no result line
        sections = sys.argv[sys.argv.index("--only-kernels") + 1:]
        phase_kernels(card, set(sections[0].split(",")) if sections else None)
        phase("end (--only-kernels)")
        return 0
    phase("kernels")
    kernel_results = phase_kernels(card)
    phase("probes")
    paths = {}
    probe = probes_phase(card)
    paths["probes"] = {"counts": probe["counts"]}
    phase("synthetic models")
    synth = synthetic_phase(card)
    paths[SYNTH_LABEL] = synth["teacher"]
    paths[SYNTH_DISTILL_LABEL] = synth["distill"]
    paths[TOOLS_TEACHER] = synth["tools"]
    # the tp ranks are processes of their own: they run while this one holds
    # little device memory
    phase("tp")
    tp = tp_phase(card)
    paths["13B q5_k repack tp=1"] = tp["tp1"]
    for r, out in enumerate(tp["ranks"]):
        paths[f"13B q5_k repack tp={TP} rank {r}"] = out
    paths["sp"] = {"counts": tp["ranks"][0]["sp_counts"]}
    for r, out in enumerate(tp["ranks"]):
        for what in ("serve window", "serve continuous", "spec"):
            paths[f"13B q5_k repack tp={TP} rank {r} {what}"] = out["slice"][what]
    phase("13B chats, unpacked and packed")
    # the same files with the gq codes packed: the same greedy tokens; both
    # engines stay loaded for a decode A/B in alternating turns
    label = "13B Q5_K_M gq packed"
    engines = {}
    try:
        paths["13B Q5_K_M"], engines["unpacked"] = chat(
            "13B Q5_K_M", LLM_13B, card, CHAT_KERNELS, forbid=PACKED_KERNELS, keep=True)
        paths[label], engines["packed"] = chat(label, LLM_13B, card, PACKED_13B_KERNELS,
                                               quant_mode="gq", forbid=GQ_KERNELS, keep=True)
        same = paths[label]["greedy_ids"] == paths["13B Q5_K_M"]["greedy_ids"]
        log(f"[engine {label}] greedy ids equal to the unpacked chat's: {same}; allocated by "
            f"the load {paths[label]['mem_gb']:.3f} GB packed, "
            f"{paths['13B Q5_K_M']['mem_gb']:.3f} GB unpacked "
            f"({paths['13B Q5_K_M']['mem_gb'] - paths[label]['mem_gb']:.3f} GB less)  [{card}]")
        if not same:
            raise AssertionError(f"{label}: greedy ids {paths[label]['greedy_ids']} differ from "
                                 f"the unpacked chat's {paths['13B Q5_K_M']['greedy_ids']}")
        ab = decode_ab(engines, card)
        phase("speculative")
        spec = speculative(engines["unpacked"], card)
        phase("train")
        train = train_phase(engines["unpacked"], card)
    finally:
        for e in engines.values():
            e.close()
        engines.clear()
        e = None
        gc.collect()
        torch.cuda.empty_cache()
    paths[label]["decode_ab"] = ab
    for name, what in (("a", "n-gram"), ("b", "sampled n-gram"), ("c", "draft 7B"),
                       ("d", "draft head")):
        paths[f"speculative 13B {what}"] = spec[name]
    paths.update(train)
    phase("tools: cold start")
    paths[TOOLS_COLDSTART] = coldstart_tools(*smoke_models(LLM_13B), paths["13B Q5_K_M"], card)
    phase("7B chats")
    # (graphs captured lazily; no warmup and no eager A/B, to keep the time)
    paths["7B q5_k L8"], eng = chat("7B q5_k L8", LLM_7B, card,
                                    ("gq_decode", "gq_prefill", "flash_decode"),
                                    forbid=PACKED_KERNELS, graphs=False, keep=True)
    try:
        phase("speculative: accepted drafts")
        paths["speculative 7B self-drafted"] = spec_accepted(eng, smoke_models(LLM_7B)[1], card)
    finally:
        eng.close()
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    paths["7B q4 mix L8 gq packed"] = chat("7B q4 mix L8 gq packed", LLM_7B_MIX, card,
                                           PACKED_MIX_KERNELS, quant_mode="gq", forbid=GQ_KERNELS,
                                           graphs=False)
    phase("serving")
    # the window server on the 13B Q5_K_M geometry cut to 8 layers (its start
    # captures 16 group chunks), which pays for the tp phase's second slice;
    # the continuous pass stays at full depth, where staggered requests
    # overlap and join a running group
    paths["serving 13B"] = serving(card, lg=LLM_13B_L8)
    paths["continuous"] = continuous_serving(card, paths["serving 13B"])
    paths["speculative batched"] = paths["serving 13B"]["spec_batch"]
    paths["speculative greedy + sampled group"] = paths["speculative batched"]["pair"]
    counts = paths["serving 13B"]["counts"]
    missing = [k for k in SERVING_KERNELS if counts[k] <= 0]
    if missing:
        raise AssertionError(f"serving: kernels never launched on the main path: {missing}")
    stray = [k for k in PACKED_KERNELS if counts[k]]
    if stray:
        raise AssertionError(f"serving: packed kernels launched: {stray}")
    phase("repack")
    paths[REPACK_LABEL] = chat(
        REPACK_LABEL, LLM_13B_L8, card, REPACK_CHAT_KERNELS, quant_mode="repack",
        vision_quant="q5_k", forbid=GQ_KERNELS + PACKED_KERNELS)
    paths["13B q5_1 encode"] = encode_check(card)
    phase("w8a8")
    paths[W8A8_LABEL] = w8a8_f8(card)
    paths[TOOLS_W8A8] = paths[W8A8_LABEL]["tools"]
    phase("quality")
    paths["quality small"] = quality_run(card)
    phase("clients")
    clients = clients_phase(card)
    paths["13B L8 clients: shift + restore"] = {"counts": clients["counts"]}
    paths["13B L8 C ABI chat (ctypes)"] = {"counts": clients["capi"]["counts"]}
    phase("bench")
    # the packed gq chat's captured 16-token chunks (graph_ab), the engine's
    # counterpart of the benchmark's headline arm
    paths[BENCH_LABEL] = bench_phase(
        card, paths["13B Q5_K_M gq packed"]["graphs"]["captured"]["tok_s"])
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[end] this process holds {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
        f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved")
    phase("end")

    meta = {
        "gq_decode": ("minigpt4_tpu_torch/csrc/gq_decode.cu", "minigpt4_tpu/ops/group_i8.py:522",
                      "13B w13 27648x5120 M=8"),
        "gq_prefill": ("minigpt4_tpu_torch/csrc/gq_prefill.cu", "minigpt4_tpu/ops/group_i8.py:736",
                       "w13 27648x5120 M=512"),
        "gq_decode_generic": ("minigpt4_tpu_torch/csrc/gq_decode.cu",
                              "minigpt4_tpu/ops/group_i8.py:550", "output 32000x5120 M=1"),
        "gq_prefill_generic": ("minigpt4_tpu_torch/csrc/gq_prefill.cu",
                               "minigpt4_tpu/ops/group_i8.py:736", "w2 5120x13824 M=512"),
        "flash_decode": ("minigpt4_tpu_torch/csrc/flash_decode.cu",
                         "minigpt4_tpu/ops/flash_decode.py:82", "B=1 S=1 pos0=1000"),
        "paged_flash_decode": ("minigpt4_tpu_torch/csrc/flash_decode.cu",
                               "minigpt4_tpu/ops/flash_decode.py:82", "B=8 S=1 pos0"),
        "rq_decode": ("minigpt4_tpu_torch/csrc/rq_matmul.cu",
                      "minigpt4_tpu/ops/pallas_quant_matmul.py:136", "w13 27648x5120 M=1"),
        "rq_prefill": ("minigpt4_tpu_torch/csrc/rq_matmul.cu",
                       "minigpt4_tpu/ops/pallas_quant_matmul.py:195", "fc2 1408x6144 M=257"),
        "i8_decode": ("minigpt4_tpu_torch/csrc/i8_matmul.cu", "minigpt4_tpu/ops/i8_matmul.py:133",
                      "w13 27648x5120 M=1"),
        "i8_prefill": ("minigpt4_tpu_torch/csrc/i8_matmul.cu",
                       "minigpt4_tpu/ops/i8_matmul.py:133", "w13 27648x5120 M=512"),
        # the e4m3 element type of the two flash kernels (_block_f32's unpack):
        # every flash launch of the w8a8 path reads an e4m3 cache
        "flash_decode[e4m3]": ("minigpt4_tpu_torch/csrc/flash_decode.cu",
                               "minigpt4_tpu/ops/flash_decode.py:62", "e4m3 B=1 S=1 pos0=2015"),
        "paged_flash_decode[e4m3]": ("minigpt4_tpu_torch/csrc/flash_decode.cu",
                                     "minigpt4_tpu/ops/flash_decode.py:62", "e4m3 B=8 S=1 pos0"),
    }
    # the gq entries on packed codes: the packing mode of the TPU kernel each
    # replaces, and the case that stands for it, a shape and row count of
    # the packed chat that counts its launches
    packed_rep = {"gq_decode[p4]": "w13 22016x4096 M=1", "gq_decode[p5]": "w13 27648x5120 M=1",
                  "gq_prefill[p4]": f"w13 22016x4096 M={PROMPT_M}",
                  "gq_prefill[p5]": f"w13 27648x5120 M={PROMPT_M}",
                  "gq_decode_generic[p4]": "w2 4096x11008 M=1",
                  "gq_decode_generic[p5]": "wo 4096x4096 M=1",
                  "gq_decode_generic[p6]": "output 32000x5120 M=1",
                  "gq_prefill_generic[p4]": f"w2 4096x11008 M={PROMPT_M}",
                  "gq_prefill_generic[p5]": f"wo 4096x4096 M={PROMPT_M}",
                  "gq_prefill_generic[p6]": f"w2 5120x13824 M={PROMPT_M}"}
    for name, rep in packed_rep.items():
        wrapper, packing = name[:-1].split("[")
        meta[name] = (meta[wrapper][0], f"{meta[wrapper][1]} (packing {packing})", rep)
    # "launches": the count in each kernel's own path (the repack chat for
    # the rq kernels, the w8a8 path for the i8 kernels and the e4m3 reads,
    # the serving phase for the others); every path's count is in
    # "launches_by_path"
    main_path = {"rq_decode": REPACK_LABEL, "rq_prefill": REPACK_LABEL,
                 "i8_decode": W8A8_LABEL, "i8_prefill": W8A8_LABEL,
                 "flash_decode[e4m3]": W8A8_LABEL, "paged_flash_decode[e4m3]": W8A8_LABEL}
    main_path.update({k: "13B Q5_K_M gq packed" if k in PACKED_13B_KERNELS
                      else "7B q4 mix L8 gq packed" for k in PACKED_KERNELS})
    kernels = []
    for name, (src, replaces, rep) in meta.items():
        e4m3 = name.endswith("[e4m3]")
        # an e4m3 read counts on its wrapper, a packed entry on its own
        counter = name.split("[")[0] if e4m3 else name
        rows = [r for r in kernel_results[counter] if r["shape"].startswith("e4m3") == e4m3]
        main_row = next(r for r in rows if r["shape"].startswith(rep))
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": paths[main_path.get(name, "serving 13B")]["counts"][counter],
            # an e4m3 read happens only on the path whose cache is e4m3
            "launches_by_path": {label: p["counts"][counter] for label, p in paths.items()
                                 if not e4m3 or label == main_path[name]},
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"], "shape": main_row["shape"],
            **{k: main_row[k] for k in DEVICE_KEYS if k in main_row},
            "cases": [{k: r[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "library_ms",
                                         "unpacked_ms", "max_diff_unpacked", "host_us",
                                         "probe_device_ms", "probe_factor")
                       + DEVICE_KEYS if k in r}
                      for r in rows],
        })
        decode_sass = {"gq_decode": "gq_decode_i8_kernel",
                       "gq_decode_generic": "gq_decode_i8_kernel",
                       "i8_decode": "i8_decode_kernel", "rq_decode": "rq_decode_kernel"}
        if name in decode_sass:
            kernels[-1]["sass_idp_i2f"] = {k: v for k, v in sass[decode_sass[name]].items()
                                           if k.startswith(("IDP", "I2F"))}
        if name == "i8_prefill":
            kernels[-1]["sass_opcodes"] = sass["i8_prefill_kernel"]
        if name in ("gq_prefill", "gq_prefill_generic", "rq_prefill"):
            kernels[-1]["sass_opcodes"] = sass["qmm_prefill_kernel"]
        if name in GATE_ENTRIES:
            st = synth["gate"]["entries"][name]
            kernels[-1]["gate"] = {"cases": st["cases"], "max_rel_err": st["max_rel_err"]}
    rows = kernel_results[STATS]
    main_row = next(r for r in rows if r["shape"] == "B=1 S=1 pos0=2015 slice 3")
    kernels.append({
        "name": STATS, "route": "cuda", "source": "minigpt4_tpu_torch/csrc/flash_decode.cu",
        "replaces": "minigpt4_tpu/ops/flash_decode.py:82 stats=True",
        "launches": paths["sp"]["counts"][STATS],
        "launches_by_path": {label: p["counts"][STATS] for label, p in paths.items()},
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "merge_max_abs_err": max(r["merge_err"] for r in rows),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"], "library_ms": main_row["library_ms"],
        "shape": main_row["shape"], **{k: main_row[k] for k in DEVICE_KEYS},
        "cases": [{k: r[k] for k in ("shape", "ms", "normalized_ms", "plain_ms", "bound_ms",
                                     "library_ms", "null_ml_bits_equal") + DEVICE_KEYS}
                  for r in rows],
    })
    kernels += probe_kernel_entries(paths, probe)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
