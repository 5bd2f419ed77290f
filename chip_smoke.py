"""Drive the PyTorch/CUDA port's paths once on one GPU: VisRAG-Ret page
embedding → retrieval (bf16 and int8), retriever training, EVisRAG serving
(bf16 and int8 KV pools), RS-GRPO training steps, EVisRAG SFT, a GAE
RS-GRPO run with the critic, VisRAG-Gen (MiniCPM-V 2.0 / 2.6,
MiniCPM-2B) with the demo, and the SigLIP-only retriever baseline with the
int8 corpus scan.

    python3 chip_smoke.py

Phases (each prints one or more lines; any failure raises and the exit code
is non-zero; no phase catches an error and carries on):

  0. environment: torch/CUDA versions, the card, nvcc, Pillow and pyarrow;
  1. build every kernel source in visrag_tpu_torch/csrc with nvcc, one
     process per source, all at once, and print each kernel's registers,
     whether any spills and how many use a stack frame (a spill in a
     Hopper source or in norms.cu, or a stack frame in
     paged_decode_hopper.cu, attention_kvgrid_hopper.cu or
     attention_segment_hopper.cu, fails the run);
 1b. K7 (csrc/norms.cu, the fused RMSNorm / LayerNorm forward) against its
     plain version at the widths each path gives it (LayerNorm at the
     encode's ViT rows 126,208 x 1152 and the resampler's x 2304; RMSNorm
     at the SFT batch 16,384 x 2048, the LM's 11,264 x 2304, Qwen's vision
     stream x 1280 and the 7B decode 4 x 3584) and at edge shapes (1 and 3
     rows, D = 64, 4096 and 4099, fp32 input, mixed weight dtypes): bf16
     within one bf16 ulp of the plain version plus 2^-16 of the fp32
     computation's scale (|x| + |μ|)·rstd·|w| + |b|, fp32 within 1e-5 of
     |y| plus that scale; the
     gradients through its autograd.Function against plain autograd
     (1e-6 relative); timed beside the plain version and F.layer_norm /
     F.rms_norm, bound = bytes / 3.35 TB/s; RMSNorm on the kernel
     norms.rms_route picks (a warp per row at D <= 4096 and 2112 rows or
     more) in turns with the block-per-row kernel (pr6_ms), with host us
     per call at <= 64 rows; where the route gives the rows to the block
     kernel, the warp-per-row kernel is also launched directly and held to
     the same bound.
     From here on every RMSNorm and LayerNorm of the port runs K7;
  2. K1 without the LSE (the Hopper kernel, attention_lengths_hopper.cu)
     against its plain PyTorch version on the card (bf16 unit-normal
     inputs, 2e-2 max abs on valid rows, pad rows exactly 0) at the shapes
     and lengths phase 3's page and query batches give it (ViT flat 116
     slices x S=1088 and the query batch's empty slice, LM causal 16 x 704
     and 8 x 128), and at three edge-case shapes (d 72 flat with lengths 0,
     1, 63-65, 127-129 and a partial last query tile among them), timed in
     turns with the legacy mma.sync kernel (pr1_ms); then one full-width
     ViT block
     and one full-width LM layer at the page batch's lengths against the
     same block in fp32 on the CPU (2e-2 relative Frobenius error);
  3. the full-width embedding slice on random weights from seed 0: 16
     synthetic pages (bench.py's size mix) and 8 text queries through
     encode_dataset, then StreamingSearcher top-10, build_run and
     evaluate_run; checks finite unit-norm embeddings, self-retrieval at
     rank 1, and that every encode batch launched K1 26 (ViT) + 40 (LM)
     times, all on the Hopper kernel (the route counters; so in phases 3b,
     5, 7, 9, 10 and 11), and K7 56 LayerNorms (2 x 26 + 1 ViT, 3
     resampler) and 81 RMSNorms (2 x 40 + 1);
 3b. the int8 encode: K6 (the w8a8 GEMM on wgmma s8 and TMA,
     csrc/matmul_int8_hopper.cu) against its plain version, every output
     bit-equal (exact int32 product, the same fp32 rounding), at the four
     GEMM shapes of the page batch (ViT qkv and fc1, 126,208 rows; LM
     q/k/v/o and gate/up, 11,264 rows) and at edge shapes (N 4305, N 1, M
     1, K 1000, fp32 output), timed in turns with the mma.sync K6 it
     replaced (pr5_ms) beside the plain version, torch._int_mm alone
     (int_mm_ms) and torch._int_mm + scaling; then VisRAG-Ret with
     quant="int8" in the ViT and the LM on phase 3's weights through
     encode_dataset: 292 K6 launches per batch, every one on the Hopper
     kernel (the route counters), per-page cosine to phase 3's bf16
     embeddings (>= 0.99), the query top-10 overlap, pages/s beside bf16
     in turns and peak memory;
  4. K1 with the LSE and K2 (dq; dk/dv) against the plain version's forward
     and autograd on the card, at the shapes the training step gives them:
     ViT flat at the training micro-batch's pages (4 pages = 40 slice slots
     x S=1152, length-0 slots included) and at its query batch (one empty
     slice), LM causal at both token batches, and an edge shape per form
     with lengths 0, 1, 63, 64, 65, 127, 128, 129 and full (and the same
     lengths with the other mask: ViT flat causal, LM stacked
     bidirectional). bf16 unit-normal q/k/v and a
     `do` that is non-zero on pad rows; each of o, dq, dk, dv within 2e-2
     relative Frobenius error on valid rows, the LSE within 2e-2 abs on
     valid rows, every output finite, and exact zeros where the contract
     says (o and dq on pad query rows, dk/dv on pad keys, LSE_PAD on pad
     LSE rows). Kernels (K1 + LSE, and the Hopper K2 dq and dk/dv, each
     in turns with its legacy mma.sync kernel: pr1_ms, pr5_ms), the plain
     version and F.scaled_dot_product_attention
     (boolean length mask; forward, and backward alone) timed by CUDA
     events between the calls of bursts of 10 that the host queues while
     the device spins, medians (cuda_ms);
  5. the full-width training slice: a 16-pair synthetic parquet (PIL pages
     in bench.py's size mix, query texts), then
     visrag_tpu_torch.driver.train_retriever.main with the paper config
     (τ 0.02, wmean, batch 16, lr 5e-6, grad clip 1.0) for 3 steps
     (3 epochs of one batch), GradCache micro-batch 4, bf16 AdamW states,
     whole-block remat. Checks a finite loss and grad norm at every step,
     changed parameters, the written checkpoint read back by
     RetrieverTrainer.maybe_resume, and the launch counts of the run (per
     step: 4 micro-batches x 2 encodes (queries, pages) x (26 ViT + 40 LM)
     attention layers; K1 without the LSE once per layer in pass 1, K1 with
     the LSE twice per layer in pass 2 (forward, and the remat recompute),
     K2 dq and dk/dv once per layer), every K1 and K2 launch on the
     Hopper kernels (the route counters, by head dim for K2: the ViT's
     d 72, the LM's d 64). Then, from one set of weights, one
     direct step and one GradCache step (micro-batch 2) on 4 pairs must give
     parameter gradients within 2e-2 relative of each other, and three
     direct steps at lr 1e-4 must lower the loss on that fixed batch;
  6. the retriever freed, the six serving requests of phase 7 assembled by
     evisrag_predict.assemble_request with StandInTokenizer (Qwen's
     special-token ids; no tokenizer files are in the repository), then K3
     (banded segment attention on the Hopper forward body,
     csrc/attention_kvgrid_hopper.cu) on views of one fused qkv tensor at
     the first 3-page request's window and image segments, each timed in
     turns with the first kernel (csrc/attention_kvgrid.cu, legacy=True:
     pr3_ms), and at edge ids (windows of 63/64/65 and 127/128/129 tokens
     straddling tiles, a pad tail filling whole tiles beside a row of pad
     only, one segment over all of S; pad rows exactly 0), every launch on
     the Hopper kernel (kg.route_counts(); so in phases 7, 7b, 9 and 11),
     and K3's time per vision-tower run (28 window + 4 full layers), K1 stacked
     causal with grouped kv heads (28/4, d = 128) at the whole and batched
     prefill shapes and at lengths 0, 1, 63, 64, 65 and full (pad rows
     exactly 0; in turns with the legacy kernel), each against its plain
     version (2e-2 relative Frobenius error, finite) and timed beside its
     plain version and the library call (SDPA with a block-diagonal mask;
     SDPA with enable_gqa and a causal length mask); K5 (paged decode,
     csrc/paged_decode_hopper.cu) through the engine's table (a
     power-of-two width, null blocks past each length) at K5_SHAPES: the
     7B engine's decode shape (the four live requests' final lengths,
     28/4, d 128) at 128-token blocks, in turns with the first kernel
     (csrc/paged_decode.cu, legacy=True: legacy_ms), and at 8-token
     blocks, MiniCPM-2B's (36/36, d 64, 4 slots up to 4,096 tokens) and
     the 3B rollout's (16/2, d 128, 8-token blocks, 8 slots up to 16,536),
     each again at lengths 1, bs and bs + 1: 2e-2 relative and 2e-2 max
     abs, finite, timed beside the plain version, gather + SDPA (no one
     call computes K5) and the bound, with the split count (the cluster
     size) and the blocks that hold work; K8 (chunked-prefill
     attention, csrc/attention_chunk_hopper.cu) at the 7B's 2048-token
     chunks over L 2048 / 4096 / 6144 (28/4, d 128) against its plain
     version, timed beside it, SDPA with the explicit chunk mask and the
     bound; then one full-width vision block and one 7B text layer, bf16
     on the card against fp32 on the CPU;
  7. Qwen2.5-VL-7B at full width on random weights from seed 0 and the
     engine from evisrag_predict.build_engine (4 slots, 16k tokens, 2048-
     token chunked prefill, prefix cache): six requests, one of them an
     n = 2 group (three 3-page prompts → chunked prefill, one small page →
     whole prefill, two text prompts → one batched prefill), greedy with
     repetition penalty 1.05 and the image token banned, 64 new tokens each
     (the driver's default is 2048). Checks complete outputs without the
     image token, a schedule with P, C/c and D, launch counts of exactly
     32 K3 per vision-tower run, 28 K1 per whole or batched prefill, 28 K8
     per prefill chunk and 28 K5 per decode step (none on the first
     kernel), and decode logits
     over the paged pool within 2e-2
     relative of a full causal pass at the same positions, after a whole
     and after a chunked prefill; prints the vision tower's ms per request
     (the first 3-page request's also in turns with the first K3 kernel),
     time to first token, prefill tokens/s, decode ms/step, output
     tokens/s and peak memory;
 7b. K5's int8 variant against its plain version (RTOL_K5_INT8 = 0.0035
     relative) at phase 6's K5 shapes and edge lengths, timed as there
     (in turns with the first kernel at the 7B decode shape) and beside K5
     on bf16 pools of the dequantized values; then the same six requests
     through build_engine(cache_dtype="int8") on the same 7B weights:
     complete outputs, K5 int8 28 per decode step (none on bf16 K5 or the
     first kernel), K8 28 per prefill chunk, output tokens/s, ms per
     decode step, peak memory, pool bytes against bf16, and decode logits
     over int8 pools against phase 7's over bf16 pools at the same steps
     (0.1 relative);
  8. the 7B model freed, four RL prompts written as a jsonl (two with 3
     page images, two text-only) and encoded by the RL driver's
     encode_qwen_prompt_row; then K4 (segment-id attention: forward with
     the LSE, dq and dk/dv on wgmma + TMA at d 64 / 80 / 128, every launch on
     the Hopper kernels by the route counters) against its plain
     version's forward and written-out backward on the
     card, at the first packed micro-batch the trainer will build from
     those prompts (first-fit ids, 16/2 heads, d = 128, causal), at one
     16640-token row, at the 7B head grouping (28/4), at edge cases
     (segments of 1, 63, 64 and 65 tokens, non-ascending and negative ids,
     an all-pad row, Sq != Sk; segments of 127, 128 and 129 tokens and a
     row one segment fills in whole 128-row tiles, at d 128 and 64), and
     K3's backward (K3 forward with the LSE, K4's Hopper dq and dk/dv at
     d 80 on sorted ids, which walk only the band) at the vision tower's
     window and image ids, and K4 at d 80 on the window ids as
     attn_impl="packed" runs it (non-causal), all timed in turns with the
     mma.sync kernels, and K3's own LSE: o,
     dq, dk, dv within 2e-2 relative Frobenius error, the LSE within 2e-2
     abs, exact zeros on pad rows and keys; the kernels' pre-pass (tile
     classes) equal to segment_tile_classes_reference; the Hopper dq's
     delta (1e-4 of its scale) and the dk/dv that reads it (1e-3
     relative) against the mma.sync dq's; timed beside the plain version, SDPA
     (its causal flag for one segment, a boolean block-diagonal mask for
     packed rows, enable_gqa; forward, and backward alone) and, in turns,
     the mma.sync forward, dq and dk/dv (new, old, old, new), with the
     bound from the visible pairs; then
     K1 with the LSE and K2 at d = 128 with grouped kv
     heads (16/2 and 28/4, causal) at the padded update's micro-batch and
     at lengths 1, 63, 64, 65 and full, against the plain forward and
     autograd (2e-2 relative), timed beside SDPA with enable_gqa and, in
     turns, the legacy mma.sync K1 and K2; then K1, K2 and K4 at fixed
     inputs bit for bit against the kernels of the tree before K3's
     redesign (PARENT_DIGESTS);
  9. Qwen2.5-VL-3B at full width on random weights from seed 0, whole-block
     remat, a frozen copy as the reference policy (in-loss KL 0.01), through
     rl_main's build_trainer and run_training: two RS-GRPO steps of 4
     prompts x n 4, 64 response tokens (the default is 1536), 16384-token
     packed micro-batches, fp32 AdamW states, the engine as rl_main sets it
     (8 slots, chunked prefill 2048, prefix cache), rewards from the
     `hash_reward` scorer below through reward.reward_function. The first
     run takes one step and writes a checkpoint; the second resumes from it
     (step, uid counter, rng state, data cursor checked) and takes the
     second step. Checks the launch counts exactly as reckoned (K4 forward
     2 x 36 per packed micro-batch, dq and dk/dv 36; K1 36 per prefill
     dispatch and per log-prob micro-batch; K3 32 per vision-tower run; K5
     36 per decode step, none on the first kernel, the engine at rl_main's
     8-token pool blocks), every K4 launch on the Hopper kernels (the route
     counters; so in phase 11), K8 36 per prefill chunk, a finite
     non-zero grad_norm and no skipped step,
     changed text weights and a bit-identical tower, an empty prefix cache
     after each rollout, complete responses without the image token; then
     one packed micro-batch's loss against the padded forward's (K1, no
     gradient), and its loss and parameter gradients through 2 layers at
     full width with the kernels against the plain versions (5e-2 relative),
     and the same for the padded update of those sequences (K1 with the
     LSE, K2 at d = 128 with grouped kv heads, one launch each per layer;
     the PPO loss's clip and clamp branches taken at the plain run's
     log-probs in both runs, so that the gradients differ by the kernels'
     error alone);
     prints each step's time split from the trainer's Timers, tokens/s and
     peak memory;
 10. EVisRAG stage-1 SFT at Qwen2.5-VL-3B's full width on random weights
     from seed 0, whole-block remat, the tower frozen, through sft_main's
     build_sft and run_sft: 3 steps of 4 right-padded rows (lengths up to
     the driver's --max-len 4096; StandInTokenizer), warmup 1 step, lr
     1e-4, fp32 AdamW states. Checks a finite loss and grad_norm each step,
     changed text weights and a bit-identical tower, the saved weights read
     back equal, and the launch counts per step as reckoned (K1 + LSE 2 x
     36, K2 dq and dk/dv 36, K7 4 x 36 + 1); then one batch's loss and
     parameter gradients through 2 full-width layers, kernels (K1 + LSE,
     K2, K7) against the plain versions (5e-2 relative); prints s/step,
     tokens/s and peak memory;
 11. one GAE RS-GRPO run through rl_main's build_critic, build_trainer and
     run_training at Qwen2.5-VL-3B's full width with the text depth cut to
     12 layers (actor, critic and engine on one card): phase 9's prompts,
     64 response tokens, hash_reward, no reference policy, two steps with
     critic_warmup 1. Checks finite values, advantages, returns and value
     loss, the critic's weights moving in both steps and the actor's only
     in step 2, and a resume (the critic's weights and moments zeroed)
     that restores the critic's state from the step-2 checkpoint;
 12. MiniCPM-V 2.0 at full width (MiniCPMVGenConfig(), random bf16 weights
     from seed 0) through driver/generate_eval's builder and
     run_generate_eval with the MockTokenizer, 3 pages (bench.py's size
     mix) x 2 queries: page_concatenation (greedy, 20 new tokens) and
     weighted_selection (beam k 3, repetition penalty 1.2, a query's pages
     in one score_fn.batched call), then MiniCPM-2B's text backend on the
     same LM (task text, the prompts filling the 4096 bucket). Checks the
     launch counts against the model's calls (K1 26 flat per vision run
     and 40 stacked per prefill, K5 40 per engine decode step, K7 at every
     norm; every K1 on the Hopper kernel, none on K5's first kernel), each
     greedy step's logits over the paged pool against one full forward
     (2e-2 relative, vision and text), and the batched beam against the
     sequential one (the same ids, scores within 1e-3) in fp32 at one ViT
     block and 2 LM layers on the CPU, on the query's 2 shorter pages
     (the bf16 pair on the card, on all 3, is
     printed: its 9-row decode rounds otherwise than the 3-row one and
     flips near-ties of the random model); K1 at both prefill buckets and
     K5 at 36/36 d 64 against their plain versions, timed beside SDPA /
     gather + SDPA and the bound; prints TTFT, decode ms per step and peak
     memory;
 13. MiniCPM-V 2.6 at full width (MiniCPMV26Config(), 8.1B params) through
     the builder and run_generate_eval: multi_image, each query's 3 pages
     in one prompt (max_slice_nums 9, uint8 device-mode pixels), greedy,
     20 new tokens. Checks the launch counts (K1 27 flat and 28 GQA per
     prefill, K5 28 per decode step) and each greedy step's logits against
     one full forward; K1 GQA 28/4 d 128 at the prefill bucket; TTFT,
     decode ms per step and peak memory;
 14. the demo's build-index and answer as subprocesses on the card, with
     VisRAG-Ret at full width on random weights (the tiny configs' head
     dims are not ones the kernels take).
 15. the SigLIP-only retriever baseline and the retrieval remainder:
     SiglipModel at full width (SiglipConfig(): 27 + 27 layers, width
     1152, 16 heads of d 72, MLP 4304, 1.13B params, random bf16 weights
     from seed 0); 16 pages of bench.py's mix resized to 384 x 384, scaled
     to [-1, 1] and patchified to (16, 729, 588), and 8 queries of 64
     full-length MockTokenizer ids through encode_image / encode_text,
     each tower run launching K1 stacked (d 72, not causal) exactly 27
     times, all on the Hopper kernel, and K7 LayerNorm 56 (vision) / 55
     (text) times; finite embeddings, L2-normalised, searched top-5 by
     StreamingSearcher with quant "none" and "int8"; a resident 1,000,000
     x 2304 corpus of unit rows with 64 planted queries (a corpus row plus
     small noise): topk_single (fp32) and topk_single_int8 (K6, fp32
     scores) at k 10, every planted row at rank 1 in both, their top-10
     overlap; StreamingSearcher over 131,072 rows in 4 chunks against one
     call (the same ids both quants, int8 scores bit for bit, a row
     duplicated across chunks tying to the lower index); self_retrieve
     with a duplicated query (the tie to the lower index); the counted
     launches (K1 54, LayerNorm 111, K6 7). Then K1 at the vision (16 x
     729), text (8 x 64) and masked text (lengths 1, 5, 63, 64) shapes
     against the plain version (2e-2 max abs on valid rows, pad rows
     exactly 0), one full-width encoder layer bf16 on the card against
     fp32 on the CPU (2e-2), K7 at 11,664 and 512 rows (phase 1b's bound),
     device quantize_rows bit-equal to quantize_rows_np on 65,536 rows,
     K6's scan scores bit-equal to int8_matmul_reference, each timed beside
     its plain version, its library call (SDPA with a length mask;
     F.layer_norm; torch._int_mm + scaling) and the bound; both scans
     timed by utils/timing.measure, the host upload of the int8 and fp32
     corpora, one utils/profiling.trace of the int8 scan holding K6's
     symbol; the GELU sweep (ops/gelu.fast_gelu on the card equal to
     float64 erf-GELU on every finite bf16 pattern; F.gelu's mismatches
     counted, and the ViT's erf MLP on fast_gelu); and the synthesize
     twin (driver/synthesize_queries' generator at Qwen2.5-VL-3B's width
     on random weights, one page, 16 new tokens, K3, K1 and K5 launches
     reckoned from the model's calls).
 16. the multi-GPU layer (mesh.py, parallel/, the sharded search, the
     trainers on FSDP2) on this one card as a one-rank NCCL group, at
     full width: eval_retriever on the 16 pages and 8 queries on one
     device and then under --coordinator (the driver makes its own group:
     the data-parallel encode, the sharded fp32 search), the ranked ids
     equal; make_sharded_topk fp32 and int8 (K6) over phase 15's
     1,000,000 x 2304 corpus (SCAN_SEED), ids and scores bit for bit
     phase 15's; parallel.ulysses_attention over the seq group (NCCL
     all_to_alls) forward and backward at the per-rank shapes of 2- and
     4-way Ulysses on phase 10's SFT batch (4 x 4096, 8/1 and 4/1 heads,
     d 128), K4's forward, dq and dk/dv launched once each, then checked
     and timed there against the plain versions (phase 8's check);
     train_retriever under --coordinator for 2 of phase 5's steps (FSDP2,
     GradCache, the negatives' gather; the full-state checkpoint), its
     losses within RTOL_TRAIN of phase 5's; 2 SFT steps at Qwen2.5-VL-3B's
     width through sft_main's build_sft / run_sft on a one-rank mesh
     (ulysses_size 1: K1 + LSE and K2), losses and grad norms bit for bit
     phase 10's (of a one-device run in the phase under
     --dist-only); K1, K2, K4, K6 and K7 launches
     asserted on these runs. 16e: train_retriever with train.lora_rank 8
     (lr 1e-4, otherwise phase 5's settings) for 2 steps on one device and
     under --coordinator (FSDP2 shards each block's frozen base with its
     adapters), the losses and grad norms bit for bit, rank 0's
     merged_model reloaded and one page embedded against the adapted
     model. 16f: RS-GRPO through rl_main's rl_mesh, build_trainer and
     run_training on a one-rank group at phase 9's 3B configuration for 2
     steps (FSDP2 actor and reference policy, the engine on the whole
     copy refilled after the update), step 1's token ids and rewards equal
     to phase 9's and both steps' losses bit for bit, then one GAE step at
     phase 11's settings (the critic sharded) bit for bit phase 11's first
     (under --dist-only both against one-device runs in the phase). 16g:
     K4 at the per-rank Ulysses shapes of phase 9's packed update (8/1 and
     4/1 heads), launched through ulysses_attention and checked and timed
     as the SFT batch's. 16h: tensor parallelism as two processes on this
     card over a gloo group whose collectives carry CUDA tensors (NCCL
     takes one rank a card; the compute mode must allow two processes),
     one job of two ranks (`--tp-child`) on a (data 1, model 2) mesh:
     Qwen2.5-VL-7B of phase 7's seed and init served at tp 2 through
     Engine(mesh=) with phase 7's engine settings plus a 1024-token
     bucket, greedy, 32 new tokens, bf16 then int8 pools, on 3 of phase
     7's requests (the text pair, the small page with its n = 2 fork),
     against the same run in one process: the same prompt ends, every
     prompt end's and the first decode step's logits within RTOL_BLOCK,
     each request's tokens equal up to the first step whose top-2 margin
     in the one-process run is below twice the largest logit error, the
     agreement printed per request; then two RS-GRPO steps at
     Qwen2.5-VL-3B's width with 8 of 36 text layers on phase 9's text
     prompts (the greedy rollout over the model group, the update FSDP2
     over data; step 1's decay moves every weight, so step 2's rollout
     runs on shards refilled with new weights): each step's rollout held
     to one process's greedy rollout of the same weights by the serving
     rule, and both steps' loss and grad norm against one process's
     update of the same batches (RTOL_TRAIN); then K5 at 14/2 (bf16,
     int8), K1 GQA at 14/2, K3 at 8 heads (window, full, edges) and K5 at
     the hybrid rollout's 8/1 at the shapes those runs gave them, and
     kernel-only the tp 4 shapes (K5 7/1 and 4/1, K1 7/1), against their
     plain versions, timed beside the library call and the bound.

The last lines are the card's name and power limit (nvidia-smi), one JSON
line describing every kernel (K1 flat, K1 stacked, K1 + LSE, K2 dq and
K2 dk/dv for the ViT (d 72) and for the LM (d 64), K1 stacked GQA, K5, K3
in the window and in the full-attention layers, K8 (launches from phase
7's chunks, numbers at L 6144), K8 at the 3B's 16/2 (launches from phase
9's chunks, numbers at L 6144),
K6, K5 int8, K4 forward, K4 dq, K4 dk/dv, K1 + LSE, K2 dq and K2 dk/dv at
d = 128 with grouped kv heads, K7 as
`rmsnorm` (launches from phase 10's SFT run, numbers at its batch) and
`layernorm` (launches from phase 3's encode, numbers at the ViT's rows),
and K1 at MiniCPM-2B's generation prefill and at MiniCPM-V 2.6's, and K5
at MiniCPM-2B's 36/36 d 64 decode (launches from phases 12 and 13),
and K1 at SigLIP's vision and text shapes, K7 LayerNorm at SigLIP's rows
and K6 at the int8 scan's shape (launches from phase 15),
and K4's forward, dq and dk/dv at Ulysses' per-rank shapes of the SFT
batch and of the RL packed update (launches from phase 16's
ulysses_attention runs), and K5 (bf16 and int8), K1 GQA and K3 (window
and full) at a tp 2 rank's heads (launches from 16h's serving run's rank
0) and K5 at the hybrid rollout's 8/1 (launches from its rank 0):
launches on its main path, ms, plain_ms, library_ms, bound_ms,
max_abs_err, and in the same turns the earlier kernel: pr4_ms for K4's
forward, dq and dk/dv (the mma.sync kernels), pr5_ms for K6 (the
mma.sync kernel, beside int_mm_ms, torch._int_mm alone), pr1_ms for K1
(the mma.sync attention_lengths.cu), pr5_ms for K2 (the mma.sync
attention_lengths_bwd.cu), pr6_ms for RMSNorm (the block-per-row kernel),
legacy_ms for K5 and K5 int8 (the first kernel, csrc/paged_decode.cu),
pr3_ms for K3 (the first kernel, csrc/attention_kvgrid.cu);
every checked shape under "checks"), and
{"ok": true, "device": {...}}. `--rl-only` runs phases 0, 1, 1b and 8-11,
`--gen-only` phases 0, 1, 1b and 12-14, `--ret-only` phases 0, 1, 1b and
15, `--dist-only` phases 0, 1, 1b and 16; each ends without the ok line
and exits 1.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import gc
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import torch
import torch.nn.functional as F

ATOL_KERNEL = 2e-2      # K1 forward, bf16 kernel vs plain, unit-normal inputs
RTOL_TRAIN = 2e-2       # K1+LSE / K2 and GradCache vs direct, relative
RTOL_BLOCK = 2e-2       # bf16 block on the card vs fp32 block on the CPU
PAGE_SIZES = [(826, 1169), (1654, 2339), (1280, 720), (900, 900)]
N_PAGES, N_QUERIES = 16, 8
MICRO = 4               # GradCache micro-batch of the training run
TRAIN_STEPS = 3
PEAK_FLOPS = 989e12     # H100 SXM bf16 dense
PEAK_BYTES = 3.35e12    # H100 SXM HBM3
REPLACES = {"fwd": "visrag_tpu/ops/attention_lengths.py:47",
            "dq": "visrag_tpu/ops/attention_lengths.py:153",
            "dkv": "visrag_tpu/ops/attention_lengths.py:204",
            "kvgrid": "visrag_tpu/ops/attention_kvgrid.py:94",
            "paged": "visrag_tpu/serving/paged_kv.py:238"}


T_START = time.perf_counter()


def log(msg):
    """A line of the run's log, after the seconds since the script
    started."""
    print(f"{time.perf_counter() - T_START:7.1f} s {msg}", flush=True)


def smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


SPIN_CYCLES = 4_000_000   # ~2 ms of device time: the host queues a burst


def cuda_ms(fn, reps=10):
    """Median ms of one fn() in a burst of reps calls with a CUDA event
    recorded between consecutive calls, after a warm-up. The device first
    spins for SPIN_CYCLES, so that the host has queued the burst before the
    device reaches it: each interval is then the device's time for one call,
    not the host's time to issue it (a call timed alone between two events
    counts both, and Python and ctypes take up to ~50 us to issue one)."""
    fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(SPIN_CYCLES)
    fn()
    events[0].record()
    for e in events[1:]:
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b)
                             for a, b in zip(events, events[1:]))


def _pairs(lens, causal):
    """Valid (query, key) pairs of the score matrices, summed over rows."""
    return sum(n * (n + 1) // 2 if causal else n * n for n in lens)


def _bound(flops, nbytes):
    """(bound_ms, bound_by): the larger of operations over the bf16 peak and
    bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"


def attention_bound(kind, lens, s, h, d, causal, kv_heads=None):
    """Least time for one kernel's work on this run's lengths: `kind` fwd
    (QK^T, PV), fwd_lse, dq (S, dP, dQ) or dkv (S, dP, dV, dK); inputs
    counted on valid rows (K/V and their gradients at kv_heads heads when
    those are shared), every output row written once."""
    pairs, valid_rows = _pairs(lens, causal), sum(lens)
    b, hk = len(lens), kv_heads or h
    row_in, row_out = valid_rows * h * d * 2, b * s * h * d * 2
    kv_in, kv_out = valid_rows * hk * d * 2, b * s * hk * d * 2
    stat_in, stat_out = valid_rows * h * 4, b * h * s * 4
    matmuls, nbytes = {
        "fwd": (2, row_in + 2 * kv_in + row_out),
        "fwd_lse": (2, row_in + 2 * kv_in + row_out + stat_out),
        "dq": (3, 3 * row_in + 2 * kv_in + stat_in + row_out + stat_out),
        "dkv": (4, 2 * row_in + 2 * kv_in + 2 * stat_in + 2 * kv_out),
    }[kind]
    return _bound(matmuls * 2 * pairs * h * d, nbytes)


def _sdpa_mask(lens, s, causal, device):
    """Boolean (B, 1, S, S) mask of allowed keys for SDPA; a length-0 row
    keeps key 0 so that no row of the yardstick is all masked."""
    pos = torch.arange(s, device=device)
    keep = torch.clamp(lens, min=1)
    allow = pos[None, None, None, :] < keep[:, None, None, None]
    if causal:
        allow = allow & (pos[:, None] >= pos[None, :])[None, None]
    return allow


def _lengths_routes(tag, launches):
    """Every K1 and K2 launch of a path on the Hopper kernels: the route
    counters against the path's K1 launches (flat + stacked + fwd_lse) and
    K2 launches (dq + dkv). → the K2 launches by kernel and head dim;
    raises if one launch took a legacy kernel."""
    from visrag_tpu_torch.ops import attention_lengths as al
    routes, bwd = al.route_counts(), al.bwd_route_counts()
    k1 = launches["flat"] + launches["stacked"] + launches["fwd_lse"]
    k2 = launches.get("dq", 0) + launches.get("dkv", 0)
    if routes != {"hopper": k1, "legacy": 0}:
        raise RuntimeError(f"{tag} K1 launches by route {routes}: want all "
                           f"{k1} on the Hopper kernel")
    if bwd != {"hopper": k2, "legacy": 0}:
        raise RuntimeError(f"{tag} K2 launches by route {bwd}: want all "
                           f"{k2} on the Hopper kernels")
    by_d = al.bwd_head_dim_counts()
    log(f"{tag} K1 routes: {routes['hopper']} launches on the Hopper kernel "
        f"({al.SOURCE}), 0 on the legacy one; K2 routes: {bwd['hopper']} on "
        f"the Hopper kernels ({al.BWD_SOURCE}; by head dim {by_d}), 0 on the "
        f"legacy ones")
    return by_d


def _kvgrid_routes(tag):
    """Every K3 launch of a path on the Hopper kernel: the route counters
    against the wrapper's launch counters; raises if one took the first
    kernel."""
    from visrag_tpu_torch.ops import attention_kvgrid as kg
    want = {"fwd": {"hopper": kg.launches, "legacy": 0},
            "fwd_lse": {"hopper": kg.lse_launches, "legacy": 0}}
    if kg.route_counts() != want:
        raise RuntimeError(f"{tag} K3 launches by route {kg.route_counts()}: "
                           f"want {want}")
    log(f"{tag} K3 routes: {kg.launches} launches (and {kg.lse_launches} "
        f"with the LSE) on the Hopper kernel ({kg.SOURCE}), 0 on the first "
        f"one")


def _turns(new, old):
    """new and old timed in turns (new, old, old, new) by cuda_ms. → (mean
    new ms, mean old ms, {"new": [...], "old": [...]})."""
    turns = {"new": [], "old": []}
    for which in ("new", "old", "old", "new"):
        turns[which].append(cuda_ms(new if which == "new" else old))
    return statistics.mean(turns["new"]), statistics.mean(turns["old"]), turns


def phase0_environment():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is False); this script runs only on the GPU")
    import importlib.util
    have = {m: importlib.util.find_spec(m) is not None
            for m in ("PIL", "pyarrow")}
    log(f"[0] torch {torch.__version__} cuda {torch.version.cuda} | {smi()} "
        f"| nvcc {shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc?'} | "
        f"PIL {have['PIL']} pyarrow {have['pyarrow']}")
    if not all(have.values()):
        raise RuntimeError("Pillow and pyarrow are required for the "
                           "synthetic pages and the training parquet")


# sources in which a register spill fails the run (every Hopper source and
# K7's norms), and those in which a stack frame does (K5, K3 and K4's
# Hopper kernels)
NO_SPILLS = ("hopper", "norms")
NO_STACK = ("paged_decode_hopper", "attention_kvgrid_hopper",
            "attention_segment_hopper")


def phase1_build():
    from visrag_tpu_torch.ops import _build
    t0 = time.perf_counter()
    paths = _build.build_all()
    dt = time.perf_counter() - t0
    faults = {}
    for name, path in zip(_build.SOURCES, paths):
        regs, spilled, stacked = _build.ptxas_report(name)
        log(f"[1] built {path.name} (registers per kernel: "
            f"{', '.join(map(str, regs))}; spill-free: {not spilled}; "
            f"kernels with a stack frame: {len(stacked)})"
            + (f" spills in {spilled}" if spilled else ""))
        if spilled and any(k in name for k in NO_SPILLS):
            faults[name] = {"spills": spilled}
        if stacked and name in NO_STACK:
            faults.setdefault(name, {})["stack"] = stacked
    if faults:
        raise RuntimeError(f"kernels spill registers or use a stack frame: "
                           f"{faults}")
    log(f"[1] {len(paths)} sources built in {dt:.2f} s, one nvcc each")
    return dt


NORM_EPS = 1e-6
RTOL_NORM_FP32 = 1e-5   # K7 on fp32 input, relative to |y| + its scale


def _qwen_vision_rows():
    """Patches of phase 7's first 3-page request: each page resized as
    the serving driver resizes it (max_pixels 1,568,000, 28-pixel grid)
    and cut into 14 x 14 patches."""
    from visrag_tpu_torch.preprocess.qwen_vision import smart_resize
    rows = 0
    for w, h in (PAGE_SIZES[0], PAGE_SIZES[1], PAGE_SIZES[2]):
        hh, ww = smart_resize(h, w, 28, 56 * 56, 1568000)
        rows += (hh // 14) * (ww // 14)
    return rows


def _norm_shapes():
    """(label, kind, rows, D, x dtype, w dtype) of phase 1b: the widths
    each path gives K7, then edge shapes."""
    bf, f32 = torch.bfloat16, torch.float32
    return [
        ("ViT LayerNorm, encode page batch", "ln", 126208, 1152, bf, bf),
        ("resampler ln_kv, encode page batch", "ln", 126208, 2304, bf, bf),
        ("Qwen-3B RMSNorm, SFT batch 4 x 4096", "rms", 16384, 2048, bf, bf),
        ("MiniCPM RMSNorm, encode token batch", "rms", 11264, 2304, bf, bf),
        ("Qwen vision RMSNorm, 3-page request", "rms", _qwen_vision_rows(),
         1280, bf, bf),
        ("Qwen-7B RMSNorm, decode of 4", "rms", 4, 3584, bf, bf),
        ("edge: 1 row", "rms", 1, 2048, bf, bf),
        ("edge: 3 rows", "ln", 3, 1152, bf, bf),
        ("edge: D = 64", "rms", 1000, 64, bf, bf),
        ("edge: D = 64", "ln", 1000, 64, bf, bf),
        ("edge: D = 4096", "ln", 777, 4096, bf, bf),
        ("edge: D = 4099 (scalar path)", "rms", 33, 4099, bf, bf),
        ("edge: fp32 input", "rms", 513, 4096, f32, f32),
        ("edge: fp32 input", "ln", 513, 1152, f32, f32),
        ("edge: fp32 input, bf16 weight", "ln", 129, 2304, f32, bf),
        ("edge: bf16 input, fp32 weight", "rms", 129, 2048, bf, f32),
    ]


def _bf16_ulp(t):
    """One bf16 ulp at |t| (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(
        t.abs().clamp(min=2.0 ** -126))) - 7)


def _host_us(fn, n=200):
    """Microseconds of host time per fn() call, the device drained before
    and after, so that the launch queue never fills."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def _check_norm(gen, label, kind, rows, d, xdt, wdt, phase="[1b]"):
    """K7 against the plain version on one shape: bf16 output within one
    bf16 ulp of the plain version's (of the larger of the two) plus 2^-16
    of the fp32 computation's scale s = (|x| + |μ|)·rstd·|w| + |b| (the
    rounding of x − μ and of the bias sum, which a near-zero output does
    not shrink); fp32 within RTOL_NORM_FP32 of |y| + s. Timed beside the
    plain version and the library call (F.layer_norm; F.rms_norm where
    this torch has it). → the check record."""
    from visrag_tpu_torch.ops import norms
    x = (torch.randn(rows, d, generator=gen, device=DEV) * 2 + 0.5).to(xdt)
    w = (1 + 0.3 * torch.randn(d, generator=gen, device=DEV)).to(wdt)
    b = (0.2 * torch.randn(d, generator=gen, device=DEV)).to(wdt) \
        if kind == "ln" else None

    def plain():
        return norms.rmsnorm_reference(x, w, NORM_EPS) if b is None \
            else norms.layernorm_reference(x, w, b, NORM_EPS)

    def kern():
        return norms._launch(x, w, b, NORM_EPS)

    def block_kernel():     # the block-per-row RMSNorm, for the turns
        return norms._launch(x, w, b, NORM_EPS, legacy=True)
    lib = None
    if b is not None:
        def lib():
            return F.layer_norm(x, (d,), w.to(xdt), b.to(xdt), NORM_EPS)
    elif hasattr(F, "rms_norm"):
        def lib():
            return F.rms_norm(x, (d,), w.to(xdt), NORM_EPS)
    out, ref = kern(), plain()
    torch.cuda.synchronize()
    # the fp32 computation's own error scale: |x| and |μ| (rounded before
    # the centring), times rstd and |w|, plus |b|
    xf = x.float()
    mu = xf.mean(-1, keepdim=True) if b is not None else torch.zeros_like(
        xf[:, :1])
    rstd = torch.rsqrt((xf - mu).square().mean(-1, keepdim=True) + NORM_EPS)
    scale = (xf.abs() + mu.abs()) * rstd * w.float().abs()
    if b is not None:
        scale += b.float().abs()
    del xf

    def within(y):
        """→ (inside the bound and finite, max abs error, worst
        error / bound) of the output y."""
        err = (y.float() - ref.float()).abs()
        if xdt == torch.bfloat16:
            bound = _bf16_ulp(torch.maximum(y.float().abs(),
                                            ref.float().abs())) \
                + 2.0 ** -16 * scale
        else:
            bound = RTOL_NORM_FP32 * (ref.abs() + scale)
        return (bool(torch.isfinite(y).all()) and bool((err <= bound).all()),
                float(err.max()), float((err / bound.clamp(min=1e-30)).max()))
    ok, max_err, worst = within(out)
    route = norms.rms_route(xdt, d, rows) if b is None else "layernorm"
    warp = None
    if route in ("block", "block_scalar") and d % 8 == 0 \
            and d <= norms.WARP_MAX_WIDTH:
        # the warp-per-row kernel at this width too, launched directly
        # (the route gives these rows to the block-per-row kernel)
        y = torch.empty_like(x)
        rc = norms._kernel("visrag_rmsnorm_warp")(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), rows, d,
            float(NORM_EPS), norms._IS_FP32[xdt], norms._IS_FP32[wdt],
            torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        warp = within(y) if rc == 0 else (False, None, None)
        ok = ok and warp[0]
        del y
    del scale
    item = x.element_size()
    nbytes = 2 * rows * d * item + (1 if b is None else 2) * d * \
        w.element_size()
    bound_ms, bound_by = _bound(0, nbytes)
    if rows <= 64:
        # host time per call (the decode step is host-bound)
        host = {"host_us": _host_us(kern), "plain_host_us": _host_us(plain)}
        if b is None:
            host["pr6_host_us"] = _host_us(block_kernel)
    else:
        host = {}
    # RMSNorm: the kernel rms_route picks and the block-per-row kernel in
    # turns (new, old, old, new)
    if b is None:
        ms, pr6_ms, turns = _turns(kern, block_kernel)
    else:
        ms, pr6_ms, turns = cuda_ms(kern), None, None
    rec = {"label": label, "kind": kind, "shape": [rows, d],
           "dtype": str(xdt).replace("torch.", ""),
           "weight_dtype": str(wdt).replace("torch.", ""),
           "route": route, "max_abs_err": max_err, "err_over_bound": worst,
           **({"warp_max_abs_err": warp[1], "warp_err_over_bound": warp[2]}
              if warp else {}),
           "ms": ms, "pr6_ms": pr6_ms, "turns": turns,
           "plain_ms": cuda_ms(plain),
           "library_ms": cuda_ms(lib) if lib is not None else None,
           "bound_ms": bound_ms, "bound_by": bound_by, **host}
    log(f"{phase} K7 {kind} {label} {rows} x {d} {rec['dtype']} (w "
        f"{rec['weight_dtype']}, {rec['route']}): max_abs_err {max_err:.3g}, "
        f"worst err/bound {worst:.3g}"
        + (f" (the warp-per-row kernel launched directly: max_abs_err "
           f"{warp[1]}, worst err/bound {warp[2]})" if warp else "")
        + f" | kernel {rec['ms']:.4f} ms"
        + (f" (block-per-row kernel in turns {pr6_ms:.4f} ms, {turns})"
           if pr6_ms is not None else "") + f", plain "
        f"{rec['plain_ms']:.4f} ms, library "
        + (f"{rec['library_ms']:.4f} ms" if lib is not None
           else "none (this torch has no F.rms_norm)")
        + f", bound {bound_ms:.4f} ms ({bound_by})"
        + (f" | host {host['host_us']:.1f} us per call, plain "
           f"{host['plain_host_us']:.1f} us" if host else "")
        + (f", block-per-row kernel {host['pr6_host_us']:.1f} us"
           if "pr6_host_us" in host else ""))
    if not ok:
        raise RuntimeError(f"K7 {kind} {label}: outside the bound "
                           f"(max_abs_err {max_err}, err/bound {worst}; the "
                           f"warp-per-row kernel launched directly: {warp})")
    return rec


def _check_norm_grads(gen, kind, rows, d):
    """Gradients of x, w (and b) through K7's autograd.Function against
    plain autograd on the same inputs and output gradient (the Function's
    backward is the plain version's recompute: equal to 1e-6 relative,
    and said whether bit for bit). → (rel_err, bitwise)."""
    from visrag_tpu_torch.ops import norms
    x = (torch.randn(rows, d, generator=gen, device=DEV) * 2).bfloat16()
    w = (1 + 0.3 * torch.randn(d, generator=gen, device=DEV)).bfloat16()
    b = (0.2 * torch.randn(d, generator=gen, device=DEV)).bfloat16()
    g = torch.randn(rows, d, generator=gen, device=DEV).bfloat16()
    grads = []
    for fn in ("kernel", "plain"):
        ins = [t.clone().requires_grad_(True)
               for t in ((x, w) if kind == "rms" else (x, w, b))]
        if fn == "kernel":
            y = norms._RowNorm.apply(*ins, None, NORM_EPS) \
                if kind == "rms" else norms._RowNorm.apply(*ins, NORM_EPS)
        else:
            y = norms.rmsnorm_reference(*ins, NORM_EPS) if kind == "rms" \
                else norms.layernorm_reference(*ins, NORM_EPS)
        grads.append(torch.autograd.grad(y, ins, g))
    num = math.sqrt(sum(float(((a.float() - c.float()) ** 2).sum())
                        for a, c in zip(*grads)))
    den = math.sqrt(sum(float((c.float() ** 2).sum()) for c in grads[1]))
    bitwise = all(torch.equal(a, c) for a, c in zip(*grads))
    log(f"[1b] K7 {kind} gradients through the autograd.Function at "
        f"{rows} x {d} bf16: rel_err {num / den:.3g} against plain "
        f"autograd, bit for bit {bitwise}")
    if not num / den <= 1e-6:
        raise RuntimeError(f"K7 {kind} gradients disagree: {num / den}")
    return num / den, bitwise


def phase1b_norm_kernel(gen):
    """K7 against its plain version at every shape of _norm_shapes, and its
    gradients. → {"rmsnorm": [check, ...], "layernorm": [...]}, each
    list's first record the path's main shape."""
    out = {"rmsnorm": [], "layernorm": []}
    for label, kind, rows, d, xdt, wdt in _norm_shapes():
        rec = _check_norm(gen, label, kind, rows, d, xdt, wdt)
        out["rmsnorm" if kind == "rms" else "layernorm"].append(rec)
        torch.cuda.empty_cache()
    for kind, d in (("rms", 2048), ("ln", 1152)):
        rel, bitwise = _check_norm_grads(gen, kind, 4096, d)
        out["rmsnorm" if kind == "rms" else "layernorm"][0].update(
            grad_rel_err=rel, grad_bitwise=bitwise)
    return out


def _lengths(mask):
    return [int(x) for x in mask.sum(axis=1)]


def phase2_kernel(gen, setup):
    """K1 without the LSE against the plain version at every shape the
    embedding path gives it, plus two edge-case shapes. → {form: [check,
    ...]}, page batch first."""
    from visrag_tpu_torch.ops import attention_lengths as al
    dev = "cuda"
    batches = setup["batches"]
    vit = setup["model"].cfg.backbone.vit
    lm = setup["model"].cfg.backbone.llm
    vit_h, vit_d = vit.num_heads, vit.head_dim
    lm_h, lm_d = lm.num_attention_heads, lm.head_dim
    flat = [(name, *raw["patch_mask"].shape, _lengths(raw["patch_mask"]))
            for name, raw in batches.items()]
    flat.append(("edge", 8, 1088, [1088, 1032, 600, 0, 1, 64, 65, 1000]))
    # lengths at the 128-row tiles' edges; S 1088 ends in a partial tile
    flat.append(("edge tiles", 10, 1088, [0, 1, 63, 64, 65, 127, 128, 129,
                                          1088, 1000]))
    stacked = [(name, *raw["attention_mask"].shape,
                _lengths(raw["attention_mask"]))
               for name, raw in batches.items()]
    stacked.append(("edge", 16, 576, [576, 500, 129, 64, 63, 1, 300, 576,
                                      200, 100, 50, 400, 450, 320, 10, 575]))
    results = {"flat": [], "stacked": []}
    for name, n, s, lens in flat:
        h, d = vit_h, vit_d
        qkv = torch.randn(n * s, 3 * h * d, generator=gen,
                          device=dev).bfloat16()
        lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        q, k, v = qkv.view(n, s, 3, h, d).unbind(2)
        kern = lambda: al.flash_fwd_lengths_flat(qkv, lens_t, n, s, h, d,
                                                 False, d ** -0.5)
        o_old = torch.empty(n, s, h, d, dtype=torch.bfloat16, device=dev)
        old = lambda: al._fwd(q, k, v, o_old, None, lens_t, False, d ** -0.5,
                              legacy=True)
        plain = lambda: al.lengths_attention_reference(
            q, k, v, lens_t, False, d ** -0.5).reshape(n * s, h * d)
        mask = _sdpa_mask(lens_t, s, False, dev)
        lib = lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, scale=d ** -0.5)
        valid = (torch.arange(s, device=dev)[None] < lens_t[:, None]) \
            .reshape(-1)
        results["flat"].append(_compare(
            f"ViT flat {name} n={n} S={s} H={h} d={d} lengths "
            f"{min(lens)}-{max(lens)}", kern, plain, lib, valid,
            attention_bound("fwd", lens, s, h, d, False), old))
        del qkv, q, k, v, kern, plain, lib, mask, old, o_old
    for name, b, s, lens in stacked:
        h, d = lm_h, lm_d
        q, k, v = (torch.randn(b, s, h, d, generator=gen,
                               device=dev).bfloat16() for _ in range(3))
        lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        kern = lambda: al.flash_fwd_lengths(q, k, v, lens_t, True, d ** -0.5)
        o_old = torch.empty_like(q)
        old = lambda: al._fwd(q, k, v, o_old, None, lens_t, True, d ** -0.5,
                              legacy=True)
        plain = lambda: al.lengths_attention_reference(q, k, v, lens_t, True,
                                                       d ** -0.5)
        mask = _sdpa_mask(lens_t, s, True, dev)
        lib = lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, scale=d ** -0.5)
        valid = torch.arange(s, device=dev)[None] < lens_t[:, None]
        results["stacked"].append(_compare(
            f"LM causal {name} B={b} S={s} H={h} d={d} lengths "
            f"{min(lens)}-{max(lens)}", kern, plain, lib, valid,
            attention_bound("fwd", lens, s, h, d, True), old))
        del q, k, v, kern, plain, lib, mask, old, o_old
    torch.cuda.empty_cache()
    _full_width_blocks(gen, batches["pages"])
    return results


def _compare(label, kern, plain, lib, valid, bound, old):
    """K1 (kern) against its plain version on the valid rows (ATOL_KERNEL),
    pad rows exactly 0; then timed in turns with the legacy mma.sync kernel
    (old), beside the plain version and SDPA (lib)."""
    out, ref = kern(), plain()
    torch.cuda.synchronize()
    if not torch.isfinite(out.float()).all():
        raise RuntimeError(f"{label}: kernel output not finite")
    diff = (out.float() - ref.float()).abs()[valid]
    err = diff.max().item() if diff.numel() else 0.0
    pad_zero = bool((out[~valid] == 0).all())
    del out, ref, diff
    ms, pr1_ms, turns = _turns(kern, old)
    plain_ms, lib_ms = cuda_ms(plain), cuda_ms(lib)
    log(f"[2] K1 {label}: max_abs_err {err:.6g} (bound {ATOL_KERNEL}), pad "
        f"rows exactly 0 {pad_zero} | kernel {ms:.4f} ms (legacy mma.sync "
        f"kernel in turns {pr1_ms:.4f} ms, {turns}), plain {plain_ms:.4f} "
        f"ms, SDPA {lib_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}) "
        f"(medians in bursts of 10, CUDA events) | {smi()}")
    if err > ATOL_KERNEL or not pad_zero:
        raise RuntimeError(f"{label}: kernel disagrees with plain ({err}, "
                           f"pad rows exactly 0 {pad_zero})")
    return {"shape": label, "max_abs_err": err, "ms": ms, "pr1_ms": pr1_ms,
            "turns": turns, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound[0], "bound_by": bound[1]}


def _rel_err(out, ref, valid):
    a, b = out.float().cpu()[valid], ref[valid]
    return (torch.linalg.norm(a - b) / torch.linalg.norm(b)).item()


def _full_width_blocks(gen, raw_pages):
    """One ViT block at the page batch's patch bucket and one LM layer at
    its token batch, each on the batch's longest and shortest row."""
    from visrag_tpu_torch.driver.common import init_weights_
    from visrag_tpu_torch.models.minicpm import (MiniCPMConfig,
                                                 MiniCPMDecoderLayer,
                                                 rope_inv_freq)
    from visrag_tpu_torch.models.siglip_vit import SiglipViTConfig, ViTBlock

    def ends(mask):
        lens = _lengths(mask)
        return torch.tensor([max(lens), min(lens)], dtype=torch.int32)

    vcfg = SiglipViTConfig()
    with torch.device("cuda"):
        block = ViTBlock(vcfg)
    init_weights_(block, gen)
    s = raw_pages["patch_mask"].shape[1]
    lens = ends(raw_pages["patch_mask"])
    x = torch.randn(2, s, vcfg.embed_dim, generator=gen, device="cuda")
    with torch.inference_mode():
        out = block(x.bfloat16(), lens.cuda())
        ref = copy.deepcopy(block).float().cpu()(x.cpu(), lens)
    e_vit = _rel_err(out, ref, torch.arange(s)[None] < lens[:, None])
    vit_label = f"S={s} lengths {lens.tolist()}"

    lcfg = MiniCPMConfig()
    with torch.device("cuda"):
        layer = MiniCPMDecoderLayer(lcfg)
    init_weights_(layer, gen)
    s = raw_pages["attention_mask"].shape[1]
    lens = ends(raw_pages["attention_mask"])
    x = torch.randn(2, s, lcfg.hidden_size, generator=gen, device="cuda")
    pos = torch.arange(s).expand(2, s)
    with torch.inference_mode():
        out = layer(x.bfloat16(), pos.cuda(), lens.cuda(),
                    rope_inv_freq(lcfg, s, lens, "cuda"))
        ref = copy.deepcopy(layer).float().cpu()(
            x.cpu(), pos, lens, rope_inv_freq(lcfg, s, lens, "cpu"))
    e_lm = _rel_err(out, ref, torch.arange(s)[None] < lens[:, None])
    log(f"[2] full-width blocks, bf16 kernel on the card vs fp32 plain on "
        f"the CPU: ViT block ({vit_label}) rel_err {e_vit:.3g}, LM layer "
        f"(S={s} lengths {lens.tolist()}) rel_err {e_lm:.3g} (bound "
        f"{RTOL_BLOCK})")
    if max(e_vit, e_lm) > RTOL_BLOCK:
        raise RuntimeError("full-width block disagrees with its fp32 plain "
                           "version")


def _pages(seed):
    import numpy as np
    from PIL import Image
    rng = np.random.default_rng(seed)
    pages = []
    for i in range(N_PAGES):
        w, h = PAGE_SIZES[i % len(PAGE_SIZES)]
        pages.append(("", Image.fromarray(
            rng.integers(0, 255, (h, w, 3), dtype=np.uint8))))
    return pages


def _queries(n):
    return [(f"Represent this query for retrieving relevant documents: "
             f"what does page {i} report for quarter {i % 4 + 1}?", None)
            for i in range(n)]


def phase3_setup():
    """The full-width model, the raw page and query batches of the
    embedding path, and the training micro-batch (host work only, before
    phases 2 and 4 take the batches' shapes)."""
    from visrag_tpu_torch.config import ModelConfig
    from visrag_tpu_torch.driver.common import build_visrag_ret
    from visrag_tpu_torch.preprocess import (MockTokenizer,
                                             build_encode_batch,
                                             pick_patch_bucket)

    t0 = time.perf_counter()
    model, pcfg = build_visrag_ret(ModelConfig(), device="cuda", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tok = MockTokenizer()
    pages = _pages(0)
    # bench.py's batch shape: the patch bucket this mix needs, and the token
    # batch cut from the 768 cap to the longest prompt (64-multiple)
    page_cfg = dataclasses.replace(pcfg, seq_len=768, seq_auto=True,
                                   max_patches=pick_patch_bucket(pages, pcfg))
    query_cfg = dataclasses.replace(pcfg, seq_len=512, seq_auto=True,
                                    max_patches=pick_patch_bucket([], pcfg))
    t0 = time.perf_counter()
    raw_pages = build_encode_batch(tok, pages, page_cfg, device_mode=True)
    host_s = time.perf_counter() - t0
    raw_queries = build_encode_batch(tok, _queries(N_QUERIES), query_cfg,
                                     device_mode=True)
    # the training driver's batches: PipelineConfig as built, token batches
    # cut to the longest prompt, pages in a fixed 10-slot-per-page buffer
    train_cfg = dataclasses.replace(pcfg, seq_auto=True)

    def train_batch(n_pairs):
        return (build_encode_batch(tok, _queries(n_pairs), train_cfg,
                                   device_mode=True),
                build_encode_batch(tok, pages[:n_pairs], train_cfg,
                                   n_slice_slots=n_pairs *
                                   train_cfg.max_slices_per_page,
                                   device_mode=True))
    return {"model": model, "pcfg": pcfg, "init_s": init_s, "tok": tok,
            "pages": pages, "host_s": host_s, "train_batch": train_batch,
            "batches": {"pages": raw_pages, "queries": raw_queries}}


def _with_plain_norms(fn):
    """fn() with every RMSNorm / LayerNorm of the port run as its plain
    PyTorch version (the fp32 elementwise chain) instead of K7."""
    from visrag_tpu_torch.ops import norms
    rms, ln = norms.rmsnorm, norms.layernorm
    norms.rmsnorm = lambda x, w, eps=1e-5: norms.rmsnorm_reference(x, w, eps)
    norms.layernorm = lambda x, w, b, eps=1e-6: \
        norms.layernorm_reference(x, w, b, eps)
    try:
        return fn()
    finally:
        norms.rmsnorm, norms.layernorm = rms, ln


def phase3_slice(setup):
    import numpy as np

    from visrag_tpu_torch.ops import attention_lengths as al
    from visrag_tpu_torch.ops import norms
    from visrag_tpu_torch.preprocess.device import (finish_encode_batch,
                                                    pos_table_tensor)
    from visrag_tpu_torch.retrieval import evaluate_run
    from visrag_tpu_torch.retrieval.encode import encode_dataset
    from visrag_tpu_torch.retrieval.search import StreamingSearcher, build_run

    model = setup["model"]
    raw_pages = setup["batches"]["pages"]
    raw_queries = setup["batches"]["queries"]
    n_params = sum(p.numel() for p in model.parameters())
    table = pos_table_tensor(setup["pcfg"].src_grid, "cuda")
    n_slices = int(raw_pages["patch_mask"].any(axis=1).sum())

    @torch.inference_mode()
    def step(**raw):
        return model(finish_encode_batch(raw, table))

    step(**raw_pages)                     # warm-up batch (not counted)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    al.reset_launch_counts()
    norms.reset_launch_counts()
    page_ids = [f"p{i}" for i in range(N_PAGES)]
    query_ids = [f"q{i}" for i in range(N_QUERIES)]
    t0 = time.perf_counter()
    _, page_reps = encode_dataset(step, [(page_ids, raw_pages)])
    _, query_reps = encode_dataset(step, [(query_ids, raw_queries)])
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    launches = al.launch_counts()
    _lengths_routes("[3]", launches)
    norm_launches = norms.launch_counts()
    n_batches = 2
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    vit_depth = model.cfg.backbone.vit.depth
    lm_depth = model.cfg.backbone.llm.num_hidden_layers
    if launches != {"flat": vit_depth * n_batches,
                    "stacked": lm_depth * n_batches, "fwd_lse": 0, "dq": 0,
                    "dkv": 0}:
        raise RuntimeError(f"kernel launches {launches} != "
                           f"{vit_depth}+{lm_depth} per encode batch")
    # K7 per encode batch: the ViT's two LayerNorms a layer and its final
    # one, the resampler's ln_kv, ln_q and ln_post; the LM's two RMSNorms
    # a layer and its final one
    want_norms = {"layernorm": n_batches * (2 * vit_depth + 1 + 3),
                  "rmsnorm": n_batches * (2 * lm_depth + 1)}
    if norm_launches != want_norms:
        raise RuntimeError(f"K7 launches {norm_launches} != {want_norms}")
    launches = {**launches, **norm_launches}
    for name, reps, n in (("pages", page_reps, N_PAGES),
                          ("queries", query_reps, N_QUERIES)):
        if reps.shape != (n, model.cfg.backbone.llm.hidden_size):
            raise RuntimeError(f"{name}: embeddings shape {reps.shape}")
        if not np.isfinite(reps).all():
            raise RuntimeError(f"{name}: non-finite embeddings")
        lengths = np.linalg.norm(reps, axis=1)
        if not np.allclose(lengths, 1.0, atol=1e-3):
            raise RuntimeError(f"{name}: not unit norm ({lengths})")

    searcher = StreamingSearcher(k=10, device="cuda")
    s_self, i_self = searcher.search(page_reps, [(page_reps[:8], 0),
                                                 (page_reps[8:], 8)])
    if not (i_self[:, 0] == np.arange(N_PAGES)).all():
        raise RuntimeError(f"self-retrieval failed: top-1 {i_self[:, 0]}")
    t0 = time.perf_counter()
    scores, idx = searcher.search(query_reps, [(page_reps, 0)])
    search_ms = (time.perf_counter() - t0) * 1e3
    run = build_run(scores, idx, query_ids, page_ids)
    qrels = {q: {f"p{i}": 1} for i, q in enumerate(query_ids)}
    metrics = evaluate_run(run, qrels, k=10)
    if len(run) != N_QUERIES or any(len(v) != 10 for v in run.values()):
        raise RuntimeError("retrieval run is incomplete")

    # steady-state device time of one page batch (finish + encode), after
    # the warm-up above
    reps_ms = cuda_ms(lambda: step(**raw_pages), reps=3)
    pages_s = N_PAGES / (reps_ms / 1e3)
    # the same batch with every norm as the plain fp32 chain (what the
    # models ran before K7) and with K7, in turns
    turns = [(which, _with_plain_norms(
        lambda: cuda_ms(lambda: step(**raw_pages), reps=3))
        if which == "plain" else cuda_ms(lambda: step(**raw_pages), reps=3))
        for which in ("plain", "K7", "K7", "plain")]
    log(f"[3] VisRAG-Ret full width bf16, {n_params / 1e9:.3f}B params "
        f"(init {setup['init_s']:.1f} s): {N_PAGES} pages = {n_slices} "
        f"slices at patch bucket {raw_pages['patch_mask'].shape[1]}, token "
        f"batch "
        f"{raw_pages['input_ids'].shape[1]}; {N_QUERIES} queries at "
        f"{raw_queries['input_ids'].shape[1]} tokens | host preprocess "
        f"{setup['host_s']:.2f} s/page batch | encode_dataset pages+queries "
        f"{e2e_s:.2f} s | kernel launches {launches} over {n_batches} "
        f"batches | self-retrieval top-1 ok | query top-10 search "
        f"{search_ms:.2f} ms | metrics (random weights) "
        f"{json.dumps(metrics)}")
    log(f"[3] steady state: {reps_ms:.1f} ms per {N_PAGES}-page batch = "
        f"{pages_s:.2f} pages/s | in turns, ms per batch with the norms as "
        f"plain fp32 chains vs K7: "
        f"{', '.join(f'{w} {ms:.1f}' for w, ms in turns)} | peak memory "
        f"{peak_gb:.2f} GB | {smi()}")
    setup["reps"] = (page_reps, query_reps)
    return launches


PEAK_INT8_OPS = 1979e12   # H100 SXM dense int8
INT8_REPLACES = "visrag_tpu/ops/matmul_int8.py:34"


def int8_gemm_bound(m, k, n):
    """Least time of one K6 call: 2MKN int8 operations over the int8 peak,
    or the bytes (xq, wq, the fp32 scales and bias read once, the bf16
    output written once) over the memory rate."""
    t_ops = 2 * m * k * n / PEAK_INT8_OPS
    t_bytes = (m * k + n * k + 4 * m + 8 * n + 2 * m * n) / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"


def _check_int8_gemm(gen, label, m, k, n, bias, timed=True,
                     out_dtype=torch.bfloat16):
    """K6 (the Hopper kernel) against its plain version at one shape (bf16
    unit-normal activations and 0.03-scaled weights, quantized as the model
    does): the int32 product is exact on both sides and the epilogue rounds
    in the same order, so every output must be bit-equal. timed: the kernel
    in turns with the mma.sync kernel it replaced (new, old, old, new:
    pr5_ms),
    the plain version, torch._int_mm alone (the int32 product, no
    epilogue: int_mm_ms) and torch._int_mm + scaling (the same function:
    library_ms), and the bound."""
    from visrag_tpu_torch.ops import matmul_int8 as mi
    from visrag_tpu_torch.ops import quant
    x = torch.randn(m, k, generator=gen, device=DEV).bfloat16()
    w = (torch.randn(n, k, generator=gen, device=DEV) * 0.03).bfloat16()
    b = torch.randn(n, generator=gen, device=DEV) if bias else None
    xq, xs = quant.quant_rowwise(x)
    wq, ws = quant.quant_weight_colwise(w.t())
    wq = wq.t().contiguous()
    xs = xs[:, 0].contiguous()
    kern = lambda: mi.int8_matmul_fused(xq, xs, wq, ws, b, out_dtype)
    plain = lambda: mi.int8_matmul_reference(xq, xs, wq, ws, b, out_dtype)
    out, ref = kern(), plain()
    torch.cuda.synchronize()
    equal = torch.equal(out, ref)
    finite = bool(torch.isfinite(out.float()).all())
    max_abs = (out.float() - ref.float()).abs().max().item()
    del out, ref
    shape = (f"{label} {m} x {k} -> {n}"
             + (", fp32 output" if out_dtype == torch.float32 else ""))
    log(f"[3b] K6 {shape}: bit-equal to the plain version {equal} "
        f"(max_abs_err {max_abs:.4g}), finite {finite}")
    if not (equal and finite):
        raise RuntimeError(f"K6 {shape}: the kernel's outputs are not the "
                           f"plain version's bit for bit")
    record = {"shape": shape, "max_abs_err": max_abs}
    if not timed:
        return record
    ms, pr5_ms, turns = _turns(kern, lambda: mi.int8_matmul_fused(
        xq, xs, wq, ws, b, legacy=True))
    plain_ms = cuda_ms(plain, reps=3)
    int_mm_ms = cuda_ms(lambda: torch._int_mm(xq, wq.t()))

    def library():
        y = torch._int_mm(xq, wq.t()).float() * xs[:, None] * ws[None, :]
        return (y if b is None else y + b[None, :]).to(torch.bfloat16)
    lib_ms = cuda_ms(library)
    bound = int8_gemm_bound(m, k, n)
    log(f"[3b] K6 {shape}: kernel {ms:.4f} ms "
        f"({2 * m * k * n / ms / 1e9:.1f} TOP/s; turns {turns}), the mma.sync "
        f"kernel {pr5_ms:.4f} ms, plain {plain_ms:.4f} ms, torch._int_mm "
        f"alone {int_mm_ms:.4f} ms, + scaling {lib_ms:.4f} ms, bound "
        f"{bound[0]:.4f} ms ({bound[1]}) (CUDA events) | {smi()}")
    return {**record, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "pr5_ms": pr5_ms,
            "int_mm_ms": int_mm_ms, "turns": turns}


def phase3b_int8_encode(gen, setup):
    """K6 at the int8 encode's four GEMM shapes, then the full-width encode
    with quant="int8" in the ViT and the LM on phase 3's weights: the same
    page and query batches through encode_dataset, 292 K6 launches per
    batch, per-page cosine against phase 3's bf16 embeddings, the top-10
    overlap of the query rankings, pages/s beside bf16 and peak memory.
    → (K6 check records, launch counts of the encode)."""
    import numpy as np

    from visrag_tpu_torch.models.visrag_ret import VisRAGRet
    from visrag_tpu_torch.ops import attention_lengths as al
    from visrag_tpu_torch.ops import matmul_int8 as mi
    from visrag_tpu_torch.preprocess.device import (finish_encode_batch,
                                                    pos_table_tensor)
    from visrag_tpu_torch.retrieval.encode import encode_dataset
    from visrag_tpu_torch.retrieval.search import StreamingSearcher

    model = setup["model"]
    bb = model.cfg.backbone
    raw_pages = setup["batches"]["pages"]
    raw_queries = setup["batches"]["queries"]
    m_vit = raw_pages["patch_mask"].size
    m_lm = raw_pages["input_ids"].size
    e, hid = bb.vit.embed_dim, bb.llm.hidden_size
    checks = []
    for label, m, k, n, bias in (
            ("ViT qkv", m_vit, e, 3 * e, True),
            ("ViT fc1", m_vit, e, bb.vit.mlp_dim, True),
            ("LM q/k/v/o", m_lm, hid, hid, False),
            ("LM gate/up", m_lm, hid, bb.llm.intermediate_size, False)):
        checks.append(_check_int8_gemm(gen, label, m, k, n, bias))
        torch.cuda.empty_cache()
    # edges: an odd N, N = 1, M = 1, K off the 16-byte unit (padded on the
    # host), and fp32 output
    for label, m, k, n, bias, dt in (
            ("odd N", 333, e, 4305, True, torch.bfloat16),
            ("N = 1", 130, 256, 1, True, torch.bfloat16),
            ("M = 1", 1, hid, hid, False, torch.bfloat16),
            ("K off 16", 129, 1000, 257, True, torch.bfloat16),
            ("LM q/k/v/o", m_lm, hid, hid, False, torch.float32)):
        checks.append(_check_int8_gemm(gen, label, m, k, n, bias,
                                       timed=False, out_dtype=dt))

    # ops/quant.quant_rowwise divides by a tensor, not by a Python scalar
    # (which PyTorch's CUDA kernels turn into a reciprocal multiply): the
    # card's codes and scales of an activation are the CPU's bit for bit
    from visrag_tpu_torch.ops.quant import quant_rowwise
    act = (torch.randn(m_vit, e, generator=gen, device=DEV) * torch.rand(
        m_vit, 1, generator=gen, device=DEV) * 8).to(torch.bfloat16)
    codes, scales = quant_rowwise(act)
    codes_cpu, scales_cpu = quant_rowwise(act.cpu())
    same = torch.equal(codes.cpu(), codes_cpu) and \
        torch.equal(scales.cpu(), scales_cpu)
    log(f"[3b] quant_rowwise on a ViT activation ({m_vit} x {e} bf16): "
        f"codes and scales on the card bit-equal to the CPU's {same}")
    if not same:
        raise RuntimeError("quant_rowwise: the card's codes differ from the "
                           "CPU's")
    del act, codes, scales

    # inference only: the int8 configs refuse remat, which the driver's
    # ModelConfig turns on for training
    cfg = dataclasses.replace(model.cfg, backbone=dataclasses.replace(
        bb, vit=dataclasses.replace(bb.vit, quant="int8", remat=False),
        llm=dataclasses.replace(bb.llm, quant="int8", remat=False)))
    with torch.device("meta"):
        qmodel = VisRAGRet(cfg)
    qmodel = qmodel.to_empty(device=DEV)
    qmodel.load_state_dict(model.state_dict())
    qmodel.eval()
    table = pos_table_tensor(setup["pcfg"].src_grid, DEV)

    def stepper(m):
        @torch.inference_mode()
        def step(**raw):
            return m(finish_encode_batch(raw, table))
        return step
    step, bstep = stepper(qmodel), stepper(model)
    step(**raw_pages)                     # warm-up (codes built, not counted)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    al.reset_launch_counts()
    mi.reset_launch_counts()
    page_ids = [f"p{i}" for i in range(N_PAGES)]
    query_ids = [f"q{i}" for i in range(N_QUERIES)]
    t0 = time.perf_counter()
    _, page_reps = encode_dataset(step, [(page_ids, raw_pages)])
    _, query_reps = encode_dataset(step, [(query_ids, raw_queries)])
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {**al.launch_counts(), "int8_gemm": mi.launches}
    _lengths_routes("[3b]", launches)
    if mi.route_counts() != {"hopper": mi.launches, "legacy": 0}:
        raise RuntimeError(f"K6 launches by route {mi.route_counts()}: want "
                           f"all {mi.launches} on the Hopper kernel")
    per_batch = 2 * bb.vit.depth + 6 * bb.llm.num_hidden_layers
    want = {"flat": 2 * bb.vit.depth, "stacked": 2 * bb.llm.num_hidden_layers,
            "fwd_lse": 0, "dq": 0, "dkv": 0, "int8_gemm": 2 * per_batch}
    if launches != want:
        raise RuntimeError(f"int8 encode launches {launches} != {want}")
    bf_pages, bf_queries = setup["reps"]
    if page_reps.shape != bf_pages.shape or not np.isfinite(page_reps).all() \
            or not np.isfinite(query_reps).all():
        raise RuntimeError("int8 embeddings: wrong shape or not finite")
    cos_p = (page_reps * bf_pages).sum(1)
    cos_q = (query_reps * bf_queries).sum(1)
    searcher = StreamingSearcher(k=10, device="cuda")
    _, i8 = searcher.search(query_reps, [(page_reps, 0)])
    _, ibf = searcher.search(bf_queries, [(bf_pages, 0)])
    overlap = [len(set(a) & set(b)) / 10 for a, b in zip(i8, ibf)]
    # steady state, bf16 and int8 in turns on the same batch
    times = {"bf16": [], "int8": []}
    for name, fn in (("bf16", bstep), ("int8", step), ("int8", step),
                     ("bf16", bstep)):
        times[name].append(cuda_ms(lambda: fn(**raw_pages), reps=3))
    ms = {k: statistics.mean(v) for k, v in times.items()}
    log(f"[3b] VisRAG-Ret full width, quant=int8 (ViT qkv + fc1, LM q/k/v/o "
        f"+ gate/up through K6), phase 3's weights: encode_dataset pages + "
        f"queries {e2e_s:.2f} s | launches {launches} (= {per_batch} K6 per "
        f"batch, every one on the Hopper kernel {mi.SOURCE}) | per-page "
        f"cosine to bf16 min {cos_p.min():.5f} mean "
        f"{cos_p.mean():.5f}, per-query min {cos_q.min():.5f} | query top-10 "
        f"overlap with bf16 mean {statistics.mean(overlap):.3f} min "
        f"{min(overlap):.1f} | steady state {ms['int8']:.1f} ms per "
        f"{N_PAGES}-page batch = {N_PAGES / ms['int8'] * 1e3:.2f} pages/s "
        f"(bf16 in the same turns {ms['bf16']:.1f} ms = "
        f"{N_PAGES / ms['bf16'] * 1e3:.2f} pages/s) | peak memory "
        f"{peak_gb:.2f} GB | {smi()}")
    if cos_p.min() < 0.99:
        raise RuntimeError(f"int8 page embeddings drift from bf16: cosine "
                           f"{cos_p.min()}")
    del qmodel, step
    gc.collect()
    torch.cuda.empty_cache()
    return checks, launches


def _rel(a, b):
    a, b = a.float(), b.float()
    nb = torch.linalg.norm(b).item()
    return torch.linalg.norm(a - b).item() / nb if nb else \
        torch.linalg.norm(a).item()


def phase4_training_kernels(gen, setup):
    """K1 + LSE and K2 against the plain forward and autograd at the
    training step's shapes. → {"fwd_lse": [...], "dq": [...], "dkv": [...]},
    the micro-batch's ViT page shape first."""
    from visrag_tpu_torch.ops import attention_lengths as al
    dev = "cuda"
    cfg = setup["model"].cfg.backbone
    vh, vd = cfg.vit.num_heads, cfg.vit.head_dim
    lh, ld = cfg.llm.num_attention_heads, cfg.llm.head_dim
    raw_q, raw_p = setup["train_batch"](MICRO)
    shapes = [
        ("ViT flat, training pages", "flat", raw_p["patch_mask"], vh, vd,
         False),
        ("ViT flat, training queries", "flat", raw_q["patch_mask"], vh, vd,
         False),
        ("ViT flat, edge", "flat", [0, 1, 63, 64, 65, 127, 128, 129, 1152],
         vh, vd, False),
        ("ViT flat, edge, causal", "flat", [0, 1, 63, 64, 65, 127, 128, 129,
                                            300], vh, vd, True),
        ("LM causal, training pages", "stacked", raw_p["attention_mask"], lh,
         ld, True),
        ("LM causal, training queries", "stacked", raw_q["attention_mask"],
         lh, ld, True),
        ("LM causal, edge", "stacked", [0, 1, 63, 64, 65, 127, 128, 129, 704],
         lh, ld, True),
        ("LM stacked, edge, bidirectional", "stacked",
         [0, 1, 63, 64, 65, 127, 128, 129, 700], lh, ld, False),
    ]
    results = {"fwd_lse": [], "dq": [], "dkv": []}
    for label, form, mask, h, d, causal in shapes:
        if isinstance(mask, list):
            lens, s = mask, max(mask)
        else:
            lens, s = _lengths(mask), mask.shape[1]
        for kind, check in _check_training_kernels(
                al, label, form, lens, s, h, d, causal, gen, dev).items():
            results[kind].append(check)
        torch.cuda.empty_cache()
    return results


def _check_training_kernels(al, label, form, lens, s, h, d, causal, gen,
                            dev, kv_heads=None, tag="[4]"):
    """K1 + LSE, K2 dq and K2 dk/dv at one shape against the plain forward
    and its autograd; kv_heads (stacked form): grouped kv heads, whose
    gradients the kernel sums over each group. → {kind: record}."""
    b, scale = len(lens), d ** -0.5
    hk = kv_heads or h
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    valid = torch.arange(s, device=dev)[None] < lens_t[:, None]   # (b, s)
    if form == "flat":
        qkv = torch.randn(b * s, 3 * h * d, generator=gen,
                          device=dev).bfloat16()
        q, k, v = qkv.view(b, s, 3, h, d).unbind(2)
        o = torch.empty(b * s, h * d, dtype=torch.bfloat16,
                        device=dev).view(b, s, h, d)
        grads = torch.empty_like(qkv).view(b, s, 3, h, d).unbind(2)
        x_ref = qkv.clone().requires_grad_(True)
        ref_in = x_ref.view(b, s, 3, h, d).unbind(2)
        ref_leaves = (x_ref,)
    else:
        q, k, v = (torch.randn(b, s, heads, d, generator=gen,
                               device=dev).bfloat16()
                   for heads in (h, hk, hk))
        o = torch.empty_like(q)
        grads = tuple(torch.empty_like(t) for t in (q, k, v))
        ref_in = ref_leaves = tuple(t.clone().requires_grad_(True)
                                    for t in (q, k, v))
    do = torch.randn(b, s, h, d, generator=gen, device=dev).bfloat16()
    delta = torch.empty(b, h, s, dtype=torch.float32, device=dev)
    dq, dk, dv = grads

    lse = al.flash_fwd_lse(q, k, v, lens_t, causal, scale, o)
    al.flash_bwd_dq(q, k, v, o, do, lse, delta, lens_t, causal, scale, dq)
    al.flash_bwd_dkv(q, k, v, o, do, lse, delta, lens_t, causal, scale, dk,
                     dv)
    o_ref = al.lengths_attention_reference(*ref_in, lens_t, causal, scale)
    g_ref = torch.autograd.grad(o_ref, ref_leaves, do, retain_graph=True)
    if form == "flat":
        g_ref = g_ref[0].view(b, s, 3, h, d).unbind(2)
    lse_ref = al.lengths_lse_reference(q, k, lens_t, causal, scale)
    torch.cuda.synchronize()

    vm = valid[:, None, :].expand(b, h, s)
    torch.cuda.synchronize()
    errs = {"o": _rel(o[valid], o_ref[valid]) if valid.any() else 0.0,
            "lse_max_abs": (lse[vm] - lse_ref[vm]).abs().max().item()
            if valid.any() else 0.0}
    for name, got, want in zip(("dq", "dk", "dv"), grads, g_ref):
        errs[name] = _rel(got[valid], want[valid]) if valid.any() else 0.0
    max_abs = {name: (got[valid].float() - want[valid].float()).abs().max()
               .item() if valid.any() else 0.0
               for name, got, want in zip(("o", "dq", "dk", "dv"),
                                          (o, *grads), (o_ref, *g_ref))}
    pad = ~valid
    zeros_ok = all(bool((t[pad] == 0).all()) for t in (o, *grads)) and \
        bool((lse[~vm] == al.LSE_PAD).all())
    finite = all(bool(torch.isfinite(t.float()).all())
                 for t in (o, lse[vm], *grads))
    if max(errs[k] for k in ("o", "dq", "dk", "dv")) > RTOL_TRAIN \
            or errs["lse_max_abs"] > RTOL_TRAIN or not zeros_ok \
            or not finite:
        raise RuntimeError(f"{label}: K1+LSE / K2 disagree with the plain "
                           f"version: {errs}, zeros where the contract says "
                           f"{zeros_ok}, finite {finite}")

    # timings: kernels (K1 + LSE in turns with the legacy mma.sync kernel),
    # plain forward and backward (retained graph), SDPA
    o_old, lse_old = torch.empty_like(o), torch.empty_like(lse)
    t_fwd, t_fwd_old, fwd_turns = _turns(
        lambda: al.flash_fwd_lse(q, k, v, lens_t, causal, scale, o),
        lambda: al._fwd(q, k, v, o_old, lse_old, lens_t, causal, scale,
                        legacy=True))
    del o_old, lse_old
    # K2 in turns with PR 5's mma.sync kernels (legacy=True: outputs of
    # their own, counted on the legacy route only)
    dq_old, delta_old = torch.empty_like(dq), torch.empty_like(delta)
    dk_old, dv_old = torch.empty_like(dk), torch.empty_like(dv)
    t_dq, t_dq_old, dq_turns = _turns(
        lambda: al.flash_bwd_dq(q, k, v, o, do, lse, delta, lens_t, causal,
                                scale, dq),
        lambda: al._bwd("dq", q, k, v, o, do, lse, delta_old, lens_t, causal,
                        scale, dq_old, k, v, legacy=True))
    t_dkv, t_dkv_old, dkv_turns = _turns(
        lambda: al.flash_bwd_dkv(q, k, v, o, do, lse, delta, lens_t, causal,
                                 scale, dk, dv),
        lambda: al._bwd("dkv", q, k, v, o, do, lse, delta_old, lens_t,
                        causal, scale, q, dk_old, dv_old, legacy=True))
    del dq_old, delta_old, dk_old, dv_old
    t_plain_fwd = cuda_ms(lambda: al.lengths_attention_reference(
        q, k, v, lens_t, causal, scale))
    t_plain_bwd = cuda_ms(lambda: torch.autograd.grad(
        o_ref, ref_leaves, do, retain_graph=True))
    del o_ref, g_ref
    mask = _sdpa_mask(lens_t, s, causal, dev)
    sq, sk, sv = (t.detach().transpose(1, 2).requires_grad_(True)
                  for t in (q, k, v))
    gqa = hk != h
    t_sdpa_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
        sq, sk, sv, attn_mask=mask, scale=scale, enable_gqa=gqa))
    o_sdpa = F.scaled_dot_product_attention(sq, sk, sv, attn_mask=mask,
                                            scale=scale, enable_gqa=gqa)
    do_t = do.transpose(1, 2)
    t_sdpa_bwd = cuda_ms(lambda: torch.autograd.grad(
        o_sdpa, (sq, sk, sv), do_t, retain_graph=True))
    del o_sdpa

    heads = f"{h}/{hk}" if gqa else f"{h}"
    shape = (f"{label} B={b} S={s} H={heads} d={d} lengths "
             f"{min(lens)}-{max(lens)}")
    out = {}
    for kind, ms, plain_ms, lib_ms, err in (
            ("fwd_lse", t_fwd, t_plain_fwd, t_sdpa_fwd,
             max(errs["o"], errs["lse_max_abs"])),
            ("dq", t_dq, t_plain_bwd, t_sdpa_bwd, errs["dq"]),
            ("dkv", t_dkv, t_plain_bwd, t_sdpa_bwd,
             max(errs["dk"], errs["dv"]))):
        bound_ms, bound_by = attention_bound(kind, lens, s, h, d, causal,
                                             kv_heads=hk)
        out[kind] = {"shape": shape, "head_dim": d, "ms": ms,
                     "plain_ms": plain_ms,
                     "library_ms": lib_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by,
                     "max_abs_err": {"fwd_lse": max_abs["o"],
                                     "dq": max_abs["dq"],
                                     "dkv": max(max_abs["dk"],
                                                max_abs["dv"])}[kind],
                     "rel_err": err}
    out["fwd_lse"].update(pr1_ms=t_fwd_old, turns=fwd_turns)
    out["dq"].update(pr5_ms=t_dq_old, turns=dq_turns)
    out["dkv"].update(pr5_ms=t_dkv_old, turns=dkv_turns)
    log(f"{tag} {shape}: rel_err o {errs['o']:.4g} dq {errs['dq']:.4g} dk "
        f"{errs['dk']:.4g} dv {errs['dv']:.4g}, LSE max abs "
        f"{errs['lse_max_abs']:.4g} (bound {RTOL_TRAIN}); pad rows zero, "
        f"finite | ms: K1+LSE {t_fwd:.4f} (legacy mma.sync kernel in turns "
        f"{t_fwd_old:.4f}, {fwd_turns}), dq {t_dq:.4f} (legacy in turns "
        f"{t_dq_old:.4f}, {dq_turns}), dk/dv {t_dkv:.4f} (legacy "
        f"{t_dkv_old:.4f}, {dkv_turns}); dq + dk/dv {t_dq + t_dkv:.4f} vs "
        f"SDPA bwd {t_sdpa_bwd:.4f}: "
        f"{'faster' if t_dq + t_dkv < t_sdpa_bwd else 'SLOWER'} "
        f"| plain fwd {t_plain_fwd:.4f}, plain bwd {t_plain_bwd:.4f} | SDPA "
        f"fwd {t_sdpa_fwd:.4f}, bwd {t_sdpa_bwd:.4f} | bound fwd_lse "
        f"{out['fwd_lse']['bound_ms']:.4f}, dq {out['dq']['bound_ms']:.4f}, "
        f"dkv {out['dkv']['bound_ms']:.4f} ms (medians in bursts of 10, "
        f"CUDA events) | "
        f"{smi()}")
    return out


def _write_train_parquet(path, pages, n):
    import pyarrow as pa
    import pyarrow.parquet as pq
    images = []
    for _, img in pages[:n]:
        buf = io.BytesIO()
        img.save(buf, format="PNG", compress_level=1)
        images.append({"bytes": buf.getvalue()})
    pq.write_table(pa.table({
        "query": [f"what does page {i} report for quarter {i % 4 + 1}?"
                  for i in range(n)],
        "image": images}), path)


def _grad_list(params):
    return [p.grad.detach().clone() for p in params]


def phase5_training(setup):
    """The training slice at full width through train_retriever.main, the
    checkpoint read back, GradCache against direct grads, and the loss on a
    fixed batch before and after three steps."""
    import numpy as np

    from visrag_tpu_torch.config import TrainConfig
    from visrag_tpu_torch.driver import train_retriever
    from visrag_tpu_torch.ops import attention_lengths as al
    from visrag_tpu_torch.preprocess import build_encode_batch
    from visrag_tpu_torch.preprocess.device import (finish_encode_batch,
                                                    pos_table_tensor)
    from visrag_tpu_torch.training.checkpoint import (find_latest_ckpt,
                                                      load_checkpoint)
    from visrag_tpu_torch.training.trainer import RetrieverTrainer

    model = setup["model"]
    bb = model.cfg.backbone
    layers = bb.vit.depth + bb.llm.num_hidden_layers
    work = tempfile.mkdtemp(prefix="visrag_train_")
    try:
        data = f"{work}/train.parquet"
        _write_train_parquet(data, setup["pages"], N_PAGES)
        out = f"{work}/run"
        argv = ["--train-data", data, "--output-dir", out,
                "--set", f"train.max_steps={TRAIN_STEPS}",
                "--set", f"train.epochs={TRAIN_STEPS}",
                "--set", "train.grad_cache=true",
                "--set", f"train.grad_cache_micro_batch_size={MICRO}",
                "--set", "train.optimizer_state_dtype=bfloat16",
                "--set", "model.remat=true", "--set", "model.pooling=wmean",
                "--set", "train.lr=5e-6", "--set", "train.grad_clip=1.0",
                "--set", "train.softmax_temperature=0.02",
                "--set", f"data.batch_size={N_PAGES}",
                "--set", "train.log_every=1",
                "--set", f"train.save_every={TRAIN_STEPS}"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        al.reset_launch_counts()
        t0 = time.perf_counter()
        rc = train_retriever.main(argv)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = al.launch_counts()
        k2_by_d = _lengths_routes("[5]", launches)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        gc.collect()                      # the driver's model and optimizer
        torch.cuda.empty_cache()
        if rc != 0:
            raise RuntimeError(f"train_retriever.main returned {rc}")
        with open(f"{out}/metrics.jsonl") as f:
            hist = [json.loads(line) for line in f]
        if [m["step"] for m in hist] != list(range(1, TRAIN_STEPS + 1)):
            raise RuntimeError(f"logged steps {[m['step'] for m in hist]}")
        for m in hist:
            if not (math.isfinite(m["loss"]) and
                    math.isfinite(m["grad_norm"])):
                raise RuntimeError(f"non-finite step metrics {m}")
        per_encode = {"flat": bb.vit.depth, "stacked": bb.llm.num_hidden_layers}
        encodes = TRAIN_STEPS * (N_PAGES // MICRO) * 2
        want = {"flat": encodes * per_encode["flat"],
                "stacked": encodes * per_encode["stacked"],
                "fwd_lse": encodes * layers * 2,
                "dq": encodes * layers, "dkv": encodes * layers}
        if launches != want:
            raise RuntimeError(f"training launches {launches} != {want}")
        s_step = [1.0 / m["steps_per_s"] for m in hist]
        log(f"[5] train_retriever.main: {TRAIN_STEPS} steps of {N_PAGES} "
            f"pairs (GradCache micro-batch {MICRO}, bf16 AdamW states, "
            f"whole-block remat) in {run_s:.1f} s incl. model init and the "
            f"checkpoint | loss per step "
            f"{[round(m['loss'], 5) for m in hist]}, grad norm "
            f"{[round(m['grad_norm'], 4) for m in hist]} | s/step "
            f"{[round(x, 3) for x in s_step]} (steady "
            f"{statistics.median(s_step[1:]):.3f} s = "
            f"{N_PAGES / statistics.median(s_step[1:]):.3f} pairs/s) | peak "
            f"memory {peak_gb:.2f} GB | launches {launches} (= {want}) | "
            f"{smi()}")

        # the checkpoint, read back by maybe_resume into the phase-3 model
        # (the driver's initial weights: seed 0)
        path = find_latest_ckpt(out)
        if path is None or not path.endswith(f"global_step_{TRAIN_STEPS}"):
            raise RuntimeError(f"no checkpoint at step {TRAIN_STEPS}: {path}")
        init = {k: v.detach().clone() for k, v in model.state_dict().items()
                if k.endswith(".bias") and "vpm.blocks.0." in k}
        cfg = TrainConfig(lr=1e-4, warmup_ratio=0.0,
                          optimizer_state_dtype="bfloat16")
        trainer = RetrieverTrainer(model, cfg, total_steps=1000)
        t0 = time.perf_counter()
        step = trainer.maybe_resume(out)
        resume_s = time.perf_counter() - t0
        saved, _ = load_checkpoint(path)
        changed = [k for k in init if not torch.equal(
            init[k], model.state_dict()[k])]
        same = all(torch.equal(saved["model"][k], model.state_dict()[k].cpu())
                   for k in init)
        if step != TRAIN_STEPS or trainer.optimizer.count != TRAIN_STEPS \
                or not changed or not same:
            raise RuntimeError(f"resume: step {step}, optimizer count "
                               f"{trainer.optimizer.count}, changed "
                               f"{len(changed)} params, equal to the "
                               f"checkpoint {same}")
        del saved
        log(f"[5] checkpoint {path.rsplit('/', 1)[1]} read back by "
            f"maybe_resume in {resume_s:.1f} s: step {step}, optimizer count "
            f"{trainer.optimizer.count}, {len(changed)}/{len(init)} checked "
            f"parameters changed by training and equal to the checkpoint")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # GradCache against direct, and the loss on a fixed batch
    table = pos_table_tensor(setup["pcfg"].src_grid, "cuda")

    def finish(raw):
        return finish_encode_batch(raw, table)

    raw_q, raw_p = setup["train_batch"](4)
    direct = [(finish(raw_q), finish(raw_p))]
    micro = []
    tok = setup["tok"]
    tcfg = dataclasses.replace(setup["pcfg"], seq_auto=True)
    for i in (0, 2):
        micro.append((
            finish(build_encode_batch(tok, _queries(4)[i:i + 2], tcfg,
                                      device_mode=True)),
            finish(build_encode_batch(tok, setup["pages"][i:i + 2], tcfg,
                                      n_slice_slots=20, device_mode=True))))
    params = trainer.params
    trainer.generator.manual_seed(1)
    trainer.compute_grads(direct)
    g_direct = _grad_list(params)
    trainer.cfg.grad_cache = True
    trainer.generator.manual_seed(1)
    trainer.compute_grads(micro)
    num = sum(torch.linalg.vector_norm((p.grad.float() - g.float())) ** 2
              for p, g in zip(params, g_direct)).sqrt().item()
    den = sum(torch.linalg.vector_norm(g.float()) ** 2
              for g in g_direct).sqrt().item()
    rel_gc = num / den
    del g_direct
    trainer.cfg.grad_cache = False

    @torch.no_grad()
    def fixed_loss():
        from visrag_tpu_torch.training.contrastive import contrastive_loss
        q_reps = model(direct[0][0])
        p_reps = model(direct[0][1])
        return contrastive_loss(q_reps, p_reps, trainer.ccfg)[0].item()

    model.train()
    before = fixed_loss()
    lrs = []
    for _ in range(3):
        lrs.append(trainer.optimizer.lr_at(trainer.optimizer.param_groups[0],
                                           trainer.optimizer.count))
        trainer.train_step(direct)
    after = fixed_loss()
    log(f"[5] full width, 4 pairs, same weights and generator state: "
        f"GradCache (micro-batch 2) vs direct parameter grads rel_err "
        f"{rel_gc:.4g} (bound {RTOL_TRAIN}) | fixed-batch loss {before:.5f} "
        f"-> {after:.5f} after 3 direct steps at lr "
        f"{[f'{x:.3g}' for x in lrs]}")
    if not rel_gc <= RTOL_TRAIN:
        raise RuntimeError(f"GradCache grads differ from direct ({rel_gc})")
    if not (np.isfinite(after) and after < before):
        raise RuntimeError(f"fixed-batch loss did not drop: {before} -> "
                           f"{after}")
    del trainer
    torch.cuda.empty_cache()
    return {**launches, "k2_by_head_dim": k2_by_d,
            "losses": [m["loss"] for m in hist]}

# ---------------------------------------------------------------------------
# Phases 6-7: EVisRAG serving (Qwen2.5-VL-7B, paged KV engine)
# ---------------------------------------------------------------------------

DEV = "cuda"
SERVE_MAX_TOKENS = 64    # the driver's default is 2048
DECODE_CHECK_STEPS = 3


class StandInTokenizer:
    """A tokenizer with Qwen2.5-VL's special-token ids and its chat layout:
    each special token is one id, every other word hashes into the text
    vocabulary. It stands in for the checkpoint's tokenizer, which is not in
    the repository; `image_token` makes the driver ban the image token."""

    SPECIAL = {"<|im_start|>": 151644, "<|im_end|>": 151645,
               "<|vision_start|>": 151652, "<|vision_end|>": 151653,
               "<|image_pad|>": 151655}
    image_token = "<|image_pad|>"
    eos_token_id = 151645

    def __init__(self, text_vocab: int = 151643):
        import re
        self.text_vocab = text_vocab
        self._split = re.compile("(" + "|".join(
            re.escape(t) for t in self.SPECIAL) + ")")

    def apply_chat_template(self, messages, tokenize=False,
                            add_generation_prompt=True):
        out = "<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n"
        for m in messages:
            body = "".join(
                "<|vision_start|><|image_pad|><|vision_end|>"
                if c["type"] == "image" else c["text"]
                for c in m["content"])
            out += f"<|im_start|>{m['role']}\n{body}<|im_end|>\n"
        return out + ("<|im_start|>assistant\n" if add_generation_prompt
                      else "")

    def convert_tokens_to_ids(self, token):
        return self.SPECIAL[token]

    def encode(self, text):
        import zlib
        ids = []
        for part in self._split.split(text):
            if part in self.SPECIAL:
                ids.append(self.SPECIAL[part])
            else:
                ids.extend(zlib.crc32(w.encode()) % self.text_vocab
                           for w in part.split())
        return ids


def _serving_requests(tok, cfg, seed=0):
    """The six requests of phase 7, assembled by the driver's own
    assemble_request: three with 3 pages (chunked prefill), one with one
    small page (whole prefill, K1), two text-only prompts of one bucket
    (batched prefill). → [(name, kwargs of Engine.add_request, n)]."""
    import numpy as np
    from PIL import Image

    from visrag_tpu_torch.driver.evisrag_predict import assemble_request
    from visrag_tpu_torch.generation.prompts import build_prompt
    rng = np.random.default_rng(seed)

    def page(w, h):
        return Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8))

    query = ("what was the total revenue reported for the fourth quarter "
             "and how did it compare with the previous year")
    prompt = build_prompt("evidence_prompt_grpo", query)
    out = []
    for i, third in enumerate(PAGE_SIZES[2:] + PAGE_SIZES[:1]):
        pages = [page(*PAGE_SIZES[0]), page(*PAGE_SIZES[1]), page(*third)]
        out.append((f"pages3_{i}", assemble_request(tok, tok, cfg, pages,
                                                    prompt), 1))
    out.insert(0, ("page1_small", assemble_request(
        tok, tok, cfg, [page(448, 448)], prompt), 2))
    for i, n_words in enumerate((300, 420)):
        text = prompt + " " + " ".join(f"context{j}" for j in range(n_words))
        out.insert(i, (f"text{i}", assemble_request(tok, tok, cfg, [], text),
                       1))
    return out


def _vision_tensors(req):
    return {k: torch.as_tensor(v, device=DEV)
            for k, v in req["vision_batch"].items()}


def _timed_check(tag, label, kern, plain, lib, out, ref, rows, bound,
                 phase="[6]"):
    """A kernel's output against its plain version's on `rows`: finite, and
    within RTOL_BLOCK relative (Frobenius) error; then kernel, plain and
    library times (lib None: no single call computes the function; plain
    None: an edge shape, the plain version not timed)."""
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(out.float()).all())
    rel = _rel(out[rows], ref[rows])
    max_abs = (out[rows].float() - ref[rows].float()).abs().max().item()
    ms = cuda_ms(kern)
    plain_ms = cuda_ms(plain) if plain is not None else None
    lib_ms = cuda_ms(lib) if lib is not None else None
    log(f"{phase} {tag} {label}: rel_err {rel:.4g} (bound {RTOL_BLOCK}), "
        f"max_abs_err {max_abs:.4g}, finite {finite} | kernel {ms:.4f} ms, "
        f"plain {'n/a' if plain_ms is None else f'{plain_ms:.4f} ms'}, "
        f"library "
        f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
        f"{bound[0]:.4f} ms ({bound[1]}) (medians in bursts of 10, CUDA "
        f"events) | "
        f"{smi()}")
    if not finite or rel > RTOL_BLOCK:
        raise RuntimeError(f"{tag} {label}: kernel disagrees with its plain "
                           f"version (rel_err {rel}, finite {finite})")
    return {"shape": label, "max_abs_err": max_abs, "rel_err": rel,
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound[0], "bound_by": bound[1]}


# K5's shapes: the 7B engine's decode (phase 7's four live requests at the
# end of generation, 28/4, d 128) at the engine's 128-token blocks and at
# 8-token blocks; MiniCPM-2B's decode (36/36, d 64, 4 slots up to 4,096);
# the 3B rollout's (16/2, d 128, 8-token blocks, 8 slots up to 16,536).
# (label, lengths or None for phase 7's, heads, kv heads, d, block size,
# edge tail); each shape is checked again at lengths 1, bs, bs + 1 and the
# edge tail.
K5_SHAPES = (("7B decode", None, 28, 4, 128, 128, 4000),
             ("7B decode bs 8", None, 28, 4, 128, 8, 4000),
             ("MiniCPM-2B decode", [4096, 3371, 2050, 777], 36, 36, 64, 128,
              4096),
             ("3B rollout bs 8", [16536, 15064, 12011, 9007, 6005, 3003,
                                  1501, 650], 16, 2, 128, 8, 16536))


def _k5_pools(gen, n_blocks, kvh, bs, d, quantized):
    """Random bf16 pools, or int8 pools holding random values quantized on
    write. → (pools, the bf16 pools of the same values)."""
    from visrag_tpu_torch.serving import paged_kv as pk
    pools, bf16 = [], []
    for _ in range(2):
        x = torch.randn(n_blocks, kvh, bs, d, generator=gen,
                        device=DEV).bfloat16()
        if quantized:
            pool = pk.KVQuant(torch.empty(x.shape, dtype=torch.int8,
                                          device=DEV),
                              torch.empty(x.shape[:-1], device=DEV))
            pk.pool_write_rows(pool, torch.arange(n_blocks, device=DEV), x)
            pools.append(pool)
            bf16.append(pk.pool_gather(pool, torch.arange(n_blocks,
                                                          device=DEV)))
        else:
            pools.append(x)
            bf16.append(x)
        del x
    return pools, bf16


def _k5_check(tag, gen, label, lens, h, kvh, d, bs, quantized, timed):
    """K5 (int8 pools if `quantized`) against its plain version at these
    lengths, through the engine's table (a power-of-two width with room for
    a 16-step chunk, pool rows at random, the null block past each length):
    finite; bf16 within RTOL_BLOCK relative and 2e-2 max abs, int8 within
    RTOL_K5_INT8 relative. Timed: the kernel, in turns with the first
    kernel (legacy=True) where it takes the shape (d = bs = 128), the
    plain version, gather + SDPA (not one call: no single call computes
    K5), the bound, and for int8 the kernel on bf16 pools of the
    dequantized values. → the check record."""
    from visrag_tpu_torch.serving import paged_kv as pk
    n_blocks = sum(-(-n // bs) for n in lens) + 1
    pools, bf16 = _k5_pools(gen, n_blocks, kvh, bs, d, quantized)
    perm = torch.randperm(n_blocks - 1, generator=gen, device=DEV)
    mb = 1
    while mb * bs < max(lens) + 17:
        mb *= 2
    table = torch.full((len(lens), mb), n_blocks - 1, dtype=torch.int32,
                       device=DEV)
    at = 0
    for i, n in enumerate(lens):
        used = -(-n // bs)
        table[i, :used] = perm[at:at + used].int()
        at += used
    lens_t = torch.tensor(lens, dtype=torch.int32, device=DEV)
    q = torch.randn(len(lens), h, d, generator=gen, device=DEV).bfloat16()
    kern = lambda: pk.paged_decode_attention(q, *pools, table, lens_t)
    plain = lambda: pk.paged_decode_reference(q, *pools, table, lens_t,
                                              d ** -0.5)
    out, ref = kern(), plain()
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(out.float()).all())
    rel = _rel(out, ref)
    max_abs = (out.float() - ref.float()).abs().max().item()
    ok = finite and (rel <= RTOL_K5_INT8 if quantized else
                     rel <= RTOL_BLOCK and max_abs <= ATOL_KERNEL)
    splits = pk.split_plan(len(lens), kvh, mb, bs, pk._occupancy(
        torch.cuda.current_device(), d, quantized))
    bounds = pk.split_bounds(lens, mb, bs, splits)
    busy = int((bounds[..., 1] > bounds[..., 0]).sum()) * kvh
    tokens = sum(lens)
    row = d + 4 if quantized else 2 * d
    bound = _bound(2 * 2 * tokens * h * d,
                   tokens * kvh * row * 2 + 2 * len(lens) * h * d * 2
                   + table.numel() * 4)
    form = "int8" if quantized else "bf16"
    rec = {"shape": f"{label} slots={len(lens)} H={h}/{kvh} d={d} bs={bs} "
                    f"table width {mb} lengths {lens}",
           "max_abs_err": max_abs, "rel_err": rel, "splits": splits,
           "blocks_with_work": busy, "blocks": splits * kvh * len(lens),
           "library_ms": None, "bound_ms": bound[0], "bound_by": bound[1]}
    line = (f"{tag} K5 {form} {rec['shape']}: rel_err {rel:.4g} (bound "
            f"{RTOL_K5_INT8 if quantized else RTOL_BLOCK}), max_abs_err "
            f"{max_abs:.4g}, finite {finite} | {splits} splits (cluster "
            f"size), {busy} of {rec['blocks']} blocks hold work")
    if timed:
        if d == bs == 128:
            rec["ms"], rec["legacy_ms"], rec["turns"] = _turns(
                kern, lambda: pk.paged_decode_attention(
                    q, *pools, table, lens_t, legacy=True))
        else:
            rec["ms"] = cuda_ms(kern)
        rec["plain_ms"] = cuda_ms(plain)
        keep = (torch.arange(mb * bs, device=DEV)[None]
                < lens_t[:, None])[:, None, None, :]
        idx = table.long()

        def gather_sdpa():
            k_, v_ = (p_[idx].transpose(1, 2).reshape(len(lens), kvh, -1, d)
                      for p_ in bf16)
            return F.scaled_dot_product_attention(
                q[:, :, None], k_, v_, attn_mask=keep, enable_gqa=True)
        rec["gather_sdpa_ms"] = cuda_ms(gather_sdpa)
        line += (f" | kernel {rec['ms']:.4f} ms"
                 + (f" (in turns with the first kernel, legacy=True: "
                    f"{rec['legacy_ms']:.4f} ms; {rec['turns']})"
                    if "legacy_ms" in rec else "")
                 + f", plain {rec['plain_ms']:.4f} ms, gather + SDPA (not "
                 f"one call) {rec['gather_sdpa_ms']:.4f} ms, bound "
                 f"{bound[0]:.4f} ms ({bound[1]})")
        if quantized:
            rec["bf16_ms"] = cuda_ms(lambda: pk.paged_decode_attention(
                q, *bf16, table, lens_t))
            line += f", K5 bf16 on the dequantized pools {rec['bf16_ms']:.4f}"
        line += f" (CUDA events) | {smi()}"
    log(line)
    if not ok:
        raise RuntimeError(f"K5 {form} {label}: kernel disagrees with its "
                           f"plain version (rel_err {rel}, max_abs_err "
                           f"{max_abs}, finite {finite})")
    del pools, bf16, q, table
    torch.cuda.empty_cache()
    return rec


def _k5_checks(tag, gen, live, tc, quantized):
    """K5 at K5_SHAPES (phase 7's live lengths where the shape takes
    them), timed, then each shape at lengths 1, bs, bs + 1 and its edge
    tail. The 7B decode shape's heads come from `tc`. → check records, the
    7B decode shape first."""
    out = []
    for label, lens, h, kvh, d, bs, tail in K5_SHAPES:
        if lens is None:
            lens, h, kvh, d = (live, tc.num_attention_heads,
                               tc.num_key_value_heads, tc.head_dim)
        out.append(_k5_check(tag, gen, label, lens, h, kvh, d, bs, quantized,
                             True))
        edge = [1, bs, bs + 1, tail] + lens[4:]
        out.append(_k5_check(tag, gen, f"{label} edges", edge, h, kvh, d, bs,
                             quantized, False))
    return out


def _k3_edge_ids():
    """K3's edge ids: (label, (B, S) int32) pairs. Windows of 63/64/65 and
    127/128/129 tokens straddling 128-row tiles and a pad tail that fills
    whole tiles beside a batch row of pad only; one segment over all of
    S."""
    import numpy as np
    sizes = [1, 63, 64, 65, 127, 128, 129, 700, 63, 129]
    row = np.repeat(np.arange(1, len(sizes) + 1), sizes)
    edges = np.zeros((2, len(row) + 300), np.int32)
    edges[0, :len(row)] = row
    return [("edge: 63/64/65, 127/128/129, whole pad tiles, a pad row",
             edges),
            ("edge: one segment over all of S", np.ones((1, 2000), np.int32))]


def _k3_checks(gen, vb, h, d):
    """K3 on views of one fused (B, S, 3, H, D) qkv tensor (the vision
    block's layout) at the window ids, the image ids and the edge ids,
    against its plain version (RTOL_BLOCK, finite), pad rows exactly 0;
    the window and image ids timed beside the plain version and SDPA with a
    block-diagonal mask, and in turns with the first kernel (legacy=True:
    pr3_ms). → records, window and image first."""
    import numpy as np

    from visrag_tpu_torch.ops import attention_kvgrid as kg
    out_recs = []
    cases = [("seg_window", np.asarray(vb["seg_window"], np.int32)[None]),
             ("seg_full", np.asarray(vb["seg_full"], np.int32)[None])]
    for label, ids_np in cases + _k3_edge_ids():
        seg = torch.as_tensor(ids_np, device=DEV)
        b, s = seg.shape
        qkv = torch.randn(b, s, 3, h, d, generator=gen,
                          device=DEV).bfloat16()
        q, k, v = qkv.unbind(2)
        kern = lambda: kg.flash_attention_kvgrid(q, k, v, seg)
        plain = lambda: kg.flash_attention_kvgrid_reference(q, k, v, seg)
        out, ref = kern(), plain()
        real = seg > 0
        if not bool((out[~real] == 0).all()):
            raise RuntimeError(f"K3 {label}: pad rows are not exactly 0")
        ids = seg.long()
        timed = label in ("seg_window", "seg_full")
        sizes = [torch.unique_consecutive(r[r > 0], return_counts=True)[1]
                 for r in ids]
        pairs = int(sum((c.long() ** 2).sum() for c in sizes))
        nreal = int(real.sum())
        bound = _bound(2 * 2 * pairs * h * d,
                       nreal * 3 * h * d * 2 + b * s * h * d * 2)
        lib = None
        if timed:
            row = ids[0]
            allow = (row[:, None] == row[None, :]) & (row[:, None] > 0)
            allow |= torch.eye(s, dtype=torch.bool, device=DEV)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            lib = lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                         attn_mask=allow)
        largest = max(int(c.max()) for c in sizes if len(c))
        rec = _timed_check(
            "K3", f"{label} B={b} S={s} H={h} d={d} segments "
            f"{sum(len(c) for c in sizes)} (largest {largest}) pad "
            f"{b * s - nreal}, fused qkv views; pad rows exactly 0", kern,
            plain if timed else None, lib, out, ref, real, bound)
        if timed:
            o_old = lambda: kg._launch(q, k, v, seg, d ** -0.5, legacy=True)
            err_old = _rel(o_old()[real], ref[real])
            rec["ms"], rec["pr3_ms"], rec["turns"] = _turns(kern, o_old)
            log(f"[6] K3 {label}: in turns with the first kernel "
                f"({kg.LEGACY_SOURCE}, rel_err {err_old:.4g}) "
                f"{rec['ms']:.4f} ms against {rec['pr3_ms']:.4f} ms "
                f"({rec['turns']}); bound {rec['bound_ms']:.4f} "
                f"({rec['bound_by']})")
            del allow, qt, kt, vt
        out_recs.append(rec)
        del q, k, v, qkv, out, ref
    return out_recs


def phase6_serving_kernels(gen, reqs, cfg):
    """K3, K1 (stacked causal, GQA 28/4, d = 128) and K5 against their plain
    versions on the card at the serving path's shapes and at edge cases;
    one full-width vision block and one 7B text layer against fp32 on the
    CPU; K8 at the 7B's chunk shapes. → {"kvgrid": [...], "gqa": [...],
    "paged": [...], "chunk": [...]}."""
    from visrag_tpu_torch.ops import attention_kvgrid as kg
    from visrag_tpu_torch.ops import attention_lengths as al
    from visrag_tpu_torch.serving import paged_kv as pk
    vc, tc = cfg.vision, cfg.text
    res = {"kvgrid": [], "gqa": [], "paged": []}

    # K3 at the first 3-page request's window and image segments and at
    # edge ids, on views of one fused qkv tensor as the vision block passes
    # them; timed in turns with the first kernel (legacy=True)
    by = {name: req for name, req, _ in reqs}
    vb = by["pages3_0"]["vision_batch"]
    res["kvgrid"] = _k3_checks(gen, vb, vc.num_heads, vc.head_dim)
    _kvgrid_routes("[6]")
    window, full = res["kvgrid"][0], res["kvgrid"][1]
    n_full = len(vc.fullatt_block_indexes)
    n_window = vc.depth - n_full
    tower = {key: n_window * window[key] + n_full * full[key]
             for key in ("ms", "pr3_ms")}
    log(f"[6] K3 per vision-tower run of this request: "
        f"{n_window} window + {n_full} full layers = {tower['ms']:.4f} ms "
        f"(the first kernel in the same turns: {tower['pr3_ms']:.4f} ms)")
    res["kvgrid_tower_ms"] = tower
    torch.cuda.empty_cache()

    # K1 stacked causal with grouped kv heads, at the whole and batched
    # prefill shapes of phase 7 and at edge lengths
    h, kvh, d = tc.num_attention_heads, tc.num_key_value_heads, tc.head_dim
    whole = [len(by["page1_small"]["input_ids"])]
    batched = [len(by["text0"]["input_ids"]), len(by["text1"]["input_ids"])]
    for label, lens, s in (("whole prefill", whole, 4096),
                           ("batched prefill", batched, 4096),
                           ("edge", [0, 1, 63, 64, 65, 4096], 4096)):
        b = len(lens)
        q = torch.randn(b, s, h, d, generator=gen, device=DEV).bfloat16()
        k, v = (torch.randn(b, s, kvh, d, generator=gen, device=DEV)
                .bfloat16() for _ in range(2))
        lens_t = torch.tensor(lens, dtype=torch.int32, device=DEV)
        kern = lambda: al.flash_fwd_lengths(q, k, v, lens_t, True, d ** -0.5)

        def plain():     # one row at a time: (28, S, S) fp32 scores
            return torch.cat([al.lengths_attention_reference(
                q[i:i + 1], k[i:i + 1], v[i:i + 1], lens_t[i:i + 1], True,
                d ** -0.5) for i in range(b)])
        out, ref = kern(), plain()
        valid = torch.arange(s, device=DEV)[None] < lens_t[:, None]
        if not bool((out[~valid] == 0).all()):
            raise RuntimeError(f"K1 GQA {label}: pad rows are not exactly 0")
        mask = _sdpa_mask(lens_t, s, True, DEV)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, scale=d ** -0.5, enable_gqa=True)
        rec = _timed_check(
            "K1 GQA", f"{label} B={b} S={s} H={h}/{kvh} d={d} lengths "
            f"{lens}; pad rows exactly 0", kern, plain, lib, out, ref, valid,
            attention_bound("fwd", lens, s, h, d, True, kv_heads=kvh))
        # in turns with the legacy mma.sync kernel
        o_old = torch.empty_like(q)
        rec["ms"], rec["pr1_ms"], rec["turns"] = _turns(
            kern, lambda: al._fwd(q, k, v, o_old, None, lens_t, True,
                                  d ** -0.5, legacy=True))
        log(f"[6] K1 GQA {label}: in turns with the legacy mma.sync kernel "
            f"{rec['ms']:.4f} ms against {rec['pr1_ms']:.4f} ms "
            f"({rec['turns']})")
        res["gqa"].append(rec)
        del q, k, v, out, ref, mask, qt, kt, vt, o_old
    torch.cuda.empty_cache()

    live = [len(by[n]["input_ids"]) + SERVE_MAX_TOKENS
            for n in ("pages3_0", "pages3_1", "pages3_2", "page1_small")]
    res["paged"] = _k5_checks("[6]", gen, live, tc, quantized=False)
    res["chunk"] = _k8_checks(gen, h, kvh, d)
    _qwen_full_width_blocks(gen, cfg, vb)
    return res


# K8's shapes: 2048-token chunks over the gathered prefix L = start + C,
# the answer cell's prompts (and phase 9's 3-page prompts) reaching L 6144
K8_LENGTHS = (2048, 4096, 6144)
K8_REPLACES = ("none: visrag_tpu/ops/attention.py:86 xla_chunk_attention "
               "is XLA")


def k8_bound(c, L, starts, h, kvh, d):
    """(bound_ms, bound_by) of one K8 call: QK^T and PV over each row's
    visible keys (key <= start + query, key < L), q and o at h heads, the
    gathered k and v at kvh, each read or written once."""
    visible = sum(min(st + i + 1, L) for st in starts for i in range(c))
    return _bound(4 * visible * h * d,
                  2 * len(starts) * d * (2 * c * h + 2 * L * kvh))


def _k8_checks(gen, h, kvh, d, c=2048, phase="[6]"):
    """K8 against its plain version on the card at a chunked prefill's
    shapes (h / kvh heads, C 2048 over K8_LENGTHS), with SDPA under the
    explicit chunk mask (GQA) as the library yardstick, timed only.
    → [record per L]."""
    from visrag_tpu_torch.ops import attention as at
    recs = []
    for L in K8_LENGTHS:
        start = L - c
        q = torch.randn(1, c, h, d, generator=gen, device=DEV).bfloat16()
        k, v = (torch.randn(1, L, kvh, d, generator=gen, device=DEV)
                .bfloat16() for _ in range(2))
        st = torch.tensor([start], device=DEV)
        kern = lambda: at.chunk_attention(q, k, v, st)
        plain = lambda: at.chunk_attention_reference(q, k, v, st)
        mask = (torch.arange(L, device=DEV)[None, :]
                <= start + torch.arange(c, device=DEV)[:, None])[None, None]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, scale=d ** -0.5, enable_gqa=True)
        n0 = at.chunk_launches
        out = kern()
        if at.chunk_launches != n0 + 1:
            raise RuntimeError("K8: chunk_attention did not launch the "
                               "kernel")
        rec = _timed_check(
            "K8", f"chunk C={c} at start {start} (L={L}) H={h}/{kvh} d={d}",
            kern, plain, lib, out, plain(), slice(None),
            k8_bound(c, L, [start], h, kvh, d), phase)
        rec["roofline_pct"] = 100 * rec["bound_ms"] / rec["ms"]
        recs.append(rec)
        del q, k, v, mask, qt, kt, vt, out
    torch.cuda.empty_cache()
    return recs


def k8_row(name, launches, recs):
    """The kernel JSON's K8 row: a path's launches, the numbers at the
    last (longest) checked L, every check."""
    from visrag_tpu_torch.ops.attention import CHUNK_SOURCE
    last = recs[-1]
    return {"name": name, "route": "cuda", "source": CHUNK_SOURCE,
            "replaces": K8_REPLACES, "launches": launches,
            **{k: last[k] for k in KEYS}, "sdpa_ms": last["library_ms"],
            "checks": recs}


def _qwen_full_width_blocks(gen, cfg, vb):
    """One window-layer vision block on the first page's patches and one 7B
    text layer, bf16 kernels on the card against fp32 plain on the CPU."""
    import numpy as np

    from visrag_tpu_torch.driver.common import init_weights_
    from visrag_tpu_torch.models.mrope import mrope_cos_sin
    from visrag_tpu_torch.models.qwen25_vl import (QwenTextBlock,
                                                   QwenVisionBlock)
    vc, tc = cfg.vision, cfg.text
    # the first page's patches lead the window-ordered stream
    n = int((np.asarray(vb["seg_full"]) == 1).sum())
    with torch.device(DEV):
        block = QwenVisionBlock(vc)
    init_weights_(block, gen)
    x = torch.randn(n, vc.hidden_size, generator=gen, device=DEV)
    cos = torch.as_tensor(vb["rot_cos"][:n], device=DEV)
    sin = torch.as_tensor(vb["rot_sin"][:n], device=DEV)
    seg = torch.as_tensor(vb["seg_window"][:n], device=DEV)
    with torch.inference_mode():
        out = block(x.bfloat16(), cos, sin, seg)
        ref = copy.deepcopy(block).float().cpu()(x.cpu(), cos.cpu(),
                                                 sin.cpu(), seg.cpu())
    e_vis = _rel_err(out, ref, slice(None))
    del block, out

    with torch.device(DEV):
        layer = QwenTextBlock(tc)
    init_weights_(layer, gen)
    s, length = 512, 450
    x = torch.randn(1, s, tc.hidden_size, generator=gen, device=DEV)
    pos = torch.arange(s)[None, None].expand(3, 1, s)
    inv = 1.0 / (tc.rope_theta ** (torch.arange(0, tc.head_dim, 2,
                                                dtype=torch.float32)
                                   / tc.head_dim))
    lens = torch.tensor([length], dtype=torch.int32)
    with torch.inference_mode():
        cs = mrope_cos_sin(pos.to(DEV), inv.to(DEV), tc.mrope_section)
        out, _ = layer(x.bfloat16(), *cs, lens.to(DEV))
        cs = mrope_cos_sin(pos, inv, tc.mrope_section)
        ref, _ = copy.deepcopy(layer).float().cpu()(x.cpu(), *cs, lens)
    e_txt = _rel_err(out, ref, torch.arange(s)[None] < length)
    log(f"[6] full-width blocks, bf16 kernels on the card vs fp32 plain on "
        f"the CPU: vision block (window layer, one page, S={n}) rel_err "
        f"{e_vis:.3g}, 7B text layer (S={s}, length {length}) rel_err "
        f"{e_txt:.3g} (bound {RTOL_BLOCK})")
    if max(e_vis, e_txt) > RTOL_BLOCK:
        raise RuntimeError("full-width Qwen block disagrees with its fp32 "
                           "plain version")


class _SyncTimer:
    """Wall time of an engine method, bracketed by device syncs."""

    def __init__(self, engine, name):
        self.calls, self.seconds = 0, 0.0
        fn = getattr(engine, name)

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            return out
        setattr(engine, name, timed)


def _decode_vs_full(model, req, chunked, chunk_tokens=2048, bs=128,
                    int8=False, tokens=None):
    """Prefill one request into a fresh pool (whole through K1, or chunk by
    chunk), take DECODE_CHECK_STEPS greedy decode steps over the pool (K5;
    its int8 variant over int8 pools), and compare each step's logits with
    a full causal pass over prompt + generated tokens (K1) at the same
    positions. `tokens` forces the decoded tokens (to hold two pools at the
    same steps). → (relative errors, the logits of each step, tokens)."""
    import numpy as np

    from visrag_tpu_torch.serving.paged_kv import KVQuant, write_prefill
    cfg = model.cfg.text
    ids = np.asarray(req["input_ids"])
    s = len(ids)
    pos = np.asarray(req.get("positions", np.broadcast_to(np.arange(s),
                                                          (3, s))))
    vision = req.get("vision_batch")
    vb = _vision_tensors(req) if vision is not None else None
    steps = DECODE_CHECK_STEPS
    grid = -(-s // chunk_tokens) * chunk_tokens if chunked \
        else -(-s // bs) * bs
    n_blocks = grid // bs + 2
    shape = (cfg.num_hidden_layers, n_blocks, cfg.num_key_value_heads, bs,
             cfg.head_dim)
    if int8:
        kc, vc = (KVQuant(torch.zeros(shape, dtype=torch.int8, device=DEV),
                          torch.zeros(shape[:-1], device=DEV))
                  for _ in range(2))
    else:
        kc = torch.zeros(shape, dtype=torch.bfloat16, device=DEV)
        vc = torch.zeros_like(kc)
    table = torch.arange(n_blocks - 1, dtype=torch.int32,
                         device=DEV)[None].contiguous()
    ids_p = np.zeros((1, grid), np.int64)
    ids_p[0, :s] = ids
    sm = None
    if vb is not None:
        sm = np.full((1, grid), -1, np.int64)
        sm[0, :s] = req["slot_map"]
        sm = torch.as_tensor(sm, device=DEV)
    ids_t = torch.as_tensor(ids_p, device=DEV)
    with torch.inference_mode():
        if chunked:
            emb = model.embed_prompt(ids_t, vb, sm)
            for lo in range(0, grid, chunk_tokens):
                hi = min(lo + chunk_tokens, s)
                cpos = np.zeros((3, 1, chunk_tokens), np.int64)
                cpos[:, 0, :hi - lo] = pos[:, lo:hi]
                cpos[:, 0, hi - lo:] = cpos[:, 0, hi - lo - 1:hi - lo] + \
                    np.arange(1, chunk_tokens - (hi - lo) + 1)
                rows = torch.arange(lo // bs, (lo + chunk_tokens) // bs,
                                    device=DEV)
                logits = model.prefill_chunk(
                    ids_t[:, lo:lo + chunk_tokens],
                    torch.as_tensor(cpos, device=DEV), kc, vc, rows,
                    torch.arange((lo + chunk_tokens) // bs, device=DEV),
                    torch.tensor(lo, device=DEV),
                    last_pos=torch.tensor([s - 1 - lo], device=DEV)
                    if hi >= s else None,
                    inputs_embeds=emb[:, lo:lo + chunk_tokens])
        else:
            mask = torch.as_tensor((np.arange(grid) < s)[None], device=DEV)
            ppos = np.zeros((3, 1, grid), np.int64)
            ppos[:, 0, :s] = pos
            logits, k, v = model.prefill(
                ids_t, attention_mask=mask,
                positions=torch.as_tensor(ppos, device=DEV), vision_batch=vb,
                slot_map=sm, last_pos=torch.tensor([s - 1], device=DEV))
            write_prefill(kc, vc, k, v, list(range(grid // bs)), grid)
            del k, v
        dec = [logits[0].float()]
        toks = []
        cur = int(pos.max()) + 1
        for t in range(steps):
            tok = int(dec[-1].argmax()) if tokens is None else tokens[t]
            toks.append(tok)
            lg = model.decode(
                torch.tensor([[tok]], device=DEV),
                torch.full((3, 1, 1), cur + t, device=DEV), kc, vc,
                torch.tensor([s + t + 1], dtype=torch.int32, device=DEV),
                table)
            dec.append(lg[0].float())
        full_ids = np.concatenate([ids, toks]).astype(np.int64)[None]
        full_pos = np.concatenate(
            [pos, np.broadcast_to(cur + np.arange(steps), (3, steps))],
            axis=1)[:, None]
        fsm = None
        if vb is not None:
            fsm = np.full(full_ids.shape, -1, np.int64)
            fsm[0, :s] = req["slot_map"]
            fsm = torch.as_tensor(fsm, device=DEV)
        hidden = model.model(
            inputs_embeds=model._embed(torch.as_tensor(full_ids, device=DEV),
                                       vb, fsm),
            positions=torch.as_tensor(full_pos, device=DEV))
        full = model.compute_logits(hidden[0, s - 1:s + steps]).float()
    errs = [(torch.linalg.norm(dec[i] - full[i])
             / torch.linalg.norm(full[i])).item() for i in range(steps + 1)]
    del kc, vc
    torch.cuda.empty_cache()
    return errs, dec, toks


def phase7_serving(reqs, cfg):
    """The full-width serving slice: Qwen2.5-VL-7B at random from seed 0,
    the engine built by the driver's build_engine, the six requests (one
    as an n = 2 group) through it. Checks complete outputs without the
    image token, a schedule with prefills, chunk steps and decode chunks,
    the exact launch counts, and decode logits against the full forward.
    → (launch counts of the run, the model, the decode check's results)."""
    from visrag_tpu_torch.driver.common import build_qwen25_vl
    from visrag_tpu_torch.driver.evisrag_predict import (build_engine,
                                                         sampling_params)
    from visrag_tpu_torch.ops import attention as at
    from visrag_tpu_torch.ops import attention_kvgrid as kg
    from visrag_tpu_torch.ops import attention_lengths as al
    from visrag_tpu_torch.ops import norms
    from visrag_tpu_torch.serving import paged_kv as pk
    tok = StandInTokenizer()
    t0 = time.perf_counter()
    model = build_qwen25_vl(cfg, device=DEV, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    engine = build_engine(model, tok.eos_token_id)
    engine.record_schedule = True
    sp = sampling_params(tok, tok, 0.0, SERVE_MAX_TOKENS)
    timers = {name: _SyncTimer(engine, name) for name in (
        "_prefill_one", "_prefill_many", "_advance_chunk", "_decode_chunk",
        "_start_chunked")}
    names = {}
    for name, req, n in reqs:
        rid = engine.add_request(sampling=sp, n=n, **req)
        for r in (rid if isinstance(rid, list) else [rid]):
            names[r] = name
    requests = list(engine.queue)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    al.reset_launch_counts()
    kg.reset_launch_counts()
    pk.reset_launch_counts()
    norms.reset_launch_counts()
    chunk0 = at.chunk_launches
    t0 = time.perf_counter()
    engine.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {"stacked": al.stacked_launches, "kvgrid": kg.launches,
                "paged": pk.launches, "flat": al.flat_launches,
                "fwd_lse": al.fwd_lse_launches,
                "paged_legacy": pk.legacy_launches,
                "chunk": at.chunk_launches - chunk0}
    _lengths_routes("[7]", launches)
    _kvgrid_routes("[7]")
    norm_launches = norms.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    image_id = StandInTokenizer.SPECIAL["<|image_pad|>"]
    for r in requests:
        o = r.output_ids
        if not r.done or not (len(o) == SERVE_MAX_TOKENS or
                              (o and o[-1] == tok.eos_token_id)):
            raise RuntimeError(f"{names[r.request_id]}: incomplete output "
                               f"({len(o)} tokens)")
        if image_id in o:
            raise RuntimeError(f"{names[r.request_id]}: image token emitted")
    log_s = "".join(engine.sched_log)
    if "P" not in log_s or not ({"C", "c"} & set(log_s)) or "D" not in log_s:
        raise RuntimeError(f"schedule lacks P, C/c or D: {log_s}")
    vision_runs = sum(1 for _, req, _ in reqs if "vision_batch" in req)
    whole = timers["_prefill_one"].calls + timers["_prefill_many"].calls
    steps = log_s.count("D") * engine.chunk
    layers = cfg.text.num_hidden_layers
    want = {"stacked": layers * whole,
            "kvgrid": cfg.vision.depth * vision_runs,
            "paged": layers * steps, "flat": 0, "fwd_lse": 0,
            "paged_legacy": 0,
            "chunk": layers * timers["_advance_chunk"].calls}
    if launches != want or not want["chunk"]:
        raise RuntimeError(f"serving launches {launches} != {want}")

    # latencies and rates of the run
    by_kind = {"chunked": [], "whole": []}
    for name, req, _ in reqs:
        by_kind["chunked" if len(req["input_ids"]) > engine.chunk_tokens
                else "whole"].append(len(req["input_ids"]))
    chunk_s = timers["_advance_chunk"].seconds + \
        timers["_start_chunked"].seconds
    whole_s = timers["_prefill_one"].seconds + timers["_prefill_many"].seconds
    dec = timers["_decode_chunk"]
    out_tokens = sum(len(r.output_ids) for r in requests)
    ttft = {f"{names[r.request_id]}#{r.request_id}":
            round((r.t_first - r.t_enqueue) * 1e3, 1) for r in requests}
    log(f"[7] Qwen2.5-VL-7B full width bf16, {n_params / 1e9:.3f}B params "
        f"(init {init_s:.1f} s), engine {engine.num_slots} slots, max_len "
        f"{engine.max_len}, chunked prefill {engine.chunk_tokens}, prefix "
        f"cache on, pool {engine.k_cache.shape[1]} blocks x {layers} layers "
        f"({2 * engine.k_cache.numel() * 2 / 1e9:.2f} GB) | {len(requests)} "
        f"requests (prompt tokens "
        f"{[len(req['input_ids']) for _, req, _ in reqs]}), {out_tokens} "
        f"output tokens in {run_s:.2f} s = {out_tokens / run_s:.2f} output "
        f"tokens/s | schedule {log_s} | launches {launches} (= {want}) | "
        f"prefix hits {engine.prefix_hits}")
    log(f"[7] prefill: chunked {sum(by_kind['chunked'])} tokens in "
        f"{chunk_s:.3f} s (vision tower included) = "
        f"{sum(by_kind['chunked']) / chunk_s:.1f} tokens/s; whole/batched "
        f"{sum(by_kind['whole'])} tokens in {whole_s:.3f} s = "
        f"{sum(by_kind['whole']) / whole_s:.1f} tokens/s | decode "
        f"{dec.calls} chunks x {engine.chunk} steps, "
        f"{dec.seconds / max(steps, 1) * 1e3:.2f} ms/step | TTFT ms {ttft} "
        f"| K7 launches {norm_launches} ({2 * layers + 1} RMSNorms per "
        f"text forward, {2 * cfg.vision.depth + 1} per vision-tower run) | "
        f"peak memory {peak_gb:.2f} GB | {smi()}")

    # the vision tower per request, and decode against the full forward
    tower = {}
    with torch.inference_mode():
        for name, req, _ in reqs:
            if "vision_batch" in req:
                vb = _vision_tensors(req)
                tower[name] = round(cuda_ms(lambda: model.encode_images(vb),
                                            reps=3), 2)
    by = {name: req for name, req, _ in reqs}
    # the first 3-page request's tower in turns with the first K3 kernel
    # swapped in (launched past the counters, after the checks above)
    vb0 = _vision_tensors(by["pages3_0"])
    launch = kg._launch

    def first_k3():
        kg._launch = functools.partial(launch, legacy=True)
        try:
            return model.encode_images(vb0)
        finally:
            kg._launch = launch
    turns = {"new": [], "first": []}
    with torch.inference_mode():
        for which in ("new", "first", "first", "new"):
            turns[which].append(cuda_ms(
                (lambda: model.encode_images(vb0)) if which == "new"
                else first_k3, reps=3))
    log(f"[7] vision tower of pages3_0 in turns with the first K3 kernel: "
        f"{statistics.mean(turns['new']):.3f} ms against "
        f"{statistics.mean(turns['first']):.3f} ms ({turns})")
    dec_ref = {"whole": _decode_vs_full(model, by["page1_small"], False),
               "chunked": _decode_vs_full(model, by["pages3_0"], True)}
    errs = {k: v[0] for k, v in dec_ref.items()}
    log(f"[7] vision tower ms per request (median of 3) {tower} | decode "
        f"logits over the paged pool (K5) vs a full causal pass (K1) at the "
        f"same positions, relative error per step (first = prompt end): "
        f"whole prefill {[round(e, 5) for e in errs['whole']]}, chunked "
        f"prefill {[round(e, 5) for e in errs['chunked']]} (bound "
        f"{RTOL_BLOCK})")
    if max(max(v) for v in errs.values()) > RTOL_BLOCK:
        raise RuntimeError(f"decode logits disagree with the full forward: "
                           f"{errs}")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return launches, model, dec_ref


RTOL_K5_INT8 = 3.5e-3     # K5 int8 vs its plain version (same arithmetic)
RTOL_INT8_LOGITS = 0.1    # decode logits over int8 vs bf16 pools: K/V
                          # rounded to 1/254 of each row's absmax, through
                          # 28 layers of random weights (a sanity bound)


def _k5_int8_checks(gen, reqs, cfg):
    """K5's int8 variant against its plain version at phase 6's K5 shapes
    (the 7B decode shape at the live requests' final lengths, 128- and
    8-token blocks, MiniCPM-2B's, the 3B rollout's) and at lengths 1, bs,
    bs + 1 at each, timed beside K5 on bf16 pools holding the dequantized
    values. → check records."""
    by = {name: req for name, req, _ in reqs}
    live = [len(by[n]["input_ids"]) + SERVE_MAX_TOKENS
            for n in ("pages3_0", "pages3_1", "pages3_2", "page1_small")]
    return _k5_checks("[7b]", gen, live, cfg.text, quantized=True)


def phase7b_int8_serving(gen, reqs, cfg, model, dec_ref):
    """K5's int8 variant against its plain version, then phase 7's six
    requests through the driver's engine with int8 KV pools on the same
    7B weights: complete outputs, launch counts (K5 int8 28 per decode
    step, no bf16 K5), output tokens/s, ms per decode step, peak memory,
    pool bytes against bf16, and decode logits over int8 pools against
    phase 7's over bf16 pools at the same steps. → (K5 int8 check records,
    launch counts of the run)."""
    from visrag_tpu_torch.driver.evisrag_predict import (build_engine,
                                                         sampling_params)
    from visrag_tpu_torch.ops import attention as at
    from visrag_tpu_torch.ops import attention_kvgrid as kg
    from visrag_tpu_torch.ops import attention_lengths as al
    from visrag_tpu_torch.ops import matmul_int8 as mi
    from visrag_tpu_torch.serving import paged_kv as pk
    checks = _k5_int8_checks(gen, reqs, cfg)
    tok = StandInTokenizer()
    engine = build_engine(model, tok.eos_token_id, cache_dtype="int8")
    engine.record_schedule = True
    sp = sampling_params(tok, tok, 0.0, SERVE_MAX_TOKENS)
    dec_timer = _SyncTimer(engine, "_decode_chunk")
    for name, req, n in reqs:
        engine.add_request(sampling=sp, n=n, **req)
    requests = list(engine.queue)
    counts = {}
    undo = [_count_calls(engine, name, counts)
            for name in ("_prefill_one", "_prefill_many", "_advance_chunk")]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in (al, kg, pk, mi):
        mod.reset_launch_counts()
    chunk0 = at.chunk_launches
    t0 = time.perf_counter()
    engine.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    for u in undo:
        u()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {"stacked": al.stacked_launches, "kvgrid": kg.launches,
                "paged": pk.launches, "paged_int8": pk.int8_launches,
                "paged_legacy": pk.legacy_launches,
                "int8_gemm": mi.launches,
                "chunk": at.chunk_launches - chunk0}
    _kvgrid_routes("[7b]")
    layers = cfg.text.num_hidden_layers
    log_s = "".join(engine.sched_log)
    steps = log_s.count("D") * engine.chunk
    whole = counts.get("_prefill_one", 0) + counts.get("_prefill_many", 0)
    vision_runs = sum(1 for _, req, _ in reqs if "vision_batch" in req)
    want = {"stacked": layers * whole, "kvgrid": cfg.vision.depth * vision_runs,
            "paged": 0, "paged_int8": layers * steps, "paged_legacy": 0,
            "int8_gemm": 0,
            "chunk": layers * counts.get("_advance_chunk", 0)}
    if launches != want or not want["chunk"]:
        raise RuntimeError(f"int8 serving launches {launches} != {want}")
    image_id = StandInTokenizer.SPECIAL["<|image_pad|>"]
    for r in requests:
        o = r.output_ids
        if not r.done or not (len(o) == SERVE_MAX_TOKENS or
                              (o and o[-1] == tok.eos_token_id)) \
                or image_id in o:
            raise RuntimeError(f"int8 serving: request {r.request_id} "
                               f"incomplete or emitted the image token")
    out_tokens = sum(len(r.output_ids) for r in requests)
    pool_bytes = 2 * engine.k_cache.nbytes()
    bf16_bytes = 2 * engine.k_cache.data.numel() * 2
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    by = {name: req for name, req, _ in reqs}
    dist, errs = {}, {}
    for kind, name, chunked in (("whole", "page1_small", False),
                                ("chunked", "pages3_0", True)):
        _, ref_logits, ref_toks = dec_ref[kind]
        errs[kind], logits, _ = _decode_vs_full(model, by[name], chunked,
                                                int8=True, tokens=ref_toks)
        dist[kind] = [(torch.linalg.norm(a - b) / torch.linalg.norm(b))
                      .item() for a, b in zip(logits, ref_logits)]
    log(f"[7b] Qwen2.5-VL-7B full width, int8 KV pools (build_engine "
        f"cache_dtype=int8): {len(requests)} requests, {out_tokens} output "
        f"tokens in {run_s:.2f} s = {out_tokens / run_s:.2f} output tokens/s "
        f"| decode {dec_timer.calls} chunks x {steps // max(dec_timer.calls, 1)}"
        f" steps, {dec_timer.seconds / max(steps, 1) * 1e3:.2f} ms/step | "
        f"schedule {log_s} | launches {launches} (= {want}) | pool "
        f"{pool_bytes / 1e9:.3f} GB (int8 data + fp32 scales) against "
        f"{bf16_bytes / 1e9:.3f} GB bf16 | peak memory {peak_gb:.2f} GB | "
        f"{smi()}")
    log(f"[7b] decode logits over int8 pools vs over bf16 pools at the same "
        f"steps (phase 7's tokens), relative error per step (first = prompt "
        f"end): whole {[round(e, 5) for e in dist['whole']]}, chunked "
        f"{[round(e, 5) for e in dist['chunked']]} (bound "
        f"{RTOL_INT8_LOGITS}); vs a full causal pass: whole "
        f"{[round(e, 5) for e in errs['whole']]}, chunked "
        f"{[round(e, 5) for e in errs['chunked']]}")
    if max(max(v) for v in dist.values()) > RTOL_INT8_LOGITS:
        raise RuntimeError(f"int8-pool decode logits drift from bf16: {dist}")
    return checks, launches


# ---------------------------------------------------------------------------
# Phases 8-9: the RS-GRPO step (Qwen2.5-VL-3B, K4 forward and backward)
# ---------------------------------------------------------------------------

RL_RESPONSE_TOKENS = 64  # the config's default is 1536
RL_STEPS = 2
RTOL_GRADS = 5e-2        # a micro-batch's parameter gradients, kernels vs
                         # plain versions, bf16, relative Frobenius
SEG_REPLACES = {"seg_fwd": "visrag_tpu/ops/attention.py:219",
                "seg_dq": "visrag_tpu/ops/attention.py:302",
                "seg_dkv": "visrag_tpu/ops/attention.py:338"}


def hash_reward(reward_input):
    """A scorer for the reward manager's hook (reward.reward_function,
    reward_type "sequential"): with random weights every in-tree reward is
    equal within a prompt's group, so the advantages would all be zero;
    this one differs from response to response."""
    import zlib
    return {"overall": zlib.crc32(
        reward_input["response"].encode()) % 1000 / 1000.0}


class RLStandInTokenizer(StandInTokenizer):
    """StandInTokenizer plus what the RL driver asks of a tokenizer: decoding
    (the ids as decimal words) and `add_special_tokens`."""

    def encode(self, text, add_special_tokens=True):
        return super().encode(text)

    def decode(self, ids, skip_special_tokens=False):
        return " ".join(str(int(i)) for i in ids)

    def batch_decode(self, seqs, skip_special_tokens=False):
        return [self.decode(s) for s in seqs]


def _rl_config(out_dir, steps):
    """The RL config of phase 9: the defaults (router advantages, dual-clip
    PPO, fp32 AdamW states, lr 1e-6, 16384-token micro-batches,
    padding-free) with 4 prompts x n 4 per step, 64 response tokens, an
    in-loss KL term so that the reference policy's log-probs run, and
    hash_reward as the scorer."""
    from visrag_tpu_torch.config import RLConfig
    cfg = RLConfig()
    r = dataclasses.replace
    return r(cfg,
             rollout=r(cfg.rollout, n=4,
                       max_response_length=RL_RESPONSE_TOKENS),
             actor=r(cfg.actor, kl_coef=0.01, micro_batch_tokens=16384),
             reward=r(cfg.reward, reward_type="sequential",
                      reward_function=f"{__file__}:hash_reward"),
             trainer=r(cfg.trainer, rollout_batch_size=4, total_steps=steps,
                       save_freq=1, output_dir=out_dir))


def _rl_rows(tmp):
    """The RL data of phase 9 as a jsonl of {problem, answer, images}: two
    3-page prompts (page images written to `tmp`) and two text prompts, the
    evidence prompt around the question as in phase 7. → the jsonl's
    path."""
    import numpy as np
    from PIL import Image

    from visrag_tpu_torch.generation.prompts import build_prompt
    rng = np.random.default_rng(1)
    query = ("what was the total revenue reported for the fourth quarter "
             "and how did it compare with the previous year")
    prompt = build_prompt("evidence_prompt_grpo", query)
    rows = []
    for i, third in enumerate(PAGE_SIZES[2:]):
        paths = []
        for j, (w, h) in enumerate((PAGE_SIZES[0], PAGE_SIZES[1], third)):
            path = f"{tmp}/rl_page_{i}_{j}.png"
            Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(
                path, compress_level=0)
            paths.append(path)
        rows.append({"problem": prompt, "answer": "<answer>42</answer>",
                     "images": paths})
    for n_words in (300, 420):
        rows.insert(len(rows) - 1, {
            "problem": prompt + " " + " ".join(f"context{j}"
                                               for j in range(n_words)),
            "answer": "<answer>42</answer>"})
    path = f"{tmp}/rl_prompts.jsonl"
    with open(path, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    return path


def _packed_ids(seqlens, budget):
    """Segment ids of the first packed micro-batch the trainer builds from
    sequences of these lengths (its own grouping and packing functions),
    the number of micro-batches, and the first group's lengths and row
    width (the padded update's micro-batch: one row per sequence)."""
    import numpy as np

    from visrag_tpu_torch.rl.packing import pack_sequences
    from visrag_tpu_torch.rl.seqlen import token_budget_micro_batches
    width = -(-max(seqlens) // 128) * 128
    groups, _ = token_budget_micro_batches(seqlens, max(budget, width))
    packed, _ = pack_sequences([np.ones(seqlens[i], np.int32)
                                for i in groups[0]], width)
    return (packed.segment_ids.astype(np.int32), len(groups),
            [int(seqlens[i]) for i in groups[0]], width)


def _count_pairs(seg, qs, ks, causal):
    return sum(int(seg._visible(qs, ks, causal, r0,
                                min(r0 + 2048, qs.shape[1])).sum())
               for r0 in range(0, qs.shape[1], 2048))


def segment_bound(kind, pairs, q_rows, k_rows, b, sq, sk, h, hk, d):
    """Least time for one K4 kernel's work on this run's ids: the products
    on the visible pairs, 2 forward (QK^T, PV), 3 for dq (S, dP, dQ) and 4
    for dk/dv (S, dP, dV, dK), inputs counted on rows with a positive id
    (K/V at the kv heads), every output row written once."""
    q_in, kv_in = q_rows * h * d * 2, k_rows * hk * d * 2
    q_out, kv_out = b * sq * h * d * 2, b * sk * hk * d * 2
    stat_in, stat_out = q_rows * h * 4, b * h * sq * 4
    matmuls, nbytes = {
        "seg_fwd": (2, q_in + 2 * kv_in + q_out + stat_out),
        "seg_dq": (3, 3 * q_in + 2 * kv_in + stat_in + q_out + stat_out),
        "seg_dkv": (4, 2 * q_in + 2 * kv_in + 2 * stat_in + 2 * kv_out),
    }[kind]
    return _bound(matmuls * 2 * pairs * h * d, nbytes)


def _segment_routes(tag, launches):
    """Every K4 launch of a path on the Hopper kernels: the route counters
    against the path's K4 launches; raises if one took the mma.sync ones."""
    from visrag_tpu_torch.ops import attention as seg
    routes = seg.route_counts()
    want = {kind: {"hopper": launches[f"seg_{kind}"], "legacy": 0}
            for kind in ("fwd", "dq", "dkv")}
    if routes != want:
        raise RuntimeError(f"{tag} K4 launches by route {routes}: want "
                           f"{want}")
    log(f"{tag} K4 routes: forward {routes['fwd']['hopper']}, dq "
        f"{routes['dq']['hopper']}, dk/dv {routes['dkv']['hopper']} launches "
        f"on the Hopper kernels ({seg.HOPPER_SOURCE}), 0 on the mma.sync "
        f"ones")


def _delta_handoff(seg, q, k, v, o, do, lse, qs, ks, causal, scale):
    """The Hopper dq's delta against the mma.sync dq's, and the Hopper dk/dv
    that reads each: delta within 1e-4 of its scale (fp32, summation order
    apart), dk and dv within 1e-3 relative (a delta that differs in its last
    bits moves a bf16 dk/dv element by one rounding at most)."""
    out = []
    for legacy in (False, True):
        delta = torch.empty_like(lse)
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        seg._launch_segment("dq", q, k, v, qs, ks, causal, scale, o=o, do=do,
                            dq=torch.empty_like(q), lse=lse, delta=delta,
                            legacy=legacy)
        seg._launch_segment("dkv", q, k, v, qs, ks, causal, scale, do=do,
                            dk=dk, dv=dv, lse=lse, delta=delta)
        out.append((delta, dk, dv))
    torch.cuda.synchronize()
    (d1, k1, v1), (d0, k0, v0) = out
    d_err = (d1 - d0).abs().max().item()
    kv_err = max(_rel(k1, k0), _rel(v1, v0))
    if d_err > 1e-4 * max(1.0, d0.abs().max().item()) or kv_err > 1e-3:
        raise RuntimeError(f"the Hopper dq's delta hands dk/dv other "
                           f"values than the mma.sync dq: delta {d_err}, "
                           f"dk/dv {kv_err}")
    return {"delta_max_abs": d_err, "dkv_rel": kv_err}


def _check_segment_kernels(label, qs_np, ks_np, h, hk, d, causal, gen, *,
                           banded=False, library=True, timed=True,
                           plain=True):
    """K4 forward (+ LSE), dq and dk/dv at one shape against the plain
    version's forward and written-out backward (bf16 unit-normal q/k/v and a
    `do` that is non-zero on pad rows): each within RTOL_TRAIN relative
    Frobenius error on the rows with a positive id, the LSE within 2e-2 abs,
    every output finite, exact zeros on pad rows and pad keys. banded: the
    forward is K3 with the LSE (sorted ids) and the backward K4's kernels
    through K3's autograd, which walk only the band (sorted_ids; so timed);
    K4's own forward is checked and timed beside it. plain False: the plain
    versions are not timed. → {kind: record}."""
    from visrag_tpu_torch.ops import attention as seg
    from visrag_tpu_torch.ops import attention_kvgrid as kg
    b, sq = qs_np.shape
    sk = ks_np.shape[1]
    qs = torch.as_tensor(qs_np, device=DEV)
    ks = torch.as_tensor(ks_np, device=DEV)
    q, k, v, do = (torch.randn(shape, generator=gen, device=DEV,
                               dtype=torch.bfloat16)
                   for shape in ((b, sq, h, d), (b, sk, hk, d),
                                 (b, sk, hk, d), (b, sq, h, d)))
    scale = d ** -0.5
    q.requires_grad_(True), k.requires_grad_(True), v.requires_grad_(True)
    seg.reset_launch_counts()
    if banded:
        o = kg.flash_attention_kvgrid(q, k, v, qs)
    else:
        o = seg.flash_attention(q, k, v, qs, ks, causal=causal)
    dq, dk, dv = torch.autograd.grad(o, (q, k, v), do)
    q, k, v, o = (t.detach() for t in (q, k, v, o))
    # the routes: every head dim on the Hopper kernels (K3's forward is not
    # K4's)
    route = "hopper" if d in seg.HOPPER_HEAD_DIMS else "legacy"
    want_routes = {kind: {"hopper": 0, "legacy": 0}
                   for kind in ("fwd", "dq", "dkv")}
    for kind in ("dq", "dkv") if banded else ("fwd", "dq", "dkv"):
        want_routes[kind][route] = 1
    if seg.route_counts() != want_routes:
        raise RuntimeError(f"K4 {label}: launches by route "
                           f"{seg.route_counts()}, want {want_routes}")
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=DEV)
    delta = torch.empty_like(lse)
    o2, dq2, dk2, dv2 = (torch.empty_like(t) for t in (o, q, k, v))
    seg.segment_fwd(q, k, v, qs, ks, causal, scale, o2, lse)
    torch.cuda.synchronize()
    with torch.no_grad():
        want_o = seg.segment_attention_reference(q, k, v, qs, ks,
                                                 causal=causal)
        want_lse = seg.segment_lse_reference(q, k, qs, ks, causal, scale)
        want = seg.segment_backward_reference(q, k, v, do, qs, ks, causal,
                                              scale)
        sees = want_lse[:, 0] != seg.LSE_PAD          # (B, Sq)
        qreal, kreal = qs > 0, ks > 0
    got = {"o": (o, want_o, sees), "seg_fwd": (o2, want_o, sees),
           "seg_dq": (dq, want[0], sees), "dk": (dk, want[1], kreal),
           "dv": (dv, want[2], kreal)}
    errs = {name: (_rel(a[rows], w[rows]) if bool(rows.any()) else 0.0)
            for name, (a, w, rows) in got.items()}
    max_abs = {name: ((a[rows].float() - w[rows].float()).abs().max().item()
                      if bool(rows.any()) else 0.0)
               for name, (a, w, rows) in got.items()}
    lses = [lse]
    if banded:
        # K3's own LSE, which its backward reads
        lses.append(torch.empty_like(lse))
        kg._launch(q, k, v, qs, scale, lses[1])
        torch.cuda.synchronize()
    walks_equal = None
    if banded:
        # the sorted walk leaves out only tile pairs that hold no visible
        # pair and keeps the others' order: dq, delta, dk and dv bit for
        # bit those of the full walk
        outs = []
        for srt in (True, False):
            got = (torch.empty_like(q), torch.empty_like(lse),
                   torch.empty_like(k), torch.empty_like(v))
            seg._launch_segment("dq", q, k, v, qs, ks, causal, scale, o=o,
                                do=do, dq=got[0], lse=lses[1], delta=got[1],
                                sorted_ids=srt)
            seg._launch_segment("dkv", q, k, v, qs, ks, causal, scale, do=do,
                                dk=got[2], dv=got[3], lse=lses[1],
                                delta=got[1], sorted_ids=srt)
            outs.append(got)
        torch.cuda.synchronize()
        walks_equal = all(torch.equal(a, c) for a, c in zip(*outs))
        if not walks_equal:
            raise RuntimeError(f"K4 {label}: dq / dk/dv on the sorted walk "
                               f"differ from the full walk's")
    lse_err, lse_pad = 0.0, True
    for one in lses:
        lse_t = one.transpose(1, 2)
        if bool(sees.any()):
            lse_err = max(lse_err, (lse_t[sees] - want_lse.transpose(1, 2)[
                sees]).abs().max().item())
        lse_pad &= bool((lse_t[~sees] == seg.LSE_PAD).all())
    zeros = bool((o[~sees] == 0).all() and (dq[~sees] == 0).all()
                 and (dk[~kreal] == 0).all() and (dv[~kreal] == 0).all()
                 and lse_pad and (o2[~sees] == 0).all())
    finite = all(bool(torch.isfinite(t.float()).all())
                 for t in (o, dq, dk, dv))
    log(f"[8] K4 {label} (B {b}, Sq {sq}, Sk {sk}, heads {h}/{hk}, d {d}, "
        f"causal {causal}{', K3 forward' if banded else ''}): rel_err "
        f"o {errs['o']:.4g} (K4 forward + LSE {errs['seg_fwd']:.4g}) dq "
        f"{errs['seg_dq']:.4g} dk "
        f"{errs['dk']:.4g} dv {errs['dv']:.4g} (bound {RTOL_TRAIN}), lse "
        f"max_abs_err {lse_err:.4g}, finite {finite}, exact zeros on pad "
        f"rows and keys {zeros}"
        + ("" if walks_equal is None else
           f", dq / dk/dv on the sorted walk bit for bit the full walk's "
           f"{walks_equal}"))
    if not finite or not zeros or max(errs.values()) > RTOL_TRAIN \
            or lse_err > ATOL_KERNEL:
        raise RuntimeError(f"K4 {label}: kernels disagree with the plain "
                           f"version: {errs}, lse {lse_err}, zeros {zeros}")
    handoff = None
    if route == "hopper" and not banded:
        handoff = _delta_handoff(seg, q, k, v, o, do, lse, qs, ks, causal,
                                 scale)
        log(f"[8] K4 {label}: routes {seg.route_counts()} | the Hopper dq "
            f"hands dk/dv the delta the mma.sync dq does: delta max_abs_err "
            f"{handoff['delta_max_abs']:.3g} (bound 1e-4 of its scale), "
            f"dk/dv after each rel_err {handoff['dkv_rel']:.3g} (bound 1e-3)")
    records = {}
    if not timed:
        for kind in SEG_REPLACES:
            e = max(errs["dk"], errs["dv"]) if kind == "seg_dkv" \
                else errs[kind]
            records[kind] = {"shape": label, "rel_err": e,
                             "max_abs_err": max(max_abs["dk"], max_abs["dv"])
                             if kind == "seg_dkv" else max_abs[kind]}
        records["seg_dq"]["handoff"] = handoff
        return records
    pairs = _count_pairs(seg, qs, ks, causal)
    args = (pairs, int(qreal.sum()), int(kreal.sum()), b, sq, sk, h, hk, d)
    kern = {
        "seg_fwd": lambda: seg.segment_fwd(q, k, v, qs, ks, causal, scale, o2,
                                           lse),
        "seg_dq": lambda: seg.segment_bwd_dq(q, k, v, o, do, lse, delta, qs,
                                             ks, causal, scale, dq2,
                                             sorted_ids=banded),
        "seg_dkv": lambda: seg.segment_bwd_dkv(q, k, v, do, lse, delta, qs,
                                               ks, causal, scale, dk2, dv2,
                                               sorted_ids=banded)}
    plain_f = plain_b = None
    if plain:
        with torch.no_grad():
            plain_f = cuda_ms(lambda: seg.segment_attention_reference(
                q, k, v, qs, ks, causal=causal), reps=3)
            plain_b = cuda_ms(lambda: seg.segment_backward_reference(
                q, k, v, do, qs, ks, causal, scale), reps=3)
    lib_f = lib_b = None
    if library:
        # one segment: SDPA's own causal flag (its flash kernel); packed
        # rows: a boolean block-diagonal mask (a pad row keeps key 0 so
        # that no row of the yardstick is all masked)
        one_segment = bool((qs == 1).all()) and causal and sq == sk
        mask = None
        if not one_segment:
            mask = torch.cat([seg._visible(qs, ks, causal, r0,
                                           min(r0 + 2048, sq))
                              for r0 in range(0, sq, 2048)], dim=1)
            mask[:, :, 0] |= ~mask.any(-1)
            mask = mask[:, None]
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=one_segment,
                enable_gqa=h != hk)
        with torch.no_grad():
            lib_f = cuda_ms(sdpa)
        out = sdpa()
        dot = do.transpose(1, 2)
        lib_b = cuda_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                                    retain_graph=True))
        del out, mask
    # the mma.sync forward, dq and dk/dv at the same d, timed in turns
    # with the wgmma kernels (new, old, old, new; launched past the
    # wrappers, so they count no launch)
    pr4 = {}
    if d in seg.HOPPER_HEAD_DIMS:
        pr4 = {"seg_fwd": lambda: seg._launch_segment(
                   "fwd", q, k, v, qs, ks, causal, scale, o=o2, lse=lse,
                   legacy=True),
               "seg_dq": lambda: seg._launch_segment(
                   "dq", q, k, v, qs, ks, causal, scale, o=o, do=do, dq=dq2,
                   lse=lse, delta=delta, legacy=True),
               "seg_dkv": lambda: seg._launch_segment(
                   "dkv", q, k, v, qs, ks, causal, scale, do=do, dk=dk2,
                   dv=dv2, lse=lse, delta=delta, legacy=True)}
    for kind, fn in kern.items():
        turns = {"new": [], "pr4": []}
        for which in (("new", "pr4", "pr4", "new") if kind in pr4
                      else ("new",)):
            turns[which].append(cuda_ms(fn if which == "new" else pr4[kind]))
        ms = statistics.mean(turns["new"])
        bound = segment_bound(kind, *args)
        e = max(errs["dk"], errs["dv"]) if kind == "seg_dkv" else errs[kind]
        records[kind] = {
            "shape": label, "rel_err": e,
            "max_abs_err": max(max_abs["dk"], max_abs["dv"])
            if kind == "seg_dkv" else max_abs[kind],
            "ms": ms, "plain_ms": plain_f if kind == "seg_fwd" else plain_b,
            "library_ms": lib_f if kind == "seg_fwd" else lib_b,
            "bound_ms": bound[0], "bound_by": bound[1],
            "pr4_ms": statistics.mean(turns["pr4"]) if turns["pr4"]
            else None, "turns": turns}
    records["seg_dq"]["handoff"] = handoff
    fmt = lambda x: "n/a" if x is None else f"{x:.4f}"   # noqa: E731
    fwd, dq_r, dkv = records["seg_fwd"], records["seg_dq"], records["seg_dkv"]
    log(f"[8] K4 {label}: {pairs} visible pairs per head | forward "
        f"{fwd['ms']:.4f} ms (turns {fwd['turns']}; bound "
        f"{fwd['bound_ms']:.4f} {fwd['bound_by']}, PR 4's kernel "
        f"{fmt(fwd['pr4_ms'])}, plain {fmt(plain_f)}, SDPA {fmt(lib_f)}) | dq "
        f"{dq_r['ms']:.4f} ms (turns {dq_r['turns']}; bound "
        f"{dq_r['bound_ms']:.4f}, mma.sync {fmt(dq_r['pr4_ms'])}) | "
        f"dk/dv {dkv['ms']:.4f} ms "
        f"(turns {dkv['turns']}; bound {dkv['bound_ms']:.4f}, PR 4's kernel "
        f"{fmt(dkv['pr4_ms'])})"
        f"{' (dq, dk/dv on sorted ids)' if banded else ''}"
        f" | plain backward (all grads) {fmt(plain_b)} "
        f"ms, SDPA backward {fmt(lib_b)} ms (medians, CUDA events) | "
        f"{smi()}")
    return records


def _check_tile_classes(label, ids_np, causal):
    """The kernels' pre-pass on the card against
    segment_tile_classes_reference at every tile size the wgmma kernels
    use, and the count of skipped / masked / unmasked pairs of the
    forward's and dk/dv's tiles. Raises on any difference."""
    from visrag_tpu_torch.ops import attention as seg
    ids = torch.as_tensor(ids_np)
    tiles = seg.HOPPER_TILES
    sizes = sorted({n for bq_bk in tiles.values() for n in bq_bk})
    for tile in sizes:
        got = seg.segment_tile_classes(ids.to(DEV), tile).cpu()
        want = seg.segment_tile_classes_reference(ids, tile)
        if not torch.equal(got, want):
            raise RuntimeError(f"pre-pass at {label}, {tile}-row tiles: "
                               f"the card's classes differ from the plain "
                               f"version's")
    counts = {}
    for kind, (bq, bk) in tiles.items():
        cls = seg.segment_pair_classes_reference(
            seg.segment_tile_classes_reference(ids, bq),
            seg.segment_tile_classes_reference(ids, bk), bq, bk, causal)
        counts[kind] = [int((cls == c).sum()) for c in
                        (seg.SKIP, seg.MASKED, seg.UNMASKED)]
    log(f"[8] pre-pass at {label}: equal to segment_tile_classes_reference "
        f"at {sizes}-row tiles; pairs skipped / masked / unmasked: forward "
        f"{tiles['fwd']} tiles {counts['fwd']}, dk/dv {tiles['dkv']} tiles "
        f"{counts['dkv']}")


# SHA-256 (first 16 hex digits) of K1's, K2's and K4's outputs on
# kernel_digests()' inputs as the kernels of the tree before K3's redesign
# gave them on an H100 (`tools/torch_ab_segment.py --other DIR --digests`
# with DIR that tree). K3's band walk put hooks into the Hopper bodies that
# these kernels share; phase 8 holds them to these values bit for bit.
PARENT_DIGESTS = {
    "K1/K2 d72 fwd": "4d3391c03dff5486",
    "K1/K2 d72 dq": "01966ae934b9c9b1",
    "K1/K2 d72 dkv": "082afc7b2491f053",
    "K1/K2 d64 causal fwd": "c86dcdcde1421761",
    "K1/K2 d64 causal dq": "dce928aa893461bf",
    "K1/K2 d64 causal dkv": "c5a9dd472413e7fe",
    "K1/K2 GQA d128 causal fwd": "68343bda76836a2c",
    "K1/K2 GQA d128 causal dq": "7e34b929ab9c261b",
    "K1/K2 GQA d128 causal dkv": "a52cbcad2a99867e",
    "K4 packed d128 causal fwd": "cc64493525aa00a3",
    "K4 packed d128 causal dq": "3c786c0e180835aa",
    "K4 packed d128 causal dkv": "a366f95b5a290f81",
    "K4 edge d64 fwd": "2a6168272ee91f2a",
    "K4 edge d64 dq": "db8b7ab2f69ab913",
    "K4 edge d64 dkv": "d8fab9424a7e66ec",
}


def kernel_digests():
    """K1 (d 72 with the LSE, d 64 causal, GQA 28/4 d 128 causal), K2's dq
    and dk/dv after each, and K4's forward (+ LSE), dq (+ delta) and dk/dv
    (packed ids at 16/2 d 128 causal; pad, negative and non-ascending ids
    at d 64) on inputs made on the CPU from seed 0, through the wrappers'
    launch functions (no launch counter moves but K1's and K2's route
    counters, which the caller resets). → {case: digest of its outputs}."""
    import hashlib

    import numpy as np

    from visrag_tpu_torch.ops import attention as seg
    from visrag_tpu_torch.ops import attention_lengths as al
    g = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=g).bfloat16().to(DEV)

    def digest(*ts):
        h = hashlib.sha256()
        for t in ts:
            h.update(t.float().cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    out = {}
    for label, lens, s, h, hk, d, causal in (
            ("K1/K2 d72", [1152, 700, 0, 129], 1152, 16, 16, 72, False),
            ("K1/K2 d64 causal", [704, 300, 1], 704, 8, 8, 64, True),
            ("K1/K2 GQA d128 causal", [1024, 586], 1024, 28, 4, 128, True)):
        b = len(lens)
        q, do = rand(b, s, h, d), rand(b, s, h, d)
        k, v = rand(b, s, hk, d), rand(b, s, hk, d)
        lens_t = torch.tensor(lens, dtype=torch.int32, device=DEV)
        o = torch.empty_like(q)
        lse = torch.empty((b, h, s), dtype=torch.float32, device=DEV)
        al._fwd(q, k, v, o, lse, lens_t, causal, d ** -0.5)
        o2 = al._fwd(q, k, v, torch.empty_like(q), None, lens_t, causal,
                     d ** -0.5)
        delta = torch.empty_like(lse)
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        for kind in ("dq", "dkv"):
            al._bwd(kind, q, k, v, o, do, lse, delta, lens_t, causal,
                    d ** -0.5, dq, dk, dv)
        out[label + " fwd"] = digest(o, lse, o2)
        out[label + " dq"] = digest(dq, delta)
        out[label + " dkv"] = digest(dk, dv)
    packed = np.zeros((2, 1280), np.int32)
    packed[0, :300], packed[0, 300:500], packed[0, 500:1000] = 3, 1, 4
    packed[1, :1000], packed[1, 1000:1280] = 5, 2
    edge = np.zeros((2, 300), np.int32)
    edge[0, :1], edge[0, 1:64], edge[0, 64:128] = 5, 3, 9
    edge[0, 128:193], edge[0, 200:260] = 2, -4
    for label, ids_np, h, hk, d, causal in (
            ("K4 packed d128 causal", packed, 16, 2, 128, True),
            ("K4 edge d64", edge, 4, 4, 64, False)):
        b, s = ids_np.shape
        ids = torch.as_tensor(ids_np, device=DEV)
        q, do = rand(b, s, h, d), rand(b, s, h, d)
        k, v = rand(b, s, hk, d), rand(b, s, hk, d)
        o = torch.empty_like(q)
        lse = torch.empty((b, h, s), dtype=torch.float32, device=DEV)
        delta = torch.empty_like(lse)
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        args = (q, k, v, ids, ids, causal, d ** -0.5)
        seg._launch_segment("fwd", *args, o=o, lse=lse)
        seg._launch_segment("dq", *args, o=o, do=do, dq=dq, lse=lse,
                            delta=delta)
        seg._launch_segment("dkv", *args, do=do, dk=dk, dv=dv, lse=lse,
                            delta=delta)
        out[label + " fwd"] = digest(o, lse)
        out[label + " dq"] = digest(dq, delta)
        out[label + " dkv"] = digest(dk, dv)
    torch.cuda.synchronize()
    return out


def phase8_segment_kernels(gen, prompts, cfg):
    """K4 (forward, dq, dk/dv) and K3's backward against the plain versions
    at the packed update's shape, the 16640-token row, the 7B head grouping,
    the vision tower's ids at d = 80, and edge cases. → {kind: [records]},
    the packed update's shape first."""
    import numpy as np
    results = {kind: [] for kind in SEG_REPLACES}

    def run(label, qs, ks, h, hk, d, causal, **kw):
        for kind, rec in _check_segment_kernels(label, qs, ks, h, hk, d,
                                                causal, gen, **kw).items():
            results[kind].append(rec)

    tc = cfg.text
    h, hk, d = tc.num_attention_heads, tc.num_key_value_heads, tc.head_dim
    seqlens = [len(p["input_ids"]) + RL_RESPONSE_TOKENS
               for p in prompts for _ in range(4)]
    ids, n_micro, padded_lens, width = _packed_ids(seqlens, 16384)
    log(f"[8] the packed update of phase 9: {len(seqlens)} sequences of "
        f"{sorted(set(seqlens))} tokens → {n_micro} micro-batches; the first "
        f"packs {ids.shape[0]} rows x {ids.shape[1]} with ids "
        f"{[sorted(set(r[r > 0].tolist())) for r in ids]}")
    _check_tile_classes("the packed update", ids, True)
    run("packed update", ids, ids, h, hk, d, True)
    one = np.ones((1, 16640), np.int32)
    _check_tile_classes("one 16640-token row", one, True)
    run("one 16640-token row", one, one, h, hk, d, True)
    run("7B grouping 28/4", ids[:1, :1024], ids[:1, :1024], 28, 4, 128, True,
        library=False)
    # edges: segments of 1, 63, 64 and 65 tokens, non-ascending ids, negative
    # ids, an all-pad row, Sq != Sk
    edge = np.zeros((2, 300), np.int32)
    edge[0, :1], edge[0, 1:64], edge[0, 64:128] = 5, 3, 9
    edge[0, 128:193], edge[0, 200:260] = 2, -4
    run("edge segments", edge, edge, h, hk, d, True, timed=False)
    run("edge segments, non-causal d 64", edge, edge, 4, 4, 64, False,
        timed=False)
    # 128-row tiles: segments of 127, 128 and 129 tokens, and a row that one
    # segment fills in whole tiles (the unmasked pairs)
    tiles = np.zeros((2, 700), np.int32)
    tiles[0, :127], tiles[0, 127:255], tiles[0, 255:384] = 4, 6, 8
    tiles[1, :640] = 3
    _check_tile_classes("the 127/128/129 edges", tiles, True)
    run("127/128/129 and whole tiles", tiles, tiles, h, hk, d, True,
        timed=False)
    run("127/128/129 and whole tiles, d 64", tiles, tiles, 4, 4, 64, True,
        timed=False)
    run("127/128/129 and whole tiles, non-causal d 64", tiles, tiles, 4, 4,
        64, False, timed=False)
    qid = np.concatenate([np.full(100, 1), np.full(91, 2)])[None]
    kid = np.concatenate([np.full(150, 2), np.full(107, 1), np.zeros(20)])
    run("Sq != Sk", qid.astype(np.int32), kid[None].astype(np.int32), h, hk,
        d, True, timed=False)
    # K3's backward: the tower's window and image ids of a 3-page prompt,
    # K4's dq and dk/dv at d 80 on sorted ids (SDPA with a block mask,
    # forward and backward, as the library time); then K4 at d 80 on the
    # same ids as attn_impl="packed" runs it (the arbitrary-ids walk)
    vb = next(p["vision_batch"] for p in prompts if "vision_batch" in p)
    vc = cfg.vision
    vision = {kind: [] for kind in SEG_REPLACES}
    for name in ("seg_window", "seg_full"):
        vid = np.asarray(vb[name], np.int32)[None]
        for kind, rec in _check_segment_kernels(
                f"vision tower {name}, K3 forward + K4 backward", vid, vid,
                vc.num_heads, vc.num_heads, vc.head_dim, False, gen,
                banded=True).items():
            vision[kind].append(rec)
    vid = np.asarray(vb["seg_window"], np.int32)[None]
    for kind, rec in _check_segment_kernels(
            "vision tower seg_window, K4 (attn_impl packed)", vid, vid,
            vc.num_heads, vc.num_heads, vc.head_dim, False, gen,
            library=False, plain=False).items():
        vision[kind].append(rec)
    for kind in SEG_REPLACES:
        results[kind] += vision[kind]
    results["vision"] = vision
    results["k2"] = _k2_gqa_checks(gen, padded_lens, width, h, hk, d)
    # K1, K2 and K4 bit for bit as the kernels before K3's redesign gave
    # them (the Hopper bodies K3's band walk changed)
    from visrag_tpu_torch.ops import attention_lengths as al
    digests = kernel_digests()
    al.reset_launch_counts()
    same = {case: PARENT_DIGESTS.get(case) == got
            for case, got in digests.items()}
    log(f"[8] K1, K2 and K4 outputs at fixed inputs against the parent's "
        f"kernels' (PARENT_DIGESTS): {sum(same.values())} of {len(same)} "
        f"bit for bit equal {digests}")
    if not all(same.values()) or len(same) != len(PARENT_DIGESTS):
        differ = [c for c, ok in same.items() if not ok]
        raise RuntimeError(f"K1 / K2 / K4 outputs differ from the parent "
                           f"kernels': {differ}")
    return results


def _k2_gqa_checks(gen, lens, width, h, hk, d):
    """K1 + LSE and K2 at d = 128 with grouped kv heads, causal, against
    the plain forward and autograd (RTOL_TRAIN): the padded update's
    micro-batch (its first four rows at the batch width), the 7B grouping
    28/4 at two of its rows, and lengths 1, 63, 64, 65 and full at both
    groupings. → {"fwd_lse": [...], "dq": [...], "dkv": [...]}, the padded
    update's shape first."""
    from visrag_tpu_torch.ops import attention_lengths as al
    log(f"[8] the padded update's micro-batch: {len(lens)} rows x {width}, "
        f"lengths {lens}")
    edge = [1, 63, 64, 65, 256]
    out = {"fwd_lse": [], "dq": [], "dkv": []}
    for label, ls, s, heads, kvh in (
            (f"padded update {h}/{hk}", lens[:4], width, h, hk),
            ("padded update, 7B grouping 28/4", lens[:2], width, 28, 4),
            (f"edges {h}/{hk}", edge, 256, h, hk),
            ("edges 28/4", edge, 256, 28, 4)):
        for kind, rec in _check_training_kernels(
                al, f"K2 GQA {label}", "stacked", ls, s, heads, d, True, gen,
                DEV, kv_heads=kvh, tag="[8]").items():
            out[kind].append(rec)
        torch.cuda.empty_cache()
    return out


def _count_calls(owner, name, counts):
    """Wrap owner.name so that counts[name] counts its calls. → undo()."""
    orig = getattr(owner, name)

    def wrapped(*a, **kw):
        counts[name] = counts.get(name, 0) + 1
        return orig(*a, **kw)
    setattr(owner, name, wrapped)
    return lambda: setattr(owner, name, orig)


def _micro_check(trainer, stash, cfg):
    """One packed micro-batch of the run, three ways. (a) Its loss through
    the full model's packed forward (K4) against the same sequences' padded
    forward (K1), both without gradients. (b) Its loss and parameter
    gradients through a 2-layer model at full width with the kernels
    against the same model with the plain versions, on the card, the
    loss's branches taken at the plain log-probs in both. (c) The
    same for the padded update of those sequences (padding_free=False or a
    raw vision batch): K1 with the LSE forward, K2 backward at d = 128 with
    grouped kv heads. → the padded update's launch counts."""
    from visrag_tpu_torch.driver.common import build_qwen25_vl
    from visrag_tpu_torch.models import qwen25_vl as qmod
    from visrag_tpu_torch.ops import attention as seg
    from visrag_tpu_torch.ops import attention_lengths as al
    from visrag_tpu_torch.rl.trainer import RLTrainer, _reindex
    micro, mini, group, total = stash["micro"], stash["mini"], \
        stash["group"], stash["total"]
    with torch.no_grad():
        packed_loss, pm = trainer.micro_loss(micro, total, True)
        padded = trainer._put_batch(_reindex(mini, list(group)))
        padded_loss, _ = trainer.micro_loss(padded, total, False)
    a, b = float(packed_loss), float(padded_loss)
    tol = RTOL_BLOCK * max(1.0, abs(b))
    log(f"[9] one packed micro-batch ({tuple(micro['input_ids'].shape)}, "
        f"{int((micro['segment_ids'] > 0).sum())} tokens): loss packed (K4) "
        f"{a:.6f} vs padded (K1, no gradient) {b:.6f}, |diff| "
        f"{abs(a - b):.3g} (bound {tol:.3g}), ppo_kl "
        f"{float(pm['ppo_kl']):.3g}")
    if not math.isfinite(a) or abs(a - b) > tol:
        raise RuntimeError(f"packed loss {a} vs padded loss {b}")

    small = dataclasses.replace(
        cfg, text=dataclasses.replace(cfg.text, num_hidden_layers=2),
        vision=dataclasses.replace(cfg.vision, depth=1))
    model = build_qwen25_vl(small, device=DEV, seed=1)
    probe = RLTrainer(model, trainer.cfg, tokenizer_decode=lambda ids: "",
                      tag_token_ids={}, reward_manager=trainer.reward_manager)

    def plain_lengths(q, k, v, lengths, causal, sm_scale):
        # one row at a time, recomputed in the backward: a row's fp32
        # (heads, S, S) scores are 1.5 GB at S = 4864
        from torch.utils.checkpoint import checkpoint
        return torch.cat([checkpoint(
            al.lengths_attention_reference, q[i:i + 1], k[i:i + 1],
            v[i:i + 1], lengths[i:i + 1], causal, sm_scale,
            use_reentrant=False) for i in range(q.shape[0])])
    # (b) the packed update through K4, and (c) the padded update through
    # K1 with the LSE and K2 (d = 128, grouped kv heads), each against the
    # plain versions. The PPO loss is piecewise in the log-probs (the clip
    # ratios, the dual clip, the clamps): a token whose log-prob the kernels
    # move across a boundary flips its whole gradient term. So the kernels'
    # run takes its branches at the plain run's log-probs, value of the
    # plain log-prob and gradient of its own (straight through), and its
    # gradients differ from the plain run's only by the kernels' error; the
    # loss is compared at the kernels' own log-probs.
    out, k2_launches, k2_by_d = {}, {}, {}
    terms = probe._ppo_terms
    for layout, batch, packed in (("packed", micro, True),
                                  ("padded", padded, False)):
        plain_logp = {}
        for which in ("plain", "kernels"):
            if which == "plain":
                qmod.flash_attention = \
                    lambda q, k, v, qs, ks, causal: \
                    seg.segment_attention_reference(q, k, v, qs, ks,
                                                    causal=causal)
                qmod.flash_fwd_lengths = plain_lengths

                def probe_terms(logp, b, t):
                    plain_logp["x"] = logp.detach()
                    return terms(logp, b, t)
            else:
                def probe_terms(logp, b, t):
                    own = terms(logp.detach(), b, t)[0].item()
                    plain_logp["own_loss"] = own
                    st = plain_logp["x"] + (logp - logp.detach())
                    return terms(st, b, t)
            probe._ppo_terms = probe_terms
            al.reset_launch_counts()
            try:
                loss, _ = probe.micro_loss(batch, total, packed)
                loss.backward()
            finally:
                qmod.flash_attention = seg.flash_attention
                qmod.flash_fwd_lengths = al.flash_fwd_lengths
                probe._ppo_terms = terms
            if which == "kernels" and layout == "padded":
                k2_launches = al.launch_counts()
                k2_by_d = _lengths_routes("[9] the padded update:",
                                          k2_launches)
            value = plain_logp["own_loss"] if which == "kernels" \
                else loss.item()
            out[layout, which] = (value, [p.grad.float().clone()
                                          for p in probe.train_params])
            for p in probe.train_params:
                p.grad = None
    layers = small.text.num_hidden_layers
    # whole-block remat runs each layer's forward again in the backward
    passes = 2 if small.text.remat and small.text.remat != "mlp" else 1
    if k2_launches != {"flat": 0, "stacked": 0, "fwd_lse": passes * layers,
                       "dq": layers, "dkv": layers}:
        raise RuntimeError(f"the padded update's launches {k2_launches}")
    for layout in ("packed", "padded"):
        (lk, gk), (lp, gp) = out[layout, "kernels"], out[layout, "plain"]
        num = math.sqrt(sum(float(((x - y) ** 2).sum())
                            for x, y in zip(gk, gp)))
        den = math.sqrt(sum(float((y ** 2).sum()) for y in gp))
        kern = "K4" if layout == "packed" else "K1 + LSE, K2 GQA d=128"
        shape = tuple((micro if layout == "packed" else padded)[
            "input_ids"].shape)
        log(f"[9] the same micro-batch, {layout} {shape}, through 2 layers at "
            f"full width: loss {lk:.6f} ({kern}) vs {lp:.6f} (plain), "
            f"parameter gradients rel_err {num / den:.4g} (bound "
            f"{RTOL_GRADS}), norm {den:.4g}"
            + (f", launches {k2_launches}" if layout == "padded" else ""))
        if abs(lk - lp) > RTOL_BLOCK * max(1.0, abs(lp)) or not den > 0 \
                or num / den > RTOL_GRADS:
            raise RuntimeError(f"{layout} micro-batch gradients through the "
                               f"kernels disagree with the plain versions")
    del model, probe, out
    gc.collect()
    torch.cuda.empty_cache()
    return {**k2_launches, "k2_by_head_dim": k2_by_d}


def phase9_rl(rows_path, cfg, tmp):
    """The RS-GRPO slice at Qwen2.5-VL-3B's full width on random weights from
    seed 0: two steps through rl_main's build_trainer and run_training (the
    second one resumed from the first one's checkpoint). → launch counts of
    the run."""
    from visrag_tpu_torch.driver.common import (build_qwen25_vl,
                                                encode_qwen_prompt_row)
    from visrag_tpu_torch.driver.rl_main import build_trainer, run_training
    from visrag_tpu_torch.ops import attention as seg
    from visrag_tpu_torch.ops import attention_kvgrid as kg
    from visrag_tpu_torch.ops import attention_lengths as al
    from visrag_tpu_torch.rl.trainer import RLTrainer
    from visrag_tpu_torch.serving import paged_kv as pk
    from visrag_tpu_torch.serving.engine import Engine
    tok = RLStandInTokenizer()
    out_dir = f"{tmp}/rl_out"
    rcfg = _rl_config(out_dir, 1)
    t0 = time.perf_counter()
    model = build_qwen25_vl(cfg, device=DEV, seed=0)
    ref_model = copy.deepcopy(model)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    trainer = build_trainer(model, rcfg, tok, tok, ref_model=ref_model)
    n_train = sum(p.numel() for p in trainer.train_params)
    tower_before = [p.detach().clone() for p in model.visual.parameters()]
    text_before = [p.detach().double().abs().sum().item()
                   for p in trainer.train_params]

    def encode_row(row):
        return encode_qwen_prompt_row(row, tok, tok, cfg, rcfg.rollout)

    counts, stash, rollouts = {}, {}, []
    undo = [_count_calls(Engine, name, counts) for name in (
        "_prefill_one", "_prefill_many", "_advance_chunk", "_decode_chunk",
        "set_params")]
    undo.append(_count_calls(trainer, "_logp_fn", counts))
    undo.append(_count_calls(model, "encode_images", counts))
    pack, roll = trainer._pack_micro, trainer.rollout

    def pack_micro(mini, g, seqlens, width):
        counts["_pack_micro"] = counts.get("_pack_micro", 0) + 1
        micro = pack(mini, g, seqlens, width)
        if "micro" not in stash:
            stash.update(micro=micro, mini=mini, group=list(g),
                         total=trainer._put(mini["reward_masks"].sum((0, 2))
                                            .astype("float32")))
        return micro

    def rollout(*a, **kw):
        rb = roll(*a, **kw)
        rollouts.append(rb)
        stash["prefix_after_sleep"] = len(trainer._engine._prefix_cache or ())
        return rb
    trainer._pack_micro, trainer.rollout = pack_micro, rollout

    batches = _capture_batches(trainer)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in (al, kg, pk, seg):
        mod.reset_launch_counts()
    history = run_training(trainer, rcfg, rows_path, encode_row)
    # the second step: a run that resumes from the first one's checkpoint
    saved = dict(step=trainer.step, uid=trainer._uid_next,
                 rng=trainer._rng.get_state().clone(),
                 cursor=trainer.data_iter.state())
    trainer.step, trainer._uid_next, trainer._rng = 0, 0, None
    rcfg2 = _rl_config(out_dir, RL_STEPS)
    rcfg2 = dataclasses.replace(rcfg2, trainer=dataclasses.replace(
        rcfg2.trainer, save_freq=0))
    trainer.cfg = rcfg2
    t0 = time.perf_counter()
    resumed_ok = []
    resume = trainer.maybe_resume

    def maybe_resume():
        ok = resume()
        resumed_ok.append(
            ok and trainer.step == saved["step"]
            and trainer._uid_next == saved["uid"]
            and torch.equal(trainer._rng.get_state(), saved["rng"])
            and trainer.data_iter.state() == saved["cursor"])
        stash["resume_s"] = time.perf_counter() - t0
        shutil.rmtree(out_dir)          # 32 GB back before the run goes on
        return ok
    trainer.maybe_resume = maybe_resume
    history += run_training(trainer, rcfg2, rows_path, encode_row,
                            save_final=False)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for u in undo:
        u()
    launches = {**al.launch_counts(), "kvgrid": kg.launches,
                "kvgrid_lse": kg.lse_launches, "paged": pk.launches,
                "paged_legacy": pk.legacy_launches,
                **seg.launch_counts(), "chunk": seg.chunk_launches}
    _lengths_routes("[9]", launches)
    _segment_routes("[9]", launches)
    _kvgrid_routes("[9]")
    if resumed_ok != [True]:
        raise RuntimeError(f"the second run did not resume at step 1 with "
                           f"the saved rng and data cursor: {resumed_ok}")
    if [s for s, _ in history] != [1, 2]:
        raise RuntimeError(f"steps {[s for s, _ in history]} != [1, 2]")

    layers, depth = cfg.text.num_hidden_layers, cfg.vision.depth
    engine = trainer._engine
    if engine.block_size != 8:
        raise RuntimeError(f"the rollout engine's block size is "
                           f"{engine.block_size}: rl_main's max_len "
                           f"{engine.max_len} should give the JAX driver's 8")
    micro_n = counts["_pack_micro"]
    want = {"flat": 0, "fwd_lse": 0, "dq": 0, "dkv": 0, "kvgrid_lse": 0,
            "stacked": layers * (counts.get("_prefill_one", 0)
                                 + counts.get("_prefill_many", 0)
                                 + counts["_logp_fn"]),
            "kvgrid": depth * counts["encode_images"],
            "paged": layers * counts["_decode_chunk"] * engine.chunk,
            "paged_legacy": 0,
            "seg_fwd": 2 * layers * micro_n, "seg_dq": layers * micro_n,
            "seg_dkv": layers * micro_n,
            "chunk": layers * counts.get("_advance_chunk", 0)}
    if launches != want or not want["chunk"]:
        raise RuntimeError(f"RL launches {launches} != {want} (calls "
                           f"{counts})")
    image_id = StandInTokenizer.SPECIAL["<|image_pad|>"]
    responses = [r for rb in rollouts for r in rb.responses]
    if any(image_id in r for r in responses) or len(responses) != 32 \
            or any(not r for r in responses):
        raise RuntimeError("a response is empty or holds the image token")
    if stash["prefix_after_sleep"] != 0 or counts["set_params"] != 1:
        raise RuntimeError(f"prefix cache not empty after the rollout, or "
                           f"set_params ran {counts['set_params']} times")
    for step, m in history:
        if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
                and m["grad_norm"] > 0 and m["grad_skipped"] == 0):
            raise RuntimeError(f"step {step}: loss {m['loss']}, grad_norm "
                               f"{m['grad_norm']}, skipped "
                               f"{m['grad_skipped']}")
    if not all(torch.equal(a, b) for a, b in
               zip(tower_before, model.visual.parameters())):
        raise RuntimeError("the frozen vision tower's weights moved")
    prompt_tokens = sorted({
        int(x) for rb in rollouts
        for x in rb.attention_mask.sum(1) - rb.response_mask.sum(1)})
    moved = sum(a != p.detach().double().abs().sum().item()
                for a, p in zip(text_before, trainer.train_params))
    if moved == 0:
        raise RuntimeError("no text parameter changed")
    log(f"[9] Qwen2.5-VL-3B full width bf16, whole-block remat, "
        f"{n_train / 1e9:.3f}B trained parameters + frozen tower + frozen "
        f"reference policy (init {init_s:.1f} s), fp32 AdamW states, lr "
        f"{rcfg.actor.lr} | engine {engine.num_slots} slots, max_len "
        f"{engine.max_len}, {engine.block_size}-token pool blocks (every K5 "
        f"launch on the new kernel, none on the first), chunked prefill "
        f"{engine.chunk_tokens}, prefix "
        f"cache on | {RL_STEPS} steps of 4 prompts x n 4 (prompt tokens "
        f"{prompt_tokens}), {RL_RESPONSE_TOKENS} response tokens | calls "
        f"{counts} | launches {launches} (= reckoned) | {moved} of "
        f"{len(text_before)} text tensors changed, tower bit-identical | "
        f"checkpoint resumed at step 1 with the saved rng and data cursor "
        f"({stash['resume_s']:.1f} s to load) | peak memory {peak_gb:.2f} "
        f"GB | {smi()}")
    for step, m in history:
        split = {k[len("timing_s/"):]: round(v, 3) for k, v in m.items()
                 if k.startswith("timing_s/")}
        log(f"[9] step {step}: loss {m['loss']:.6f}, grad_norm "
            f"{m['grad_norm']:.4g}, kl_loss {m.get('kl_loss', 0.0):.3g}, "
            f"reward_mean {m['reward_mean']:.3f} | seconds {split} | "
            f"{m['perf/throughput']:.1f} tokens/s")
    launches["padded_update"] = _micro_check(trainer, stash, cfg)
    # what phase 16 holds RS-GRPO across ranks to
    launches["reference"] = ([m for _, m in history], batches)
    del trainer, model, ref_model, engine, stash, rollouts
    gc.collect()
    torch.cuda.empty_cache()
    return launches


SFT_STEPS = 3
SFT_BATCH = 4              # the SFT driver's default --batch-size
SFT_MAX_LEN = 4096         # the SFT driver's default --max-len
SFT_LR = 1e-4              # large enough that bf16 text weights move
# (prompt words, response words) of the SFT rows, 4 per step: the first
# row of each batch runs past --max-len and is cut at 4096 tokens
SFT_ROWS = [(3600, 900), (2500, 500), (1500, 300), (500, 150),
            (3000, 1500), (2000, 1000), (1200, 400), (300, 200),
            (4200, 100), (1800, 900), (900, 600), (100, 60)]
GAE_LAYERS = 12            # text depth of phase 11: actor, critic, engine


def _sft_rows(tmp):
    """The SFT data of phase 10 as a jsonl of {prompt, response}: words
    that StandInTokenizer maps to one token each. → the jsonl's path."""
    path = f"{tmp}/sft_rows.jsonl"
    with open(path, "w") as f:
        for i, (np_, nr) in enumerate(SFT_ROWS):
            f.write(json.dumps({
                "prompt": " ".join(f"q{i}w{j}" for j in range(np_)),
                "response": " ".join(f"a{i}w{j}" for j in range(nr))})
                + "\n")
    return path


def _sft_micro_check(batch, cfg):
    """One SFT batch's loss and parameter gradients through a 2-layer
    model at full width, the kernels (K1 + LSE, K2 GQA d = 128, K7)
    against the plain versions, on the card (RTOL_GRADS relative).
    → the kernels' launch counts."""
    from torch.utils.checkpoint import checkpoint

    from visrag_tpu_torch.driver.common import build_qwen25_vl
    from visrag_tpu_torch.models import qwen25_vl as qmod
    from visrag_tpu_torch.ops import attention_lengths as al
    from visrag_tpu_torch.ops import norms
    from visrag_tpu_torch.training.sft import sft_loss
    small = dataclasses.replace(
        cfg, text=dataclasses.replace(cfg.text, num_hidden_layers=2),
        vision=dataclasses.replace(cfg.vision, depth=1))
    model = build_qwen25_vl(small, device=DEV, seed=1)
    model.visual.requires_grad_(False)
    dev = {k: torch.as_tensor(v, device=DEV) for k, v in batch.items()}
    params = [p for p in model.parameters() if p.requires_grad]

    def plain_lengths(q, k, v, lengths, causal, sm_scale):
        # one row at a time, recomputed in the backward
        return torch.cat([checkpoint(
            al.lengths_attention_reference, q[i:i + 1], k[i:i + 1],
            v[i:i + 1], lengths[i:i + 1], causal, sm_scale,
            use_reentrant=False) for i in range(q.shape[0])])
    out, launches = {}, {}

    def loss_and_grads():
        loss, _ = sft_loss(model, dev)
        loss.backward()
        return loss
    for which in ("kernels", "plain"):
        al.reset_launch_counts()
        norms.reset_launch_counts()
        if which == "plain":
            qmod.flash_fwd_lengths = plain_lengths
            try:
                loss = _with_plain_norms(loss_and_grads)
            finally:
                qmod.flash_fwd_lengths = al.flash_fwd_lengths
        else:
            loss = loss_and_grads()
        if which == "kernels":
            launches = {**al.launch_counts(), **norms.launch_counts()}
            _lengths_routes("[10] one batch through 2 layers:", launches)
        out[which] = (loss.item(), [p.grad.float().clone() for p in params])
        for p in params:
            p.grad = None
    (lk, gk), (lp, gp) = out["kernels"], out["plain"]
    num = math.sqrt(sum(float(((x - y) ** 2).sum()) for x, y in zip(gk, gp)))
    den = math.sqrt(sum(float((y ** 2).sum()) for y in gp))
    layers = small.text.num_hidden_layers
    want = {"flat": 0, "stacked": 0, "fwd_lse": 2 * layers, "dq": layers,
            "dkv": layers, "rmsnorm": 4 * layers + 1, "layernorm": 0}
    log(f"[10] one SFT batch {tuple(batch['input_ids'].shape)} through 2 "
        f"layers at full width: loss {lk:.6f} (K1 + LSE, K2 GQA d=128, K7) "
        f"vs {lp:.6f} (plain), parameter gradients rel_err {num / den:.4g} "
        f"(bound {RTOL_GRADS}), norm {den:.4g}, launches {launches}")
    if launches != want:
        raise RuntimeError(f"SFT probe launches {launches} != {want}")
    if abs(lk - lp) > RTOL_BLOCK * max(1.0, abs(lp)) or not den > 0 \
            or num / den > RTOL_GRADS:
        raise RuntimeError("SFT gradients through the kernels disagree with "
                           "the plain versions")
    del model, out
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase10_sft(tmp):
    """EVisRAG stage-1 SFT at Qwen2.5-VL-3B's full width on random weights
    from seed 0, whole-block remat, the tower frozen, through sft_main's
    build_sft and run_sft: 3 steps of 4 right-padded rows (warmup 1 step,
    fp32 AdamW states). → the run's launch counts."""
    from visrag_tpu_torch.driver import sft_main
    from visrag_tpu_torch.driver.common import build_qwen25_vl
    from visrag_tpu_torch.models.qwen25_vl import Qwen25VLConfig
    from visrag_tpu_torch.ops import attention_lengths as al
    from visrag_tpu_torch.ops import norms
    from visrag_tpu_torch.training.checkpoint import (find_latest_ckpt,
                                                      load_checkpoint)
    from visrag_tpu_torch.training.sft import SFTConfig
    cfg = Qwen25VLConfig.b3()
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text,
                                                            remat=True))
    scfg = SFTConfig(lr=SFT_LR, warmup_steps=1, total_steps=SFT_STEPS,
                     optimizer_state_dtype="float32")
    tok = RLStandInTokenizer()
    rows_path = _sft_rows(tmp)
    out_dir = f"{tmp}/sft_out"
    resident_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    model = build_qwen25_vl(cfg, device=DEV, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    _, step = sft_main.build_sft(model, scfg)
    tower_before = [p.detach().clone() for p in model.visual.parameters()]
    train = [p for p in model.parameters() if p.requires_grad]
    text_before = [p.detach().double().abs().sum().item() for p in train]
    batches, times = [], []
    make = sft_main.make_sft_batch

    def make_batch(pairs):
        batches.append(make(pairs))
        return batches[-1]

    def timed_step(batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        return m
    sft_main.make_sft_batch = make_batch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    al.reset_launch_counts()
    norms.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        history = sft_main.run_sft(
            model, timed_step, scfg, rows_path,
            lambda row: sft_main.encode_sft_row(row, tok, tok, SFT_MAX_LEN),
            batch_size=SFT_BATCH, output_dir=out_dir)
    finally:
        sft_main.make_sft_batch = make
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {**al.launch_counts(), **norms.launch_counts()}
    k2_by_d = _lengths_routes("[10]", launches)
    log(f"[10] RMSNorm launches by kernel: {norms.route_counts()}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    layers = cfg.text.num_hidden_layers
    n = len(history)
    want = {"flat": 0, "stacked": 0, "fwd_lse": 2 * layers * n,
            "dq": layers * n, "dkv": layers * n,
            "rmsnorm": (4 * layers + 1) * n, "layernorm": 0}
    if n != SFT_STEPS or launches != want:
        raise RuntimeError(f"SFT: {n} steps, launches {launches} != {want}")
    for i, m in enumerate(history):
        if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
                and m["grad_norm"] > 0):
            raise RuntimeError(f"SFT step {i + 1}: {m}")
    if not all(torch.equal(a, b) for a, b in
               zip(tower_before, model.visual.parameters())):
        raise RuntimeError("SFT moved the frozen vision tower")
    moved = sum(a != p.detach().double().abs().sum().item()
                for a, p in zip(text_before, train))
    if moved == 0:
        raise RuntimeError("SFT changed no text parameter")
    t0 = time.perf_counter()
    ck = find_latest_ckpt(out_dir)
    tree, _ = load_checkpoint(ck)
    live = model.state_dict()
    if not ck.endswith(f"global_step_{SFT_STEPS}") or set(tree["model"]) \
            != set(live) or not all(torch.equal(tree["model"][k],
                                                live[k].cpu())
                                    for k in live):
        raise RuntimeError(f"the SFT checkpoint {ck} does not read back as "
                           f"the trained weights")
    ck_gb = sum(t.numel() * t.element_size()
                for t in tree["model"].values()) / 1e9
    read_s = time.perf_counter() - t0
    del tree, live
    shutil.rmtree(out_dir)
    lens = [[int(x) for x in b["attention_mask"].sum(1)] for b in batches]
    tokens = [sum(x) for x in lens]
    log(f"[10] SFT Qwen2.5-VL-3B full width bf16, whole-block remat, "
        f"{sum(p.numel() for p in train) / 1e9:.3f}B trained parameters, "
        f"tower frozen (init {init_s:.1f} s), fp32 AdamW, lr {SFT_LR} after "
        f"1 warmup step | {n} steps of {SFT_BATCH} rows, lengths {lens}, "
        f"padded to {[b['input_ids'].shape[1] for b in batches]} | launches "
        f"{launches} (= reckoned: K1 + LSE 2 x {layers}, K2 dq and dk/dv "
        f"{layers}, K7 RMSNorm 4 x {layers} + 1 per step) | {moved} of "
        f"{len(train)} text tensors changed, tower bit-identical | "
        f"checkpoint {ck_gb:.2f} GB read back equal in {read_s:.1f} s | "
        f"run_sft {run_s:.1f} s | peak memory {peak_gb:.2f} GB (resident "
        f"before the model {resident_gb:.2f} GB) | {smi()}")
    for i, (m, t, k) in enumerate(zip(history, times, tokens)):
        log(f"[10] step {i + 1}: loss {m['loss']:.6f}, token_accuracy "
            f"{m['token_accuracy']:.4f}, grad_norm {m['grad_norm']:.4g} | "
            f"{t:.3f} s/step, {k / t:.1f} tokens/s ({k} tokens)")
    del model, step, timed_step, train, tower_before
    gc.collect()
    torch.cuda.empty_cache()
    probe = _sft_micro_check(batches[0], cfg)
    return {"run": launches, "probe": probe, "k2_by_head_dim": k2_by_d,
            "history": history}


def _checksums(tensors):
    return [t.detach().double().abs().sum().item() for t in tensors]


def phase11_gae(rows_path, tmp):
    """One GAE RS-GRPO run at Qwen2.5-VL-3B's full width with the text
    depth cut to GAE_LAYERS, through rl_main's build_critic, build_trainer
    and run_training: two steps with critic_warmup 1 (step 1 trains the
    critic only, step 2 both), phase 9's prompts and reward, the critic's
    state saved at step 2 and restored by maybe_resume. → the run's launch
    counts."""
    import pathlib

    import numpy as np

    from visrag_tpu_torch.driver.common import (build_qwen25_vl,
                                                encode_qwen_prompt_row)
    from visrag_tpu_torch.driver.rl_main import (build_critic, build_trainer,
                                                 run_training)
    from visrag_tpu_torch.models.qwen25_vl import Qwen25VLConfig
    from visrag_tpu_torch.ops import attention as seg
    from visrag_tpu_torch.ops import attention_kvgrid as kg
    from visrag_tpu_torch.ops import attention_lengths as al
    from visrag_tpu_torch.ops import norms
    from visrag_tpu_torch.serving import paged_kv as pk
    cfg = Qwen25VLConfig.b3()
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, remat=True, num_hidden_layers=GAE_LAYERS))
    out_dir = f"{tmp}/gae_out"
    r = dataclasses.replace
    rcfg = _rl_config(out_dir, 2)
    rcfg = r(rcfg, algorithm=r(rcfg.algorithm, adv_estimator="gae"),
             actor=r(rcfg.actor, kl_coef=0.0),
             trainer=r(rcfg.trainer, critic_warmup=1, save_freq=2))
    tok = RLStandInTokenizer()
    resident_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    model = build_qwen25_vl(cfg, device=DEV, seed=0)
    critic = build_critic(model, rcfg, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    trainer = build_trainer(model, rcfg, tok, tok, critic=critic)
    actor0 = _checksums(trainer.train_params)
    critic0 = _checksums(critic.params)
    seen = []
    update = critic.update

    def spy_update(batch):
        # the actor's update (if any) of this step has run
        seen.append({"actor": _checksums(trainer.train_params),
                     "adv_finite": bool(np.isfinite(batch["advantages"])
                                        .all()),
                     "ret_finite": bool(np.isfinite(batch["returns"]).all()),
                     "values_finite": bool(np.isfinite(batch["values"])
                                           .all())})
        m = update(batch)
        seen[-1]["critic"] = _checksums(critic.params)
        return m
    critic.update = spy_update

    def encode_row(row):
        return encode_qwen_prompt_row(row, tok, tok, cfg, rcfg.rollout)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    batches = _capture_batches(trainer)
    for mod in (al, kg, pk, seg, norms):
        mod.reset_launch_counts()
    t0 = time.perf_counter()
    history = run_training(trainer, rcfg, rows_path, encode_row)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {**al.launch_counts(), "kvgrid": kg.launches,
                "paged": pk.launches, "paged_legacy": pk.legacy_launches,
                **seg.launch_counts(),
                **norms.launch_counts()}
    k2_by_d = _lengths_routes("[11]", launches)
    _segment_routes("[11]", launches)
    _kvgrid_routes("[11]")
    critic.update = update
    if [s for s, _ in history] != [1, 2] or len(seen) != 2:
        raise RuntimeError(f"GAE steps {[s for s, _ in history]}, critic "
                           f"updates {len(seen)}")
    m1, m2 = history[0][1], history[1][1]
    if "loss" in m1 or "loss" not in m2:
        raise RuntimeError("critic_warmup=1: step 1 must skip the actor "
                           "and step 2 run it")
    for step, m in history:
        for k in ("critic/vf_loss", "critic/grad_norm",
                  "critic/advantages/mean", "critic/returns/mean",
                  "critic/values/mean"):
            if not math.isfinite(m[k]):
                raise RuntimeError(f"GAE step {step}: {k} = {m[k]}")
    if not all(x["adv_finite"] and x["ret_finite"] and x["values_finite"]
               for x in seen):
        raise RuntimeError("GAE: non-finite values, advantages or returns")
    if seen[0]["actor"] != actor0 or seen[1]["actor"] == actor0:
        raise RuntimeError("the actor's weights must hold through step 1 "
                           "and move in step 2")
    if seen[0]["critic"] == critic0 or seen[1]["critic"] == seen[0]["critic"]:
        raise RuntimeError("the critic's weights did not move")
    if not all(launches[k] > 0 for k in ("stacked", "fwd_lse", "dq", "dkv",
                                          "kvgrid", "paged", "rmsnorm")) \
            or launches["paged_legacy"]:
        raise RuntimeError(f"GAE launches {launches}")
    # resume: zero the critic's weights and moments, restore them
    states = [st for st in critic.optimizer.state.values()]
    saved = (_checksums(critic.params),
             [_checksums(st.values()) for st in states],
             critic.optimizer.count)
    t0 = time.perf_counter()
    with torch.no_grad():
        for p in critic.params:
            p.zero_()
        for st in states:
            for t in st.values():
                t.zero_()
    critic.optimizer.count = 0
    trainer.step = 0
    ok = trainer.maybe_resume()
    resume_s = time.perf_counter() - t0
    got = (_checksums(critic.params),
           [_checksums(st.values()) for st in states],
           critic.optimizer.count)
    ck_gb = sum(f.stat().st_size
                for f in pathlib.Path(out_dir).rglob("*.pt")) / 1e9
    shutil.rmtree(out_dir)
    if not ok or trainer.step != 2 or got != saved:
        raise RuntimeError("the resume did not restore the critic's weights "
                           "and optimizer state")
    n_actor = sum(p.numel() for p in trainer.train_params)
    n_critic = sum(p.numel() for p in critic.params)
    log(f"[11] GAE RS-GRPO, Qwen2.5-VL-3B full width with the text depth "
        f"cut to {GAE_LAYERS} of {Qwen25VLConfig.b3().text.num_hidden_layers}"
        f" layers (actor, critic and engine on one card), whole-block remat "
        f"| actor {n_actor / 1e9:.3f}B + critic {n_critic / 1e9:.3f}B "
        f"trained parameters, fp32 AdamW (init {init_s:.1f} s) | 2 steps "
        f"of 4 prompts x n 4, {RL_RESPONSE_TOKENS} response tokens, "
        f"critic_warmup 1: actor held in step 1, moved in step 2; critic "
        f"moved in both | launches {launches} | checkpoint {ck_gb:.2f} GB, "
        f"critic weights and moments restored in {resume_s:.1f} s | "
        f"run_training {run_s:.1f} s | peak memory {peak_gb:.2f} GB "
        f"(resident before the models {resident_gb:.2f} GB) | {smi()}")
    for step, m in history:
        split = {k[len("timing_s/"):]: round(v, 3) for k, v in m.items()
                 if k.startswith("timing_s/")}
        log(f"[11] step {step}: vf_loss {m['critic/vf_loss']:.6f}, critic "
            f"grad_norm {m['critic/grad_norm']:.4g}, advantages mean "
            f"{m['critic/advantages/mean']:.4g}, returns mean "
            f"{m['critic/returns/mean']:.4g}, explained var "
            f"{m['critic/vf_explained_var']:.4g}"
            + (f", actor loss {m['loss']:.6f}" if "loss" in m else
               ", actor not updated (critic warmup)")
            + f" | seconds {split}")
    del trainer, critic, model
    gc.collect()
    torch.cuda.empty_cache()
    return {**launches, "k2_by_head_dim": k2_by_d,
            "reference": ([m for _, m in history], batches)}


def rl_phases(gen):
    """Phases 8, 9, 10 and 11. → (K4's check records, the RL run's launch
    counts, SFT's, GAE's)."""
    from visrag_tpu_torch.driver.common import encode_qwen_prompt_row
    from visrag_tpu_torch.models.qwen25_vl import Qwen25VLConfig
    rl_cfg = Qwen25VLConfig.b3()
    rl_cfg = dataclasses.replace(rl_cfg, text=dataclasses.replace(
        rl_cfg.text, remat=True))
    work = tempfile.mkdtemp(prefix="visrag_rl_")
    try:
        t0 = time.perf_counter()
        rows_path = _rl_rows(work)
        tok = RLStandInTokenizer()
        rollout_cfg = _rl_config(work, 1).rollout
        with open(rows_path) as f:
            prompts = [encode_qwen_prompt_row(json.loads(line), tok, tok,
                                              rl_cfg, rollout_cfg)
                       for line in f]
        log(f"[8] four RL prompts written and encoded by the driver's "
            f"encode_qwen_prompt_row in {time.perf_counter() - t0:.2f} s "
            f"(prompt tokens {[len(p['input_ids']) for p in prompts]})")
        seg_results = phase8_segment_kernels(gen, prompts, rl_cfg)
        del prompts
        rl_launches = phase9_rl(rows_path, rl_cfg, work)
        # phase 9's trainer sits in reference cycles (its wrapped methods):
        # collect them before the next 3B model is built
        gc.collect()
        torch.cuda.empty_cache()
        tc = rl_cfg.text        # K8 at the rollout's chunks: 16/2, d 128
        rl_launches["chunk_checks"] = _k8_checks(
            gen, tc.num_attention_heads, tc.num_key_value_heads, tc.head_dim,
            phase="[9]")
        sft_launches = phase10_sft(work)
        gc.collect()
        torch.cuda.empty_cache()
        gae_launches = phase11_gae(rows_path, work)
        return seg_results, rl_launches, sft_launches, gae_launches
    finally:
        shutil.rmtree(work, ignore_errors=True)


# --- VisRAG-Gen (phases 12-14) ------------------------------------------------

GEN_NEW_TOKENS = 20       # generate_eval's --max-new-tokens default
GEN_TOPK = 3              # pages per query
GEN_QUERIES = 2


def _gen_corpus(seed):
    """3 synthetic pages at bench.py's size mix, 2 queries whose TREC run
    ranks all three, and a text doc per page for the text backend."""
    import numpy as np
    from PIL import Image
    rng = np.random.default_rng(seed)
    pages = {f"page{i}": Image.fromarray(rng.integers(
        0, 255, (h, w, 3), dtype=np.uint8))
        for i, (w, h) in enumerate(PAGE_SIZES[:GEN_TOPK])}
    examples = [dict(qid=f"q{i}-0", answer="42",
                     query=f"what was the total revenue reported for "
                           f"quarter {i + 1}?")
                for i in range(GEN_QUERIES)]
    run = {ex["qid"]: {d: 1.0 - 0.1 * j - 0.01 * i
                       for j, d in enumerate(pages)}
           for i, ex in enumerate(examples)}
    texts = {d: " ".join(f"line {k} of {d}: revenue grew {k} percent"
                         for k in range(60)) for d in pages}
    return pages, examples, run, texts


class _CallCounter:
    """Counts a model's vision, prefill and decode calls (paged: with a
    block table, the engine's; dense: without, the beam search's), by
    wrapping them on the instance."""

    def __init__(self, model, vision_owner=None):
        self.counts = {"vision": 0, "prefill": 0, "paged": 0, "dense": 0}
        prefill, decode = model.prefill, model.decode

        def counted_prefill(*a, **kw):
            self.counts["prefill"] += 1
            return prefill(*a, **kw)

        def counted_decode(*a, **kw):
            table = a[5] if len(a) > 5 else kw.get("block_table")
            self.counts["dense" if table is None else "paged"] += 1
            return decode(*a, **kw)

        model.prefill, model.decode = counted_prefill, counted_decode
        if vision_owner is None:
            return
        vision = vision_owner.get_vision_embedding

        def counted_vision(*a, **kw):
            self.counts["vision"] += 1
            return vision(*a, **kw)
        vision_owner.get_vision_embedding = counted_vision


def _gen_counts(tag, calls, vit_depth, layers):
    """The launches of a VisRAG-Gen run against its calls: K1 flat
    vit_depth per vision run, K1 stacked `layers` per prefill, K5 `layers`
    per engine decode step (the beam's dense steps launch none), K7
    2 * layers + 1 RMSNorms per prefill or decode step and 2 * vit_depth +
    1 + 3 LayerNorms per vision run (the ViT and the resampler); every
    K1 launch on the Hopper kernel, no K5 launch on the first one. →
    the launch counts."""
    from visrag_tpu_torch.ops import attention_lengths as al
    from visrag_tpu_torch.ops import norms
    from visrag_tpu_torch.serving import paged_kv as pk
    c = calls.counts
    got = {"flat": al.flat_launches, "stacked": al.stacked_launches,
           "fwd_lse": al.fwd_lse_launches, "paged": pk.launches,
           "paged_legacy": pk.legacy_launches, **norms.launch_counts()}
    want = {"flat": vit_depth * c["vision"], "stacked": layers * c["prefill"],
            "fwd_lse": 0, "paged": layers * c["paged"], "paged_legacy": 0,
            "rmsnorm": (2 * layers + 1) * (c["prefill"] + c["paged"]
                                           + c["dense"]),
            "layernorm": (2 * vit_depth + 4) * c["vision"]}
    if got != want:
        raise RuntimeError(f"{tag} launches {got} != {want} (calls {c})")
    _lengths_routes(tag, got)
    log(f"{tag} launches {got} (= reckoned from calls {c}: K1 "
        f"{vit_depth} flat per vision run and {layers} stacked per "
        f"prefill, K5 {layers} per engine decode step, K7 at every norm)")
    return got


class _NormShapes:
    """Records each shape a run gives K7, (kind, rows, D, x dtype, w
    dtype), by wrapping norms._launch until close(); launches and counts
    are the wrapped function's."""

    def __init__(self):
        from visrag_tpu_torch.ops import norms
        self.shapes, self._norms, launch = set(), norms, norms._launch
        self._launch = launch

        def recorded(x, w, b, eps, legacy=False):
            d = x.shape[-1]
            self.shapes.add(("rms" if b is None else "ln", x.numel() // d,
                             d, x.dtype, w.dtype))
            return launch(x, w, b, eps, legacy)
        norms._launch = recorded

    def close(self):
        self._norms._launch = self._launch


def _gen_norm_checks(tag, gen, label, shapes):
    """K7 against its plain version (_check_norm) at every shape a
    generation run gave it. → the check records, RMSNorm and LayerNorm."""
    out = {"rms": [], "ln": []}
    for kind, rows, d, xdt, wdt in sorted(shapes, key=str):
        out[kind].append(_check_norm(gen, f"{tag} {label}", kind, rows, d,
                                     xdt, wdt))
    torch.cuda.empty_cache()
    log(f"{tag} K7 held against its plain version at the {len(shapes)} "
        f"shapes of the run: "
        f"{sorted((k, r, d) for k, r, d, _, _ in shapes)}")
    return out


def _gen_decode_vs_full(model, req, tokens, bs=128):
    """Prefill one request (K1) into a fresh paged pool, decode the
    generated `tokens` through it (K5), and compare the logits behind each
    generated token with one full forward over prompt + tokens (K1) at the
    same positions. → relative errors per generated position."""
    import numpy as np

    from visrag_tpu_torch.serving.paged_kv import write_prefill
    tc = model.cfg.text
    ids = np.asarray(req["input_ids"])
    s, steps = len(ids), len(tokens)
    vb = None if req.get("vision_batch") is None else {
        k: torch.as_tensor(np.asarray(v), device=DEV)
        for k, v in req["vision_batch"].items()}
    grid = -(-s // bs) * bs
    n_blocks = -(-(s + steps) // bs) + 1
    shape = (tc.num_hidden_layers, n_blocks, tc.num_key_value_heads, bs,
             tc.head_dim)
    kc = torch.zeros(shape, dtype=torch.bfloat16, device=DEV)
    vc = torch.zeros_like(kc)
    table = torch.arange(n_blocks - 1, dtype=torch.int32,
                         device=DEV)[None].contiguous()

    def slot_map(n):
        if vb is None:
            return None
        sm = np.full((1, n), -1, np.int64)
        sm[0, :s] = req["slot_map"]
        return torch.as_tensor(sm, device=DEV)
    ids_p = np.zeros((1, grid), np.int64)
    ids_p[0, :s] = ids
    with torch.inference_mode():
        logits, k, v = model.prefill(
            torch.as_tensor(ids_p, device=DEV),
            attention_mask=torch.as_tensor((np.arange(grid) < s)[None],
                                           device=DEV),
            vision_batch=vb, slot_map=slot_map(grid),
            last_pos=torch.tensor([s - 1], device=DEV))
        write_prefill(kc, vc, k, v, list(range(grid // bs)), grid)
        del k, v
        dec = [logits[0].float()]
        for t in range(steps - 1):
            dec.append(model.decode(
                torch.tensor([[tokens[t]]], device=DEV),
                torch.full((3, 1, 1), s + t, device=DEV), kc, vc,
                torch.tensor([s + t + 1], dtype=torch.int32, device=DEV),
                table)[0].float())
        full_ids = np.concatenate([ids, tokens[:-1]]).astype(np.int64)[None]
        full, _ = model(torch.as_tensor(full_ids, device=DEV),
                        vision_batch=vb,
                        slot_map=slot_map(full_ids.shape[1]))
        full = full[0, s - 1:].float()
    errs = [(torch.linalg.norm(dec[i] - full[i])
             / torch.linalg.norm(full[i])).item() for i in range(steps)]
    del kc, vc, full
    torch.cuda.empty_cache()
    return errs


class _Recorder:
    """Keeps every request an engine's generate_detailed served."""

    def __init__(self, engine):
        self.served = []
        fn = engine.generate_detailed

        def recorded(prompts, **kw):
            out = fn(prompts, **kw)
            self.served.extend(zip(prompts, out))
            return out
        engine.generate_detailed = recorded


def _gen_serve_stats(tag, recorder, timer, engine):
    """TTFT per request and decode ms per step of one backend's run."""
    ttft = [round((r.t_first - r.t_enqueue) * 1e3, 2)
            for _, r in recorder.served]
    steps = timer.calls * engine.chunk
    ms_step = timer.seconds / max(steps, 1) * 1e3
    log(f"{tag} TTFT ms per request {ttft} | decode {timer.calls} chunks x "
        f"{engine.chunk} steps, {ms_step:.3f} ms per step (one live slot of "
        f"{engine.num_slots}) | {smi()}")
    return {"ttft_ms": ttft, "decode_ms_per_step": ms_step}


def _gen_k1_check(phase, tag, gen, lens, s, h, kvh, d):
    """K1 stacked causal at a generation prefill's shape against its plain
    version (2e-2 relative, pad rows exactly 0), timed beside SDPA with a
    causal length mask and the bound."""
    from visrag_tpu_torch.ops import attention_lengths as al
    b = len(lens)
    q = torch.randn(b, s, h, d, generator=gen, device=DEV).bfloat16()
    k, v = (torch.randn(b, s, kvh, d, generator=gen, device=DEV).bfloat16()
            for _ in range(2))
    lens_t = torch.tensor(lens, dtype=torch.int32, device=DEV)
    kern = lambda: al.flash_fwd_lengths(q, k, v, lens_t, True, d ** -0.5)
    plain = lambda: al.lengths_attention_reference(q, k, v, lens_t, True,
                                                   d ** -0.5)
    out, ref = kern(), plain()
    valid = torch.arange(s, device=DEV)[None] < lens_t[:, None]
    if not bool((out[~valid] == 0).all()):
        raise RuntimeError(f"{tag} K1: pad rows are not exactly 0")
    mask = _sdpa_mask(lens_t, s, True, DEV)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib = lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, scale=d ** -0.5, enable_gqa=kvh != h)
    rec = _timed_check(tag, f"B={b} S={s} H={h}/{kvh} d={d} lengths {lens}; "
                       f"pad rows exactly 0", kern, plain, lib, out, ref,
                       valid, attention_bound("fwd", lens, s, h, d, True,
                                              kv_heads=kvh), phase)
    del q, k, v, out, ref, mask
    torch.cuda.empty_cache()
    return rec


BEAM_KW = dict(num_beams=3, max_new_tokens=GEN_NEW_TOKENS,
               repetition_penalty=1.2)
BEAM_FP32_VIT_DEPTH, BEAM_FP32_LAYERS = 1, 2
BEAM_FP32_PAGES = 2         # the query's shortest page requests
# the bf16 beams' summed log-probs, batched vs sequential, at each step up
# to the first whose selection differs: rounding moves them by far less,
# a wrong reorder or length by a log-prob's spread across the vocabulary
TOL_BEAM_BF16 = 2e-2


def _beam_traced(run):
    """run() with each _BeamState's selections recorded. → (run's result,
    per state in the order made: [(parents, tokens, survivors' summed
    log-probs, finished count) per step])."""
    from visrag_tpu_torch.serving import beam
    traces, select = [], beam._BeamState.select

    def traced(self, *a):
        select(self, *a)
        if not hasattr(self, "trace"):
            self.trace = []
            traces.append(self.trace)
        self.trace.append((self.parents.tolist(), list(self.next_tokens),
                           self.scores.copy(), len(self.finished)))
    beam._BeamState.select = traced
    try:
        return run(), traces
    finally:
        beam._BeamState.select = select


def _beam_pair_bf16(engine, reqs):
    """The batched beam against the sequential one in bf16 on the card,
    held on what the two decodes' rounding cannot move (their 9-row and
    3-row GEMMs round otherwise, and the random model's near-uniform
    log-probs make near-ties): at each step up to and including the first
    whose selection (parents, tokens, finished) differs, the survivors'
    summed log-probs, rank for rank, within TOL_BEAM_BF16, so a divergence
    is a near-tie (a run that stops stepping first diverges there); and
    the final scores within 1e-3."""
    import numpy as np
    with torch.inference_mode():
        got, tb = _beam_traced(
            lambda: engine.beam_search_batched(reqs, **BEAM_KW))
        want, ts = [], []
        for r in reqs:
            out, t = _beam_traced(lambda: engine.beam_search(r, **BEAM_KW))
            want.append(out)
            ts += t
    report = []
    for g, w, b, q in zip(got, want, tb, ts):
        first, worst = None, 0.0
        for t, (sb, sq) in enumerate(zip(b, q)):
            live = (sb[2] > -1e8) & (sq[2] > -1e8)
            worst = max(worst, float(np.abs(sb[2] - sq[2])[live].max()))
            if (sb[0], sb[1], sb[3]) != (sq[0], sq[1], sq[3]):
                first = t
                break
        if first is None and len(b) != len(q):
            first = min(len(b), len(q))
        report.append({"same_ids": g[0] == w[0], "tokens": len(g[0]),
                       "score_diff": abs(g[1] - w[1]), "steps": len(q),
                       "first_divergent_step": first,
                       "max_step_diff": worst})
    log(f"[12] weighted_selection beam in bf16 on the card, batched "
        f"({len(reqs)} pages x 3 beams in one decode loop) vs sequential, "
        f"per page: {report} (summed log-probs within {TOL_BEAM_BF16} at "
        f"every step up to the first divergent one; scores within 1e-3)")
    bad = [r for r in report if r["max_step_diff"] > TOL_BEAM_BF16
           or r["score_diff"] > 1e-3]
    if bad or len(tb) != len(reqs) or len(ts) != len(reqs):
        raise RuntimeError(f"bf16 batched beam departs from the sequential "
                           f"one beyond rounding: {report}")


def _beam_pair_fp32(cfg, reqs):
    """The batched beam against the sequential one (the same ids, scores
    within 1e-3), held in fp32 at reduced depth on the CPU (plain
    versions): MiniCPM-V 2.0's widths with BEAM_FP32_VIT_DEPTH ViT blocks
    and BEAM_FP32_LAYERS LM layers, random weights from seed 0, on phase
    12's first query's BEAM_FP32_PAGES shortest page requests (the host's
    fp32 GEMMs are the phase's cost). In bf16 on the card the batched
    decode (9 rows) rounds its GEMMs otherwise than the sequential one (3
    rows), and a random model's near-uniform scores (a mean log-prob near
    -log(vocab)) let that flip near-ties, so there the pair is held only
    up to the first near-tie (_beam_pair_bf16)."""
    from visrag_tpu_torch.driver.common import init_weights_
    from visrag_tpu_torch.models.minicpmv import (MiniCPMVForGeneration,
                                                  MiniCPMVGenConfig)
    from visrag_tpu_torch.serving.beam import beam_search_batched
    f32 = torch.float32
    small = MiniCPMVGenConfig(backbone=dataclasses.replace(
        cfg, llm=dataclasses.replace(cfg.llm, dtype=f32,
                                     num_hidden_layers=BEAM_FP32_LAYERS),
        vit=dataclasses.replace(cfg.vit, dtype=f32,
                                depth=BEAM_FP32_VIT_DEPTH),
        resampler=dataclasses.replace(cfg.resampler, dtype=f32)))
    t0 = time.perf_counter()
    with torch.device("meta"):
        m32 = MiniCPMVForGeneration(small)
    m32 = m32.to_empty(device="cpu")
    init_weights_(m32, torch.Generator().manual_seed(0))
    m32.eval()
    with torch.inference_mode():
        got = beam_search_batched(m32, reqs, **BEAM_KW)
        want = [beam_search_batched(m32, [r], **BEAM_KW)[0] for r in reqs]
    diffs = [abs(g[1] - w[1]) for g, w in zip(got, want)]
    same = [g[0] == w[0] for g, w in zip(got, want)]
    log(f"[12] weighted_selection beam in fp32 at {BEAM_FP32_VIT_DEPTH} ViT "
        f"block / {BEAM_FP32_LAYERS} LM layers on the CPU, batched "
        f"({len(reqs)} pages x 3 beams) vs sequential: the same ids {same} "
        f"({[len(g[0]) for g in got]} tokens), score diffs {diffs} (bound "
        f"1e-3), {time.perf_counter() - t0:.1f} s")
    if not all(same) or max(diffs) > 1e-3:
        raise RuntimeError(f"batched beam {got} != sequential {want}")


def phase12_minicpmv(gen):
    """MiniCPM-V 2.0 at full width (MiniCPMVGenConfig(), random bf16 weights
    from seed 0) through run_generate_eval and generate_eval's builder with
    the MockTokenizer: page_concatenation (greedy, 20 new tokens) and
    weighted_selection (beam k = 3, repetition penalty 1.2, all of a
    query's pages in one score_fn.batched call) over 3 pages x 2 queries;
    then the MiniCPM-2B text backend on the same LM weights (task text).
    Checks the launch counts against the calls (_gen_counts), each greedy
    step's logits over the paged pool against one full forward (2e-2
    relative at every generated position), K7 at every shape the run gave
    it, and the batched beam against the sequential one: in bf16 on the
    card up to near-ties (_beam_pair_bf16: the batch shapes round
    otherwise and flip near-ties of the random model), and equal (the same
    ids, scores within 1e-3) in fp32 at reduced depth (_beam_pair_fp32). →
    (launches, the K1, K5 and K7 check records, stats)."""
    from visrag_tpu_torch.driver import generate_eval as ge
    from visrag_tpu_torch.models.minicpm import (MiniCPMForGeneration,
                                                 MiniCPMGenConfig)
    from visrag_tpu_torch.ops import attention_lengths as al
    from visrag_tpu_torch.ops import norms
    from visrag_tpu_torch.preprocess import MockTokenizer
    from visrag_tpu_torch.serving import paged_kv as pk
    pages, examples, run, texts = _gen_corpus(12)
    t0 = time.perf_counter()
    model = ge.random_generation_model("minicpmv", device=DEV, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[12] MiniCPM-V 2.0 full width bf16, {n_params / 1e9:.3f}B params "
        f"(init {time.perf_counter() - t0:.1f} s)")
    tok = MockTokenizer()
    fn = ge.build_minicpmv(model, tok, max_new_tokens=GEN_NEW_TOKENS)
    cfg = model.cfg.backbone
    with torch.device("meta"):
        lm = MiniCPMForGeneration(MiniCPMGenConfig(llm=cfg.llm))
    lm.model, lm.lm_head = model.backbone.llm, model.lm_head
    text_fn = ge.build_minicpm(lm, tok, max_new_tokens=GEN_NEW_TOKENS)
    calls = _CallCounter(model, model.backbone)
    lm_calls = _CallCounter(lm)
    rec_v, rec_t = _Recorder(fn.engine), _Recorder(text_fn.engine)
    tim_v = _SyncTimer(fn.engine, "_decode_chunk")
    tim_t = _SyncTimer(text_fn.engine, "_decode_chunk")
    beam_items = []
    batched = fn.score_fn.batched

    def recorded_batched(items):
        beam_items.append(items)
        return batched(items)
    fn.score_fn.batched = recorded_batched
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    al.reset_launch_counts()
    pk.reset_launch_counts()
    norms.reset_launch_counts()
    acc, secs = {}, {}
    shapes = _NormShapes()
    try:
        with torch.inference_mode():
            for task, f, corpus in (("page_concatenation", fn, pages),
                                    ("weighted_selection", fn, pages),
                                    ("text", text_fn, texts)):
                t0 = time.perf_counter()
                acc[task], recs = ge.run_generate_eval(
                    "InfoVQA", examples, f, task_type=task, topk=GEN_TOPK,
                    run=run, corpus=corpus)
                torch.cuda.synchronize()
                secs[task] = round(time.perf_counter() - t0, 3)
                log(f"[12] {task}: {len(recs)} queries in {secs[task]} s, "
                    f"predictions {[r['pred'] for r in recs]}")
    finally:
        shapes.close()
    for k2, v2 in lm_calls.counts.items():
        calls.counts[k2] += v2
    launches = _gen_counts("[12]", calls, cfg.vit.depth,
                           cfg.llm.num_hidden_layers)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    stats = {"seconds": secs, "peak_gb": peak_gb,
             "vision": _gen_serve_stats("[12] page_concatenation", rec_v,
                                        tim_v, fn.engine),
             "text": _gen_serve_stats("[12] text (MiniCPM-2B)", rec_t, tim_t,
                                      text_fn.engine)}
    log(f"[12] peak memory {peak_gb:.2f} GB")

    # each greedy step against one full forward, vision and text
    import numpy as np
    errs = {}
    for name, rec, m in (("vision", rec_v, model), ("text", rec_t, lm)):
        req, out = rec.served[0]
        errs[name] = _gen_decode_vs_full(m, req, list(out.output_ids))
    log(f"[12] decode logits over the paged pool (K5) vs one full forward "
        f"(K1), relative error per generated position: "
        f"{ {k: [round(e, 5) for e in v] for k, v in errs.items()} } (bound "
        f"{RTOL_BLOCK})")
    if max(max(v) for v in errs.values()) > RTOL_BLOCK:
        raise RuntimeError(f"decode logits disagree with the full forward: "
                           f"{errs}")
    # the batched beam against the sequential one on the first query's
    # pages, as the backend calls them (num_beams 3, repetition penalty 1.2)
    reqs = [fn.request(p, imgs) for p, imgs in beam_items[0]]
    _beam_pair_bf16(fn.engine, reqs)
    _beam_pair_fp32(cfg, sorted(reqs, key=lambda r: len(r["input_ids"]))
                    [:BEAM_FP32_PAGES])

    # K1 at the generation prefill shapes and K5 at MiniCPM-2B's decode
    h, d = cfg.llm.num_attention_heads, cfg.llm.head_dim
    checks = {"k1": [], "k5": []}
    for name, rec, engine in (("vision", rec_v, fn.engine),
                              ("text", rec_t, text_fn.engine)):
        s = len(rec.served[0][0]["input_ids"])
        bucket = next(b for b in engine.prompt_buckets if b >= s)
        checks["k1"].append(_gen_k1_check("[12]", f"K1 {name} prefill", gen,
                                          [s], bucket, h, h, d))
        lens = [s + GEN_NEW_TOKENS] + [1] * (engine.num_slots - 1)
        checks["k5"].append(_k5_check(
            "[12]", gen, f"MiniCPM-2B {name} decode", lens, h, h, d,
            engine.block_size, False, True))
    checks["k7"] = _gen_norm_checks("[12]", gen, "MiniCPM-V 2.0 / "
                                    "MiniCPM-2B generation", shapes.shapes)
    del fn, text_fn, lm, model, beam_items, reqs, calls, lm_calls
    del rec_v, rec_t, tim_v, tim_t
    gc.collect()
    torch.cuda.empty_cache()
    return launches, checks, stats


def phase13_minicpmv26(gen):
    """MiniCPM-V 2.6 at full width (MiniCPMV26Config(), random bf16 weights
    from seed 0) through run_generate_eval and generate_eval's builder with
    the MockTokenizer: multi_image over each query's top 3 pages in one
    prompt (max_slice_nums 9, uint8 device-mode pixels), greedy, 20 new
    tokens, 2 queries. Checks the launch counts (K1 flat 27 per vision
    run, K1 GQA 28 per prefill, K5 28 per decode step) and each greedy
    step's logits against one full forward (2e-2), and K7 at every shape
    the run gave it. → (launches, the K1 and K7 check records, stats)."""
    from visrag_tpu_torch.driver import generate_eval as ge
    from visrag_tpu_torch.ops import attention_lengths as al
    from visrag_tpu_torch.ops import norms
    from visrag_tpu_torch.preprocess import MockTokenizer
    from visrag_tpu_torch.serving import paged_kv as pk
    pages, examples, run, _ = _gen_corpus(13)
    t0 = time.perf_counter()
    model = ge.random_generation_model("minicpmv26", device=DEV, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[13] MiniCPM-V 2.6 full width bf16, {n_params / 1e9:.3f}B params "
        f"(init {time.perf_counter() - t0:.1f} s)")
    fn = ge.build_minicpmv26(model, MockTokenizer(),
                             max_new_tokens=GEN_NEW_TOKENS,
                             pcfg=ge.pipeline_config(model, max_slice_nums=9))
    calls = _CallCounter(model, model)
    rec = _Recorder(fn.engine)
    tim = _SyncTimer(fn.engine, "_decode_chunk")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    al.reset_launch_counts()
    pk.reset_launch_counts()
    norms.reset_launch_counts()
    t0 = time.perf_counter()
    shapes = _NormShapes()
    try:
        with torch.inference_mode():
            acc, recs = ge.run_generate_eval(
                "InfoVQA", examples, fn, task_type="multi_image",
                topk=GEN_TOPK, run=run, corpus=pages)
        torch.cuda.synchronize()
    finally:
        shapes.close()
    secs = round(time.perf_counter() - t0, 3)
    tc = model.cfg.llm
    launches = _gen_counts("[13]", calls, model.cfg.vit.depth,
                           tc.num_hidden_layers)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prompt_tokens = [len(p["input_ids"]) for p, _ in rec.served]
    stats = {"seconds": secs, "peak_gb": peak_gb,
             "prompt_tokens": prompt_tokens,
             "multi_image": _gen_serve_stats("[13] multi_image", rec, tim,
                                             fn.engine)}
    log(f"[13] multi_image: {len(recs)} queries (prompt tokens "
        f"{prompt_tokens}) in {secs} s, predictions "
        f"{[r['pred'] for r in recs]} | peak memory {peak_gb:.2f} GB")
    req, out = rec.served[0]
    errs = _gen_decode_vs_full(model, req, list(out.output_ids))
    log(f"[13] decode logits over the paged pool (K5) vs one full forward "
        f"(K1), relative error per generated position: "
        f"{[round(e, 5) for e in errs]} (bound {RTOL_BLOCK})")
    if max(errs) > RTOL_BLOCK:
        raise RuntimeError(f"decode logits disagree with the full forward: "
                           f"{errs}")
    s = prompt_tokens[0]
    bucket = next(b for b in fn.engine.prompt_buckets if b >= s)
    checks = {"k1": [_gen_k1_check(
        "[13]", "K1 GQA prefill", gen, [s], bucket, tc.num_attention_heads,
        tc.num_key_value_heads, tc.head_dim)]}
    del fn, model, rec, req, calls, tim
    gc.collect()
    torch.cuda.empty_cache()
    checks["k7"] = _gen_norm_checks("[13]", gen, "MiniCPM-V 2.6 generation",
                                    shapes.shapes)
    return launches, checks, stats


def phase14_demo(work):
    """The demo's build-index and answer on the card, as subprocesses (the
    demo's default device), at full width on random weights: the tiny
    configs' head dims (16) are not ones the kernels take, so --tiny runs
    only on the CPU (tests/test_torch_gen_eval.py)."""
    import numpy as np
    from PIL import Image
    docs = os.path.join(work, "docs")
    os.makedirs(docs)
    with open(os.path.join(docs, "note.txt"), "w") as f:
        f.write("the revenue in 2020 was 42 million\n" * 30)
    Image.fromarray(np.random.default_rng(14).integers(
        0, 255, (60, 40, 3), dtype=np.uint8)).save(os.path.join(docs,
                                                                "page.png"))
    idx = os.path.join(work, "idx")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.abspath(__file__)))
    t0 = time.perf_counter()
    for argv in (["build-index", "--input", docs, "--output", idx],
                 ["answer", "--index", idx, "--query",
                  "what was the 2020 revenue", "--topk", "2"]):
        proc = subprocess.run(
            [sys.executable, "-m", "visrag_tpu_torch.driver.demo", *argv],
            env=env, capture_output=True, text=True, timeout=300)
        if proc.returncode:
            raise RuntimeError(f"demo {argv[0]} exited {proc.returncode}: "
                               f"{proc.stderr[-3000:]}")
    with open(os.path.join(idx, "answer.json")) as f:
        ans = json.load(f)
    if len(ans["retrieved"]) != 2:
        raise RuntimeError(f"demo answer retrieved {ans['retrieved']}")
    log(f"[14] demo build-index (2 pages) and answer (VisRAG-Ret at full "
        f"width, on the card) in {time.perf_counter() - t0:.1f} s: "
        f"{ans['retrieved']}")


# ---- phase 15: the SigLIP baseline, the int8 corpus scan and the single-GPU
# remainder -------------------------------------------------------------------

SCAN_ROWS = 1_000_000       # the resident corpus of the scan
SCAN_DIM = 2304             # VisRAG-Ret's embedding width
SCAN_QUERIES = 64
SCAN_K = 10
STREAM_ROWS = 131_072       # StreamingSearcher's run, in 4 chunks
QUANT_CHECK_ROWS = 65_536   # device quantize_rows against quantize_rows_np
PEAK_FP32 = 67e12           # H100 SXM fp32 outside the tensor cores
SIGLIP_TEXT_LEN = 64        # the reference's padding="max_length"
SYNTH_NEW_TOKENS = 16


def _siglip_model(cfg, seed=0):
    """The SigLIP bi-tower on the card with random weights from an
    explicit generator (driver/common.init_weights_; logit scale 1,
    bias 0 as the JAX init)."""
    from visrag_tpu_torch.driver.common import init_weights_
    from visrag_tpu_torch.models.siglip import SiglipModel
    with torch.device("meta"):
        model = SiglipModel(cfg)
    model = model.to_empty(device=DEV)
    init_weights_(model, torch.Generator(device=DEV).manual_seed(seed))
    with torch.no_grad():
        model.logit_scale.fill_(1.0)
        model.logit_bias.zero_()
    return model.eval()


def _siglip_patches(cfg):
    """The 16 pages of bench.py's size mix, resized to the tower's image
    size (bicubic), scaled to [-1, 1] (SigLIP's mean and std 0.5) and cut
    into (c, ph, pw) row-major patches of the top-left 27 x 14 pixels a
    side, which is what HF's stride-14 conv reads of a 384 image. → (16,
    729, 588) fp32 on the card."""
    import numpy as np
    from PIL import Image
    size, ps = cfg.image_size, cfg.patch_size
    g = size // ps
    px = np.stack([np.asarray(img.resize((size, size), Image.BICUBIC))
                   for _, img in _pages(0)])
    x = torch.from_numpy(px).to(DEV).float().div_(127.5).sub_(1.0)
    x = x.permute(0, 3, 1, 2)[:, :, :g * ps, :g * ps]
    n = x.shape[0]
    return x.reshape(n, 3, g, ps, g, ps).permute(0, 2, 4, 1, 3, 5) \
        .reshape(n, g * g, 3 * ps * ps).contiguous()


def _siglip_query_ids(n, s):
    """n query texts (without the retriever's instruction) as MockTokenizer
    ids, each repeated to s full-length ids (no mask, as the reference
    feeds SigLIP)."""
    from visrag_tpu_torch.preprocess import MockTokenizer
    tok = MockTokenizer()
    rows = []
    for text, _ in _queries(n):
        ids = tok.encode(text.split(": ", 1)[1])
        rows.append((ids * (s // len(ids) + 1))[:s])
    return torch.tensor(rows, dtype=torch.long, device=DEV)


def _siglip_k1_check(gen, label, lens, s, h, d):
    """K1 stacked, not causal, at one of SigLIP's shapes against its plain
    version: 2e-2 max abs on valid rows, pad rows exactly 0; timed beside
    the plain version, SDPA with a length mask and the bound."""
    from visrag_tpu_torch.ops import attention_lengths as al
    b = len(lens)
    q, k, v = (torch.randn(b, s, h, d, generator=gen, device=DEV).bfloat16()
               for _ in range(3))
    lens_t = torch.tensor(lens, dtype=torch.int32, device=DEV)
    kern = lambda: al.flash_fwd_lengths(q, k, v, lens_t, False, d ** -0.5)
    plain = lambda: al.lengths_attention_reference(q, k, v, lens_t, False,
                                                   d ** -0.5)
    out, ref = kern(), plain()
    torch.cuda.synchronize()
    valid = torch.arange(s, device=DEV)[None] < lens_t[:, None]
    err = (out.float() - ref.float()).abs()[valid].max().item()
    pad_zero = bool((out[~valid] == 0).all())
    finite = bool(torch.isfinite(out.float()).all())
    mask = _sdpa_mask(lens_t, s, False, DEV)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                 scale=d ** -0.5)
    ms, plain_ms, lib_ms = cuda_ms(kern), cuda_ms(plain), cuda_ms(lib)
    bound = attention_bound("fwd", lens, s, h, d, False)
    shape = f"{label}: B={b} S={s} H={h} d={d} lengths {sorted(set(lens))}"
    log(f"[15] K1 {shape}: max_abs_err {err:.4g} (bound {ATOL_KERNEL}), pad "
        f"rows exactly 0 {pad_zero}, finite {finite} | kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, bound "
        f"{bound[0]:.4f} ms ({bound[1]}) | {smi()}")
    if err > ATOL_KERNEL or not pad_zero or not finite:
        raise RuntimeError(f"K1 {shape}: disagrees with its plain version "
                           f"({err}, pad rows 0 {pad_zero}, finite {finite})")
    return {"shape": shape, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound[0],
            "bound_by": bound[1]}


def _siglip_layer_check(gen, vcfg, s):
    """One full-width encoder layer, bf16 on the card (K1, K7) against the
    same layer in fp32 on the CPU (plain versions), 2 rows of s tokens."""
    from visrag_tpu_torch.driver.common import init_weights_
    from visrag_tpu_torch.models.siglip import SiglipEncoderLayer
    with torch.device(DEV):
        layer = SiglipEncoderLayer(vcfg)
    init_weights_(layer, gen)
    x = torch.randn(2, s, vcfg.hidden_size, generator=gen, device=DEV)
    with torch.inference_mode():
        out = layer(x.bfloat16())
        ref = copy.deepcopy(layer).float().cpu()(x.cpu())
    rel = _rel_err(out, ref, torch.ones(2, s, dtype=torch.bool))
    log(f"[15] full-width SigLIP encoder layer (2 x {s} tokens), bf16 on the "
        f"card vs fp32 on the CPU: rel_err {rel:.4g} (bound {RTOL_BLOCK})")
    if not rel <= RTOL_BLOCK:
        raise RuntimeError(f"SigLIP encoder layer disagrees: {rel}")
    return rel


def _scan_bound(m, k, n, in_bytes, peak_ops):
    """Least time of one scan's product: 2MKN operations at peak_ops, or
    the queries and corpus (in_bytes an element, the int8 scan's fp32
    scales besides) read once and the fp32 scores written once."""
    nbytes = in_bytes * (m + n) * k + 4 * m * n \
        + (4 * (m + n) if in_bytes == 1 else 0)
    t_ops, t_bytes = 2 * m * k * n / peak_ops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"


def _gelu_sweep():
    """ops/gelu.fast_gelu on the card on every bf16 pattern against float64
    erfc-GELU rounded to bf16 (computed on the CPU in the form without
    cancellation on either side), and how many F.gelu in bf16 gets wrong;
    then both timed at the ViT's fc1 activation (126,208 x 4304 bf16)."""
    from visrag_tpu_torch.models.siglip_vit import Mlp, SiglipViTConfig
    from visrag_tpu_torch.ops import gelu
    bits = torch.arange(65536, dtype=torch.int32).to(torch.int16)
    x64 = bits.view(torch.bfloat16).double()
    with torch.no_grad():
        tail = 0.5 * x64 * torch.special.erfc(x64.abs() / math.sqrt(2))
        truth = torch.where(x64 > 0, x64 - tail, tail).float().bfloat16()
    finite = torch.isfinite(x64)
    x = bits.view(torch.bfloat16).to(DEV)
    out = gelu.fast_gelu(x).cpu().view(torch.int16)
    lib = F.gelu(x).cpu().view(torch.int16)
    want = truth.view(torch.int16)
    wrong = int(((out != want) & finite).sum())
    lib_wrong = int(((lib != want) & finite).sum())
    vit_act = Mlp(SiglipViTConfig.tiny()).act
    big = torch.randn(126208, 4304, device=DEV).bfloat16()
    ms, lib_ms = cuda_ms(lambda: gelu.fast_gelu(big)), cuda_ms(
        lambda: F.gelu(big))
    del big
    log(f"[15] GELU sweep on the card, {int(finite.sum())} finite bf16 "
        f"patterns: fast_gelu differs from float64 erf-GELU on {wrong}, "
        f"F.gelu in bf16 on {lib_wrong}; the ViT's erf MLP runs "
        f"{getattr(vit_act, '__name__', vit_act)} | at 126,208 x 4304 bf16: "
        f"fast_gelu {ms:.4f} ms, F.gelu {lib_ms:.4f} ms")
    if wrong or (lib_wrong and vit_act is not gelu.fast_gelu):
        raise RuntimeError(f"GELU: fast_gelu wrong on {wrong} patterns, "
                           f"F.gelu on {lib_wrong}, ViT act {vit_act}")
    return {"fast_gelu_wrong": wrong, "f_gelu_wrong": lib_wrong,
            "fast_gelu_ms": ms, "f_gelu_ms": lib_ms}


def _synthesize_twin(gen):
    """driver/synthesize_queries' generator at Qwen2.5-VL-3B's width on
    random weights: one page, SYNTH_NEW_TOKENS new tokens, the launches of
    K3, K1 and K5 reckoned from the model's calls."""
    from visrag_tpu_torch.driver import synthesize_queries as sq
    from visrag_tpu_torch.driver.common import build_qwen25_vl
    from visrag_tpu_torch.models.qwen25_vl import Qwen25VLConfig
    from visrag_tpu_torch.ops import attention_kvgrid as kg
    from visrag_tpu_torch.ops import attention_lengths as al
    from visrag_tpu_torch.serving import paged_kv as pk
    cfg = Qwen25VLConfig.b3()
    model = build_qwen25_vl(cfg, device=DEV, seed=0)
    tok = RLStandInTokenizer()
    generate = sq.make_local_generator(tok, tok, model, SYNTH_NEW_TOKENS)
    calls = _CallCounter(model)
    encode = model.encode_images
    vision_runs = []

    def counted_encode(*a, **kw):
        vision_runs.append(1)
        return encode(*a, **kw)
    model.encode_images = counted_encode
    page = _pages(1)[0][1]
    al.reset_launch_counts()
    kg.reset_launch_counts()
    pk.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    text = generate(page)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    got = {"kvgrid": kg.launches, "stacked": al.stacked_launches,
           "paged": pk.launches, "flat": al.flat_launches,
           "fwd_lse": al.fwd_lse_launches, "paged_legacy": pk.legacy_launches}
    layers, c = cfg.text.num_hidden_layers, calls.counts
    want = {"kvgrid": cfg.vision.depth * len(vision_runs),
            "stacked": layers * c["prefill"], "paged": layers * c["paged"],
            "flat": 0, "fwd_lse": 0, "paged_legacy": 0}
    n_out = len(text.split())
    log(f"[15] synthesize twin (Qwen2.5-VL-3B, random weights, one "
        f"{page.size[0]} x {page.size[1]} page at max_pixels "
        f"{sq.MAX_PIXELS}): {n_out} new tokens in {run_s:.2f} s; launches "
        f"{got} (calls {c}, vision runs {len(vision_runs)}); parsed pairs "
        f"{sq.parse_pairs(text)}")
    if got != want or not 1 <= n_out <= SYNTH_NEW_TOKENS or not vision_runs:
        raise RuntimeError(f"synthesize twin: launches {got} != {want} or "
                           f"{n_out} tokens")
    _lengths_routes("[15] synthesize twin", got)
    _kvgrid_routes("[15] synthesize twin")
    del model, generate, calls
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": got, "calls": dict(c), "s": run_s}


SCAN_SEED = 15


def _scan_inputs():
    """Phase 15's scan: SCAN_ROWS unit rows, SCAN_QUERIES queries planted
    near rows (noise 0.1 / sqrt(D)), the rows quantized on the device in
    STREAM_ROWS blocks; from a generator seeded SCAN_SEED, so that phase 16
    searches the same corpus. → (corpus, codes, scales, queries, planted)."""
    from visrag_tpu_torch.retrieval import search
    gen = torch.Generator(device=DEV).manual_seed(SCAN_SEED)
    corpus = torch.randn(SCAN_ROWS, SCAN_DIM, generator=gen, device=DEV)
    corpus /= corpus.norm(dim=1, keepdim=True)
    planted = torch.randperm(SCAN_ROWS, generator=gen,
                             device=DEV)[:SCAN_QUERIES]
    q = corpus[planted] + 0.1 * torch.randn(
        SCAN_QUERIES, SCAN_DIM, generator=gen, device=DEV) / SCAN_DIM ** 0.5
    q /= q.norm(dim=1, keepdim=True)
    cq = torch.empty(SCAN_ROWS, SCAN_DIM, dtype=torch.int8, device=DEV)
    cs = torch.empty(SCAN_ROWS, device=DEV)
    for a in range(0, SCAN_ROWS, STREAM_ROWS):
        cq[a:a + STREAM_ROWS], cs[a:a + STREAM_ROWS] = \
            search.quantize_rows(corpus[a:a + STREAM_ROWS])
    return corpus, cq, cs, q, planted


def phase15_retrieval(gen):
    """The SigLIP-only retriever baseline at full width, the int8 corpus
    scan over a resident 1M x 2304 corpus, self_retrieve, the GELU sweep,
    the synthesize twin and a trace. → {"launches", "checks", "stats"}."""
    import numpy as np

    from visrag_tpu_torch.models.siglip import SiglipConfig
    from visrag_tpu_torch.ops import attention_lengths as al
    from visrag_tpu_torch.ops import matmul_int8 as mi
    from visrag_tpu_torch.ops import norms
    from visrag_tpu_torch.retrieval import search
    from visrag_tpu_torch.utils import profiling, timing
    t_phase = time.perf_counter()
    cfg = SiglipConfig()
    t0 = time.perf_counter()
    model = _siglip_model(cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    patches = _siglip_patches(cfg)
    ids = _siglip_query_ids(N_QUERIES, SIGLIP_TEXT_LEN)
    vc, tc = cfg.vision, cfg.text

    # the main path, its launches counted from 0: both towers, the search
    # over the pages, the 1M-row scans, the chunked searcher, self_retrieve
    for counters in (al, norms, mi):
        counters.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        pages = model.encode_image(patches)
        torch.cuda.synchronize()
        vision = {"stacked": al.stacked_launches,
                  "layernorm": norms.launch_counts()["layernorm"]}
        queries = model.encode_text(ids)
        torch.cuda.synchronize()
    text = {"stacked": al.stacked_launches - vision["stacked"],
            "layernorm": norms.launch_counts()["layernorm"]
            - vision["layernorm"]}
    tower_want = ({"stacked": vc.num_hidden_layers,
                   "layernorm": 2 * vc.num_hidden_layers + 2},
                  {"stacked": tc.num_hidden_layers,
                   "layernorm": 2 * tc.num_hidden_layers + 1})
    if (vision, text) != tower_want:
        raise RuntimeError(f"SigLIP launches vision {vision}, text {text} != "
                           f"{tower_want}")
    if not (torch.isfinite(pages.float()).all()
            and torch.isfinite(queries.float()).all()):
        raise RuntimeError("SigLIP embeddings not finite")
    p_emb = F.normalize(pages.float(), dim=-1).cpu().numpy()
    q_emb = F.normalize(queries.float(), dim=-1).cpu().numpy()
    top5 = {quant: search.StreamingSearcher(5, device=DEV, quant=quant)
            .search(q_emb, [(p_emb, 0)])[1] for quant in search.QUANTS}

    # the scan: a resident corpus of unit rows, 64 queries planted on rows
    corpus, cq, cs, q, planted = _scan_inputs()
    s32, i32 = search.topk_single(q, corpus, SCAN_K)
    s8, i8 = search.topk_single_int8(q, cq, cs, SCAN_K)
    scan_ids = {"none": (s32.cpu(), i32.cpu()), "int8": (s8.cpu(), i8.cpu())}
    rank1 = {"fp32": int((i32[:, 0] == planted).sum()),
             "int8": int((i8[:, 0] == planted).sum())}
    overlap = float(np.mean([len(set(a) & set(b)) / SCAN_K for a, b in zip(
        i32.tolist(), i8.tolist())]))
    # the chunked searcher on the first 131,072 rows, a row duplicated
    # across chunks and queried: a tie that goes to the lower index
    sub = corpus[:STREAM_ROWS].cpu().numpy()
    tie = (STREAM_ROWS * 3 // 10, STREAM_ROWS * 3 // 4 + 5)  # chunks 1, 3
    sub[tie[1]] = sub[tie[0]]
    qh = q.cpu().numpy()
    qh[0] = sub[tie[0]]
    quarter = STREAM_ROWS // 4
    chunks = [(sub[a:a + quarter], a) for a in range(0, STREAM_ROWS, quarter)]
    stream = {}
    for quant in search.QUANTS:
        searcher = search.StreamingSearcher(SCAN_K, device=DEV, quant=quant)
        stream[quant] = (searcher.search(qh, chunks),
                         searcher.search(qh, [(sub, 0)]))
    dup = q_emb[3:4]
    self_run = search.self_retrieve(np.concatenate([q_emb, dup]),
                                    [f"q{i}" for i in range(N_QUERIES + 1)],
                                    3, device=DEV)
    torch.cuda.synchronize()
    scan_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {"stacked": al.stacked_launches,
                "layernorm": norms.launch_counts()["layernorm"],
                "int8_gemm": mi.launches}
    want = {key: tower_want[0][key] + tower_want[1][key]
            for key in ("stacked", "layernorm")}
    want["int8_gemm"] = 1 + 1 + len(chunks) + 1   # pages, scan, chunks, one
    if launches != want or mi.route_counts() != {
            "hopper": want["int8_gemm"], "legacy": 0}:
        raise RuntimeError(f"[15] launches {launches}, K6 routes "
                           f"{mi.route_counts()}: want {want}, K6 on the "
                           f"Hopper kernel")
    _lengths_routes("[15]", {"flat": 0, "stacked": launches["stacked"],
                             "fwd_lse": 0})
    log(f"[15] SigLIP bi-tower (SiglipConfig(), {n_params / 1e9:.3f}B params, "
        f"random bf16 weights, built in {init_s:.2f} s): 16 pages -> "
        f"{tuple(pages.shape)}, 8 queries x {SIGLIP_TEXT_LEN} ids -> "
        f"{tuple(queries.shape)}, finite; launches per tower run: vision "
        f"{vision}, text {text} (K1 on the Hopper kernel); top-5 queries -> "
        f"pages fp32 {top5['none'].tolist()}, int8 {top5['int8'].tolist()}")
    log(f"[15] scan of {SCAN_ROWS} x {SCAN_DIM} unit rows, {SCAN_QUERIES} "
        f"planted queries, k {SCAN_K}: rank 1 fp32 {rank1['fp32']}, int8 "
        f"{rank1['int8']} of {SCAN_QUERIES}; top-{SCAN_K} overlap "
        f"{overlap:.4f}; peak {scan_peak_gb:.2f} GB; launches {launches}")
    if rank1 != {"fp32": SCAN_QUERIES, "int8": SCAN_QUERIES}:
        raise RuntimeError(f"planted queries not at rank 1: {rank1}")
    for quant, ((cs_, ci_), (ws_, wi_)) in stream.items():
        ok = np.array_equal(ci_, wi_) and tuple(ci_[0, :2]) == tie
        if quant == "int8":
            ok = ok and np.array_equal(cs_.view(np.uint32),
                                       ws_.view(np.uint32))
        log(f"[15] StreamingSearcher({quant}) over {STREAM_ROWS} rows in "
            f"{len(chunks)} chunks against one call: same ids "
            f"{np.array_equal(ci_, wi_)}, the duplicated row's tie "
            f"{ci_[0, :2].tolist()}")
        if not ok:
            raise RuntimeError(f"StreamingSearcher({quant}) chunked != whole")
    log(f"[15] self_retrieve over the 8 query embeddings and a copy of q3 "
        f"(q8): q8 -> {list(self_run['q8'])}, q3 -> {list(self_run['q3'])}")
    for qid in ("q3", "q8"):
        hits = list(self_run[qid])
        if "q3" not in hits or "q8" not in hits \
                or hits.index("q3") + 1 != hits.index("q8") \
                or self_run[qid]["q3"] != self_run[qid]["q8"]:
            raise RuntimeError(f"self_retrieve: the duplicate's tie is not "
                               f"at the lower index ({qid}: {hits})")
    with torch.inference_mode():
        tower_ms = {"pages": timing.measure(model.encode_image, patches,
                                            iters=5) * 1e3,
                    "queries": timing.measure(model.encode_text, ids,
                                              iters=5) * 1e3}
    log(f"[15] SigLIP encode (utils/timing.measure): 16 pages "
        f"{tower_ms['pages']:.3f} ms, 8 queries {tower_ms['queries']:.3f} "
        f"ms | {smi()}")
    del model, pages, queries, sub, stream
    gc.collect()
    torch.cuda.empty_cache()

    # the kernels' forms against their plain versions, timed
    checks = {"k1_vision": [_siglip_k1_check(
        gen, "SigLIP vision", [cfg.num_patches] * 16, cfg.num_patches,
        vc.num_attention_heads, vc.head_dim)]}
    checks["k1_text"] = [_siglip_k1_check(
        gen, "SigLIP text", [SIGLIP_TEXT_LEN] * N_QUERIES, SIGLIP_TEXT_LEN,
        tc.num_attention_heads, tc.head_dim), _siglip_k1_check(
        gen, "SigLIP text, masked", [1, 5, 63, 64], SIGLIP_TEXT_LEN,
        tc.num_attention_heads, tc.head_dim)]
    layer_rel = _siglip_layer_check(gen, vc, cfg.num_patches)
    checks["ln"] = [_check_norm(gen, f"SigLIP {label}", "ln", rows,
                                vc.hidden_size, torch.bfloat16,
                                torch.bfloat16, phase="[15]")
                    for label, rows in (("vision rows", 16 * cfg.num_patches),
                                        ("text rows",
                                         N_QUERIES * SIGLIP_TEXT_LEN))]
    sl = corpus[:QUANT_CHECK_ROWS]
    dq, ds = search.quantize_rows(sl)
    nq, ns = search.quantize_rows_np(sl.cpu().numpy())
    codes_equal = np.array_equal(dq.cpu().numpy(), nq)
    scales_equal = np.array_equal(ds.cpu().numpy().view(np.uint32),
                                  ns.view(np.uint32))
    quant_equal = codes_equal and scales_equal
    qq, qs = search.quantize_rows(q)
    kern = lambda: mi.int8_matmul_fused(qq, qs, cq, cs, None, torch.float32)
    plain = lambda: mi.int8_matmul_reference(qq, qs, cq, cs, None,
                                             torch.float32)
    out, ref = kern(), plain()
    torch.cuda.synchronize()
    k6_equal = torch.equal(out, ref)
    k6_err = (out - ref).abs().max().item()
    slice_equal = torch.equal(out[:, :QUANT_CHECK_ROWS],
                              ref[:, :QUANT_CHECK_ROWS])
    del out, ref
    k6 = {"shape": f"int8 scan {SCAN_QUERIES} x {SCAN_DIM} -> {SCAN_ROWS}, "
                   f"fp32 output", "max_abs_err": k6_err, "ms": cuda_ms(kern),
          "plain_ms": cuda_ms(plain, reps=3),
          "int_mm_ms": cuda_ms(lambda: torch._int_mm(qq, cq.t())),
          "library_ms": cuda_ms(lambda: torch._int_mm(qq, cq.t()).float()
                                * qs[:, None] * cs[None, :])}
    k6["bound_ms"], k6["bound_by"] = _scan_bound(
        SCAN_QUERIES, SCAN_DIM, SCAN_ROWS, 1, PEAK_INT8_OPS)
    checks["k6"] = [k6]
    log(f"[15] device quantize_rows on {QUANT_CHECK_ROWS} rows bit-equal to "
        f"quantize_rows_np: codes {codes_equal}, scales {scales_equal}; K6 {k6['shape']}: bit-equal to "
        f"int8_matmul_reference {k6_equal} (on the first {QUANT_CHECK_ROWS} "
        f"rows {slice_equal}) | kernel {k6['ms']:.4f} ms, plain "
        f"{k6['plain_ms']:.4f} ms, torch._int_mm alone {k6['int_mm_ms']:.4f} "
        f"ms, + scaling {k6['library_ms']:.4f} ms, bound "
        f"{k6['bound_ms']:.4f} ms ({k6['bound_by']}) | {smi()}")
    if not (quant_equal and k6_equal and slice_equal):
        raise RuntimeError("int8 scan: codes or K6 scores not bit-equal")
    scan = {"fp32_ms": timing.measure(search.topk_single, q, corpus, SCAN_K,
                                      iters=10) * 1e3,
            "int8_ms": timing.measure(search.topk_single_int8, q, cq, cs,
                                      SCAN_K, iters=10) * 1e3,
            "fp32_bound": _scan_bound(SCAN_QUERIES, SCAN_DIM, SCAN_ROWS, 4,
                                      PEAK_FP32),
            "int8_bound": _scan_bound(SCAN_QUERIES, SCAN_DIM, SCAN_ROWS, 1,
                                      PEAK_INT8_OPS)}
    host8, host32 = cq.cpu(), corpus.cpu()
    for name, host in (("int8", host8), ("fp32", host32)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dev = host.to(DEV)
        torch.cuda.synchronize()
        scan[f"upload_{name}_ms"] = (time.perf_counter() - t0) * 1e3
        del dev
    del host8, host32
    log(f"[15] scans of {SCAN_ROWS} x {SCAN_DIM} (utils/timing.measure, "
        f"topk included): fp32 {scan['fp32_ms']:.4f} ms (bound "
        f"{scan['fp32_bound'][0]:.4f}, {scan['fp32_bound'][1]}), int8 "
        f"{scan['int8_ms']:.4f} ms (bound {scan['int8_bound'][0]:.4f}, "
        f"{scan['int8_bound'][1]}); host upload (pageable) int8 "
        f"{scan['upload_int8_ms']:.1f} ms ({SCAN_ROWS * SCAN_DIM / 1e9:.2f} "
        f"GB), fp32 {scan['upload_fp32_ms']:.1f} ms "
        f"({4 * SCAN_ROWS * SCAN_DIM / 1e9:.2f} GB) | {smi()}")
    with tempfile.TemporaryDirectory() as trace_dir:
        with profiling.trace(trace_dir) as prof:
            search.topk_single_int8(q, cq, cs, SCAN_K)
            torch.cuda.synchronize()
        path = os.path.join(trace_dir, profiling.TRACE_FILE)
        with open(path) as f:
            in_trace = "int8_gemm_wgmma_kernel" in f.read()
        trace_kb = os.path.getsize(path) / 1e3
    k6_names = [e.key for e in prof.key_averages()
                if "int8_gemm_wgmma_kernel" in e.key]
    log(f"[15] utils/profiling.trace of the int8 scan: {trace_kb:.1f} kB, "
        f"K6's symbol in the trace {in_trace} ({k6_names[:1]})")
    if not (in_trace and k6_names):
        raise RuntimeError("K6's kernel is not in the profiler trace")
    del corpus, cq, cs, q, qq, qs, sl, dq, ds
    gc.collect()
    torch.cuda.empty_cache()
    gelu_stats = _gelu_sweep()
    twin = _synthesize_twin(gen)
    log(f"[15] phase 15 in {time.perf_counter() - t_phase:.1f} s")
    return {"scan_ids": scan_ids,
            "launches": {"vision": vision, "text": text, **launches},
            "checks": checks,
            "stats": {"layer_rel_err": layer_rel, "scan": scan,
                      "tower_ms": tower_ms, "init_s": init_s,
                      "scan_peak_gb": scan_peak_gb, "overlap": overlap,
                      "gelu": gelu_stats, "twin": twin}}


def ret_kernel_rows(ret):
    """The phase's rows: K1 stacked at SigLIP's vision and text shapes, K7
    LayerNorm at its rows, K6 at the scan's shape; launches from the
    phase's counted main path."""
    from visrag_tpu_torch.ops import attention_lengths as al
    from visrag_tpu_torch.ops import matmul_int8 as mi
    from visrag_tpu_torch.ops import norms
    lc, c = ret["launches"], ret["checks"]
    rows = []
    for key, name, source, replaces, launches in (
            ("k1_vision", "flash_fwd_lengths (SigLIP vision, 16/16, d=72, "
             "not causal)", al.SOURCE, REPLACES["fwd"],
             lc["vision"]["stacked"]),
            ("k1_text", "flash_fwd_lengths (SigLIP text, 16/16, d=72, not "
             "causal)", al.SOURCE, REPLACES["fwd"], lc["text"]["stacked"]),
            ("ln", "layernorm (SigLIP rows x 1152)", norms.SOURCE,
             norms.REPLACES["layernorm"], lc["layernorm"]),
            ("k6", "int8_matmul_fused (int8 corpus scan, fp32 scores)",
             mi.SOURCE, INT8_REPLACES, lc["int8_gemm"])):
        first = c[key][0]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches,
                     **{k: first[k] for k in KEYS}, "checks": c[key]})
    return rows


KEYS = ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
        "bound_by")


def segment_kernel_rows(seg_results, rl_launches):
    """K4's rows, and K1 + LSE / K2 at d = 128 with grouped kv heads (the
    padded update: launches from phase 9's padded micro-batch)."""
    from visrag_tpu_torch.ops import attention as seg
    from visrag_tpu_torch.ops import attention_lengths as al
    rows = [{"name": name, "route": "cuda", "source": seg.HOPPER_SOURCE,
             "replaces": SEG_REPLACES[kind], "launches": rl_launches[kind],
             **{k: seg_results[kind][0][k] for k in KEYS},
             "pr4_ms": seg_results[kind][0].get("pr4_ms"),
             "checks": seg_results[kind]}
            for kind, name in (("seg_fwd", "segment_fwd"),
                               ("seg_dq", "segment_bwd_dq"),
                               ("seg_dkv", "segment_bwd_dkv"))]
    k2 = seg_results["k2"]
    for kind, name, source, replaces in (
            ("fwd_lse", "flash_fwd_lse (GQA, d=128)", al.SOURCE,
             REPLACES["fwd"]),
            ("dq", "flash_bwd_dq (GQA, d=128)", al.BWD_SOURCE,
             REPLACES["dq"]),
            ("dkv", "flash_bwd_dkv (GQA, d=128)", al.BWD_SOURCE,
             REPLACES["dkv"])):
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces,
                     "launches": rl_launches["padded_update"][kind],
                     **{k: k2[kind][0][k] for k in KEYS},
                     **({"pr1_ms": k2[kind][0]["pr1_ms"]}
                        if kind == "fwd_lse" else
                        {"pr5_ms": k2[kind][0]["pr5_ms"]}),
                     "checks": k2[kind]})
    return rows


def norm_kernel_rows(norm_results, sft_launches, encode_launches):
    """K7's rows: RMSNorm with its launches from phase 10's SFT run and its
    numbers at the SFT batch's shape; LayerNorm with its launches from
    phase 3's encode (None: not run) and its numbers at the ViT's
    shape."""
    from visrag_tpu_torch.ops import norms
    out = []
    for name, launches in (
            ("rmsnorm", sft_launches["run"]["rmsnorm"]),
            ("layernorm", None if encode_launches is None
             else encode_launches["layernorm"])):
        first = norm_results[name][0]
        out.append({"name": name, "route": "cuda", "source": norms.SOURCE,
                    "replaces": norms.REPLACES[name], "launches": launches,
                    **{k: first[k] for k in KEYS},
                    **({"pr6_ms": first["pr6_ms"]}
                       if name == "rmsnorm" else {}),
                    "checks": norm_results[name]})
    return out


def gen_phases(gen):
    """Phases 12, 13 and 14. → {"12": phase 12's (launches, checks,
    stats), "13": phase 13's (launches, checks, stats)}."""
    out = {"12": phase12_minicpmv(gen)}
    gc.collect()            # the phase's wrapped methods hold reference
    torch.cuda.empty_cache()  # cycles to its model and engines
    out["13"] = phase13_minicpmv26(gen)
    gc.collect()
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="visrag_demo_")
    try:
        phase14_demo(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def gen_kernel_rows(gen_results):
    """The VisRAG-Gen rows: K1 stacked at MiniCPM-2B's generation prefill
    and at MiniCPM-V 2.6's (GQA), launches from phases 12 and 13; K5 at
    MiniCPM-2B's 36/36 d 64 decode, launches from phase 12's engine."""
    from visrag_tpu_torch.ops import attention_lengths as al
    from visrag_tpu_torch.serving import paged_kv as pk
    l12, c12, _ = gen_results["12"]
    l13, c13, _ = gen_results["13"]
    k5 = c12["k5"][0]
    return [
        {"name": "flash_fwd_lengths (MiniCPM-2B generation prefill, 36/36, "
                 "d=64)", "route": "cuda", "source": al.SOURCE,
         "replaces": REPLACES["fwd"], "launches": l12["stacked"],
         **{k: c12["k1"][0][k] for k in KEYS}, "checks": c12["k1"]},
        {"name": "flash_fwd_lengths (MiniCPM-V 2.6 prefill, GQA 28/4, "
                 "d=128)", "route": "cuda", "source": al.SOURCE,
         "replaces": REPLACES["fwd"], "launches": l13["stacked"],
         **{k: c13["k1"][0][k] for k in KEYS}, "checks": c13["k1"]},
        {"name": "paged_decode_attention (MiniCPM-2B 36/36, d 64)",
         "route": "cuda", "source": pk.SOURCE, "replaces": REPLACES["paged"],
         "launches": l12["paged"], **{k: k5[k] for k in KEYS},
         "gather_sdpa_ms": k5["gather_sdpa_ms"], "checks": c12["k5"]}]


# ---------------------------------------------------------------------------
# Phase 16: the multi-GPU layer as a one-rank NCCL group
# ---------------------------------------------------------------------------

DIST_EVAL_BATCH = 8        # eval_retriever --batch-size on the 16 pages
DIST_TRAIN_STEPS = 2
DIST_SFT_STEPS = 2
DIST_LORA_RANK = 8
# LoRA's learning rate: large enough that one step of the rank-8 adapters
# (scale alpha / r = 8) moves bf16 weights of the merged model
DIST_LORA_LR = 1e-4
# the 3B's 16/2 heads under 2- and 4-way Ulysses: every rank attends the
# whole sequence at (query heads, kv heads) = 16/n, 2 → 1 (repeated by
# n // gcd(2, n) before the all_to_all); the SFT batch's rows and the RL
# packed update's
ULYSSES_SHAPES = ((2, 8, 1), (4, 4, 1))


def _coordinator():
    from visrag_tpu_torch.mesh import free_port
    return ["--coordinator", f"localhost:{free_port()}", "--process-id", "0",
            "--num-processes", "1"]


def _dist_eval(work):
    """eval_retriever on the 16 pages and 8 queries at full width: one
    device, then under --coordinator (the driver makes and ends its
    one-rank NCCL group: DP encode, sharded fp32 search). → the launch
    counts of the distributed run."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    from visrag_tpu_torch.driver import eval_retriever
    from visrag_tpu_torch.ops import attention_lengths as al
    from visrag_tpu_torch.ops import norms
    from visrag_tpu_torch.retrieval.trec import load_from_trec
    pages = _pages(0)
    images = []
    for _, img in pages:
        buf = io.BytesIO()
        img.save(buf, format="PNG", compress_level=1)
        images.append({"bytes": buf.getvalue()})
    pq.write_table(pa.table({
        "corpus-id": [f"p{i}" for i in range(N_PAGES)],
        "text": [""] * N_PAGES, "image": images}), f"{work}/corpus.parquet")
    pq.write_table(pa.table({
        "query-id": [f"q{i}" for i in range(N_QUERIES)],
        "query": [t for t, _ in _queries(N_QUERIES)]}),
        f"{work}/queries.parquet")
    with open(f"{work}/qrels.tsv", "w") as f:
        f.write("query-id\tcorpus-id\tscore\n" + "".join(
            f"q{i}\tp{i}\t1\n" for i in range(N_QUERIES)))
    runs, launches, secs = {}, None, {}
    for name, extra in (("one", []), ("dist", _coordinator())):
        argv = ["--corpus", f"{work}/corpus.parquet",
                "--queries", f"{work}/queries.parquet",
                "--qrels", f"{work}/qrels.tsv",
                "--output-dir", f"{work}/eval_{name}",
                "--batch-size", str(DIST_EVAL_BATCH), "--depth", "10",
                "--device", DEV, *extra]
        al.reset_launch_counts()
        norms.reset_launch_counts()
        t0 = time.perf_counter()
        if eval_retriever.main(argv) != 0:
            raise RuntimeError(f"eval_retriever ({name}) failed")
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        launches = {**al.launch_counts(), **norms.launch_counts()}
        runs[name] = load_from_trec(f"{work}/eval_{name}/test.trec")
        gc.collect()
        torch.cuda.empty_cache()
    same = {q: list(d) for q, d in runs["dist"].items()} == \
        {q: list(d) for q, d in runs["one"].items()}
    log(f"[16] eval_retriever on {N_PAGES} pages, {N_QUERIES} queries: one "
        f"device {secs['one']:.1f} s, one-rank NCCL group (--coordinator) "
        f"{secs['dist']:.1f} s incl. model init; ranked ids equal {same}; "
        f"launches of the distributed run {launches}")
    if not same:
        raise RuntimeError("eval_retriever across ranks ranked other ids")
    if not (launches["flat"] > 0 and launches["stacked"] > 0
            and launches["layernorm"] > 0 and launches["rmsnorm"] > 0):
        raise RuntimeError(f"eval_retriever launches {launches}")
    return launches


def _dist_scan(mesh, scan_ids):
    """make_sharded_topk over phase 15's corpus, fp32 and int8 (K6), ids
    and scores bit for bit the one-device scan's (phase 15's when given).
    → (K6 launches, timings)."""
    from visrag_tpu_torch.ops import matmul_int8 as mi
    from visrag_tpu_torch.retrieval import search
    from visrag_tpu_torch.utils import timing
    corpus, cq, cs, q, planted = _scan_inputs()
    ref = scan_ids or {
        "none": tuple(t.cpu() for t in search.topk_single(q, corpus,
                                                          SCAN_K)),
        "int8": tuple(t.cpu() for t in search.topk_single_int8(q, cq, cs,
                                                               SCAN_K))}
    fns = {quant: search.make_sharded_topk(mesh, SCAN_K, quant)
           for quant in search.QUANTS}
    args = {"none": (q, corpus, SCAN_ROWS), "int8": (q, cq, cs, SCAN_ROWS)}
    mi.reset_launch_counts()
    got = {quant: fns[quant](*args[quant]) for quant in search.QUANTS}
    torch.cuda.synchronize()
    k6 = mi.launches
    equal = {quant: torch.equal(got[quant][1].cpu(), ref[quant][1])
             and torch.equal(got[quant][0].cpu(), ref[quant][0])
             for quant in search.QUANTS}
    ms = {quant: timing.measure(fns[quant], *args[quant]) * 1e3
          for quant in search.QUANTS}
    log(f"[16] make_sharded_topk at one rank over {SCAN_ROWS} x {SCAN_DIM}, "
        f"{SCAN_QUERIES} queries, k {SCAN_K}: ids and scores bit-equal to "
        f"{'phase 15' if scan_ids else 'the one-device scan'} {equal}; "
        f"fp32 {ms['none']:.4f} ms, int8 {ms['int8']:.4f} ms (merge and "
        f"all_gather included); K6 launches {k6} | {smi()}")
    del corpus, cq, cs, q, planted
    torch.cuda.empty_cache()
    if not all(equal.values()) or k6 != 1:
        raise RuntimeError(f"sharded scan: equal {equal}, K6 launches {k6}")
    return k6, ms


def _sft_batch_ids():
    """The segment masks of phase 10's first SFT batch (4 rows up to 4096
    tokens, right-padded to a multiple of 128). → (B, S) int32 numpy."""
    import numpy as np
    from visrag_tpu_torch.driver import sft_main
    tok = RLStandInTokenizer()
    pairs = []
    for i, (np_, nr) in enumerate(SFT_ROWS[:SFT_BATCH]):
        row = {"prompt": " ".join(f"q{i}w{j}" for j in range(np_)),
               "response": " ".join(f"a{i}w{j}" for j in range(nr))}
        pairs.append(sft_main.encode_sft_row(row, tok, tok, SFT_MAX_LEN))
    batch = sft_main.make_sft_batch(pairs)
    return batch["attention_mask"].astype(np.int32)


def _dist_ulysses(mesh, gen, ids_np, tag):
    """K4 under Ulysses at the per-rank shapes of 2- and 4-way sequence
    parallelism on rows with segment ids `ids_np` (the 3B SFT batch, or
    the packed update of phase 9): parallel.ulysses_attention over the
    one-rank seq group (its all_to_alls over NCCL) forward and backward,
    launches counted; then K4's forward, dq and dk/dv at those shapes
    against the plain versions, timed (phase 8's check). → ({n: K4
    launches}, {n: records})."""
    from visrag_tpu_torch.mesh import SEQ, axis_group
    from visrag_tpu_torch.ops import attention as seg
    from visrag_tpu_torch.parallel.ulysses import ulysses_attention
    ids = torch.as_tensor(ids_np, device=DEV)
    b, s = ids_np.shape
    group = axis_group(mesh, SEQ)
    launches, records = {}, {}
    for n, h, hk in ULYSSES_SHAPES:
        label = (f"Ulysses {n}-way per rank, {tag} {b} x {s}, {h}/{hk} "
                 f"heads d 128")
        q, k, v = (torch.randn((b, s, x, 128), generator=gen, device=DEV,
                               dtype=torch.bfloat16).requires_grad_()
                   for x in (h, hk, hk))
        seg.reset_launch_counts()
        o = ulysses_attention(q, k, v, group, q_seg=ids, kv_seg=ids,
                              causal=True)
        o.float().square().mean().backward()
        torch.cuda.synchronize()
        launches[n] = seg.launch_counts()
        if not all(launches[n][kind] == 1 for kind in SEG_REPLACES) or \
                not torch.isfinite(q.grad.float()).all():
            raise RuntimeError(f"[16] {label}: launches {launches[n]}")
        del q, k, v, o
        records[n] = _check_segment_kernels(label, ids_np, ids_np, h, hk,
                                            128, True, gen)
        log(f"[16] {label}: ulysses_attention forward + backward launched "
            f"{launches[n]}")
    return launches, records


def _rl_packed_ids(work):
    """The segment ids of phase 9's first packed micro-batch (its prompts
    encoded by the driver's encode_qwen_prompt_row, RL_RESPONSE_TOKENS
    each, 4 samples a prompt), as phase 8 builds them."""
    from visrag_tpu_torch.driver.common import encode_qwen_prompt_row
    from visrag_tpu_torch.models.qwen25_vl import Qwen25VLConfig
    tok = RLStandInTokenizer()
    rollout_cfg = _rl_config(work, 1).rollout
    with open(_rl_rows(work)) as f:
        prompts = [encode_qwen_prompt_row(json.loads(line), tok, tok,
                                          Qwen25VLConfig.b3(), rollout_cfg)
                   for line in f]
    seqlens = [len(p["input_ids"]) + RL_RESPONSE_TOKENS
               for p in prompts for _ in range(4)]
    return _packed_ids(seqlens, 16384)[0]


def _dist_train(work, phase5_losses):
    """train_retriever.main under --coordinator at full width: phase 5's
    run (16 pairs, GradCache micro-batch 4, bf16 AdamW, remat) for
    DIST_TRAIN_STEPS steps with FSDP2 over the one-rank group and the
    cross-device negatives' path; its losses against phase 5's (run here
    on one device when phase 5 did not run). → the launch counts."""
    from visrag_tpu_torch.driver import train_retriever
    from visrag_tpu_torch.ops import attention_lengths as al
    from visrag_tpu_torch.ops import norms
    data = f"{work}/train.parquet"
    _write_train_parquet(data, _pages(0), N_PAGES)

    def argv(out):
        return ["--train-data", data, "--output-dir", out,
                "--set", f"train.max_steps={DIST_TRAIN_STEPS}",
                "--set", f"train.epochs={TRAIN_STEPS}",
                "--set", "train.grad_cache=true",
                "--set", f"train.grad_cache_micro_batch_size={MICRO}",
                "--set", "train.optimizer_state_dtype=bfloat16",
                "--set", "model.remat=true", "--set", "model.pooling=wmean",
                "--set", "train.lr=5e-6", "--set", "train.grad_clip=1.0",
                "--set", "train.softmax_temperature=0.02",
                "--set", f"data.batch_size={N_PAGES}",
                "--set", "train.log_every=1",
                "--set", f"train.save_every={DIST_TRAIN_STEPS}"]

    def losses(out):
        with open(f"{out}/metrics.jsonl") as f:
            return [json.loads(line)["loss"] for line in f]

    if phase5_losses is None:
        if train_retriever.main(argv(f"{work}/one")) != 0:
            raise RuntimeError("train_retriever (one device) failed")
        phase5_losses = losses(f"{work}/one")
        shutil.rmtree(f"{work}/one", ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    al.reset_launch_counts()
    norms.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if train_retriever.main(argv(f"{work}/dist") + _coordinator()) != 0:
        raise RuntimeError("train_retriever under --coordinator failed")
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {**al.launch_counts(), **norms.launch_counts()}
    got = losses(f"{work}/dist")
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, phase5_losses))
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"[16] train_retriever under --coordinator (FSDP2 over the one-rank "
        f"group, GradCache, negatives gathered): {DIST_TRAIN_STEPS} steps in "
        f"{run_s:.1f} s incl. model init and the full-state checkpoint | "
        f"losses {[round(x, 5) for x in got]} against one device's "
        f"{[round(x, 5) for x in phase5_losses[:DIST_TRAIN_STEPS]]}: "
        f"max rel err {rel:.3g} (bound {RTOL_TRAIN}) | peak {peak:.2f} GB | "
        f"launches {launches}")
    shutil.rmtree(f"{work}/dist", ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    if len(got) != DIST_TRAIN_STEPS or not rel <= RTOL_TRAIN:
        raise RuntimeError(f"distributed training losses {got} against "
                           f"{phase5_losses}")
    if not all(launches[k] > 0 for k in ("flat", "stacked", "fwd_lse", "dq",
                                         "dkv", "layernorm", "rmsnorm")):
        raise RuntimeError(f"distributed training launches {launches}")
    return launches


def _run_sft(model, step, scfg, rows, out_dir):
    """sft_main.run_sft over phase 10's rows with the stand-in tokenizer,
    its saved weights removed after. → the steps' metrics."""
    from visrag_tpu_torch.driver import sft_main
    tok = RLStandInTokenizer()
    try:
        return sft_main.run_sft(
            model, step, scfg, rows,
            lambda row: sft_main.encode_sft_row(row, tok, tok, SFT_MAX_LEN),
            batch_size=SFT_BATCH, output_dir=out_dir)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def _dist_sft(work, phase10_history=None):
    """sft_main's build_sft / run_sft at Qwen2.5-VL-3B's full width on a
    one-rank mesh (seq 1: sp_flash_attention falls through to K1 / K2),
    FSDP2 over the group, DIST_SFT_STEPS steps of phase 10's rows from
    phase 10's seed and lr, rank 0 saving the full weights; the losses and
    grad norms bit for bit phase 10's (run here on one device, without a
    mesh, when phase 10 did not run): one rank computes one device's
    step. → the launch counts."""
    from visrag_tpu_torch import mesh as vmesh
    from visrag_tpu_torch.config import MeshConfig
    from visrag_tpu_torch.driver import sft_main
    from visrag_tpu_torch.driver.common import build_qwen25_vl
    from visrag_tpu_torch.models.qwen25_vl import Qwen25VLConfig
    from visrag_tpu_torch.ops import attention_lengths as al
    from visrag_tpu_torch.ops import norms
    from visrag_tpu_torch.training.sft import SFTConfig
    cfg = Qwen25VLConfig.b3()
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text,
                                                            remat=True))
    # phase 10's optimizer: warmup 1 step, then the constant lr
    scfg = SFTConfig(lr=SFT_LR, warmup_steps=1, total_steps=DIST_SFT_STEPS,
                     optimizer_state_dtype="float32", ulysses_size=1)
    rows = _sft_rows(work)
    if phase10_history is None:
        model = build_qwen25_vl(cfg, device=DEV, seed=0)
        _, step = sft_main.build_sft(model, scfg)
        phase10_history = _run_sft(model, step, scfg, rows,
                                   f"{work}/sft_one")
        del model, step
        gc.collect()
        torch.cuda.empty_cache()
    with vmesh.distributed(f"localhost:{vmesh.free_port()}", 0, 1, DEV):
        mesh = vmesh.build_mesh(MeshConfig(seq=scfg.ulysses_size))
        model = build_qwen25_vl(cfg, device=DEV, seed=0)
        _, step = sft_main.build_sft(model, scfg, mesh)
        al.reset_launch_counts()
        norms.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        hist = _run_sft(model, step, scfg, rows, f"{work}/sft_dist")
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = {**al.launch_counts(), **norms.launch_counts()}
        peak = torch.cuda.max_memory_allocated() / 1e9
        del model, step
    gc.collect()
    torch.cuda.empty_cache()
    one = phase10_history[:DIST_SFT_STEPS]
    rel = max(abs(g[k] - w[k]) / abs(w[k]) for g, w in zip(hist, one)
              for k in ("loss", "grad_norm"))
    same = [(g["loss"], g["grad_norm"]) for g in hist] == \
        [(w["loss"], w["grad_norm"]) for w in one]
    log(f"[16] SFT through sft_main.build_sft / run_sft on a one-rank mesh "
        f"(FSDP2, ulysses_size 1): {len(hist)} steps in {run_s:.1f} s incl. "
        f"the full-weights save | losses "
        f"{[round(m['loss'], 6) for m in hist]}, grad norms "
        f"{[round(m['grad_norm'], 5) for m in hist]} against one device's "
        f"{[round(m['loss'], 6) for m in one]}, "
        f"{[round(m['grad_norm'], 5) for m in one]}: max rel err {rel:.3g}, "
        f"bit for bit {same} (bound: bit for bit) | peak {peak:.2f} GB | "
        f"launches {launches}")
    if len(hist) != DIST_SFT_STEPS or not same:
        raise RuntimeError(f"distributed SFT {hist} against one device's "
                           f"{one}")
    if not all(launches[k] > 0 for k in ("fwd_lse", "dq", "dkv", "rmsnorm")):
        raise RuntimeError(f"distributed SFT launches {launches}")
    return launches


def _capture_batches(trainer):
    """Keep each step's token ids and rewards (trainer.make_batch
    wrapped). → the list they go into."""
    seen = []
    make = trainer.make_batch

    def make_batch(*a, **kw):
        batch = make(*a, **kw)
        if batch is not None:
            seen.append({k: batch[k].copy()
                         for k in ("input_ids", "reward_tensor")})
        return batch
    trainer.make_batch = make_batch
    return seen


def _dist_lora(work):
    """16e: train_retriever.main with train.lora_rank=DIST_LORA_RANK at
    phase 5's settings (lr DIST_LORA_LR) for DIST_TRAIN_STEPS steps, on
    one device and under --coordinator (FSDP2 over the one-rank group,
    each block's frozen base and its adapters one unit, the optimizer on
    the adapters alone): the losses and grad norms bit for bit; rank 0's
    merged_model reloaded embeds a page as the adapted model does. → the
    distributed run's launch counts."""
    from visrag_tpu_torch.config import ModelConfig, TrainConfig
    from visrag_tpu_torch.driver import train_retriever
    from visrag_tpu_torch.driver.common import build_visrag_ret
    from visrag_tpu_torch.ops import attention_lengths as al
    from visrag_tpu_torch.ops import norms
    from visrag_tpu_torch.preprocess import MockTokenizer, build_encode_batch
    from visrag_tpu_torch.preprocess.device import (finish_encode_batch,
                                                    pos_table_tensor)
    from visrag_tpu_torch.training.checkpoint import (find_latest_ckpt,
                                                      load_checkpoint,
                                                      load_state_into)
    from visrag_tpu_torch.training.lora import lora_init, lora_merge
    data = f"{work}/train.parquet"
    if not os.path.exists(data):
        _write_train_parquet(data, _pages(0), N_PAGES)

    def argv(out):
        return ["--train-data", data, "--output-dir", out,
                "--set", f"train.max_steps={DIST_TRAIN_STEPS}",
                "--set", f"train.epochs={TRAIN_STEPS}",
                "--set", "train.grad_cache=true",
                "--set", f"train.grad_cache_micro_batch_size={MICRO}",
                "--set", "train.optimizer_state_dtype=bfloat16",
                "--set", "model.remat=true", "--set", "model.pooling=wmean",
                "--set", f"train.lr={DIST_LORA_LR}",
                "--set", "train.grad_clip=1.0",
                "--set", "train.softmax_temperature=0.02",
                "--set", f"data.batch_size={N_PAGES}",
                "--set", "train.log_every=1",
                "--set", f"train.lora_rank={DIST_LORA_RANK}",
                "--set", f"train.save_every={DIST_TRAIN_STEPS}"]

    hist, secs, launches, peak = {}, {}, None, 0.0
    for name, extra in (("one", []), ("dist", _coordinator())):
        out = f"{work}/lora_{name}"
        al.reset_launch_counts()
        norms.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if train_retriever.main(argv(out) + extra) != 0:
            raise RuntimeError(f"train_retriever with LoRA ({name}) failed")
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        launches = {**al.launch_counts(), **norms.launch_counts()}
        peak = torch.cuda.max_memory_allocated() / 1e9
        with open(f"{out}/metrics.jsonl") as f:
            hist[name] = [(m["loss"], m["grad_norm"])
                          for m in map(json.loads, f)]
        if name == "one":
            shutil.rmtree(out, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    rel = max(abs(a - b) / abs(b) for g, w in zip(hist["dist"], hist["one"])
              for a, b in zip(g, w))
    same = hist["dist"] == hist["one"]

    # rank 0's merged save against the adapted model on one page
    tree, _ = load_checkpoint(find_latest_ckpt(f"{work}/lora_dist"))
    model, pcfg = build_visrag_ret(ModelConfig(pooling="wmean"), device=DEV,
                                   seed=0)
    lora_init(model, rank=DIST_LORA_RANK, alpha=TrainConfig().lora_alpha,
              generator=torch.Generator(device=DEV).manual_seed(0))
    load_state_into(model, tree["model"])
    page = finish_encode_batch(
        build_encode_batch(MockTokenizer(), _pages(0)[:1], pcfg,
                           device_mode=True),
        pos_table_tensor(pcfg.src_grid, DEV))
    merged = tree["merged_model"]
    moved = sum(int((merged[k] != tree["model"][k]).sum())
                for k in merged if f"{k[:-len('weight')]}lora_a"
                in tree["model"])
    with torch.inference_mode():
        adapted = model(page).float()
    model = lora_merge(model)
    model.load_state_dict(merged)
    with torch.inference_mode():
        reloaded = model(page).float()
    err = float((adapted - reloaded).abs().max())
    del model, tree, merged, page
    shutil.rmtree(f"{work}/lora_dist", ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[16e] train_retriever with train.lora_rank={DIST_LORA_RANK} "
        f"(lr {DIST_LORA_LR}, otherwise phase 5's settings), "
        f"{DIST_TRAIN_STEPS} steps: one device {secs['one']:.1f} s, "
        f"--coordinator (FSDP2, base and adapters one unit a block) "
        f"{secs['dist']:.1f} s incl. model init and the saves | (loss, grad "
        f"norm) {hist['dist']} against one device's {hist['one']}: bit for "
        f"bit {same}, max rel err {rel:.3g} | merged_model written by rank "
        f"0: {moved} base weights moved by the adapters; one page embedded "
        f"by the reloaded merged model against the adapted model: max abs "
        f"err {err:.3g} (bound {RTOL_BLOCK}) | peak {peak:.2f} GB | "
        f"launches {launches}")
    if not same or not err <= RTOL_BLOCK or moved == 0:
        raise RuntimeError(f"LoRA under a mesh: {hist} against one "
                           f"device's, merged embedding err {err}, "
                           f"{moved} weights moved")
    if not all(launches[k] > 0 for k in ("flat", "stacked", "fwd_lse", "dq",
                                         "dkv", "layernorm", "rmsnorm")):
        raise RuntimeError(f"LoRA training launches {launches}")
    return launches


def _rl_run(work, model_cfg, rcfg, mesh=None, gae=False, keep=None,
            replay=None, rows_path=None, rollouts=None, every_step=False):
    """rl_main's build_trainer (and build_critic with gae) on Qwen2.5-VL
    of seed 0 and run_training over phase 9's prompts (or the jsonl at
    `rows_path`) and reward, without a save; with `mesh` (rl_main.rl_mesh)
    across its ranks. `keep`: a list that takes each step's whole batch
    as make_batch made it; `replay`: one batch a step, which make_batch
    gives the update in place of the one its rollout made; `rollouts`: a
    list that takes each rollout's record (_tp_recording over the model
    the engine serves, every decode step's logits with `every_step`). →
    (history, each step's token ids and rewards, launch counts, seconds,
    peak GB)."""
    from visrag_tpu_torch.driver.common import (build_qwen25_vl,
                                                encode_qwen_prompt_row)
    from visrag_tpu_torch.driver.rl_main import (build_critic, build_trainer,
                                                 run_training)
    from visrag_tpu_torch.ops import attention as seg
    from visrag_tpu_torch.ops import attention_kvgrid as kg
    from visrag_tpu_torch.ops import attention_lengths as al
    from visrag_tpu_torch.ops import norms
    from visrag_tpu_torch.serving import paged_kv as pk
    tok = RLStandInTokenizer()
    rows_path = rows_path or _rl_rows(work)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_qwen25_vl(model_cfg, device=DEV, seed=0)
    ref_model = copy.deepcopy(model) if rcfg.actor.kl_coef > 0 else None
    critic = build_critic(model, rcfg, seed=0, mesh=mesh) if gae else None
    trainer = build_trainer(model, rcfg, tok, tok, ref_model=ref_model,
                            critic=critic, mesh=mesh)
    if replay is not None or keep is not None:
        make, steps = trainer.make_batch, iter(replay or ())

        def make_batch(*a, **kw):
            batch = make(*a, **kw)
            if keep is not None:
                keep.append(copy.deepcopy(batch))
            return batch if replay is None else copy.deepcopy(next(steps))
        trainer.make_batch = make_batch
    batches = _capture_batches(trainer)
    for mod in (al, kg, pk, seg, norms):
        mod.reset_launch_counts()
    served = trainer.model if trainer._rollout_model is None \
        else trainer._rollout_model
    with _tp_recording(served, every_step) if rollouts is not None \
            else contextlib.nullcontext([]) as runs:
        history = run_training(
            trainer, rcfg, rows_path,
            lambda row: encode_qwen_prompt_row(row, tok, tok, model_cfg,
                                               rcfg.rollout),
            save_final=False)
    if rollouts is not None:
        rollouts.extend(runs)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {**al.launch_counts(), "kvgrid": kg.launches,
                "paged": pk.launches, **seg.launch_counts(),
                **norms.launch_counts()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    del trainer, critic, model, ref_model
    gc.collect()
    torch.cuda.empty_cache()
    return [m for _, m in history], batches, launches, secs, peak


def _same_batches(got, want):
    return len(got) >= 1 and len(want) >= 1 and all(
        got[0][k].shape == want[0][k].shape and (got[0][k] == want[0][k])
        .all() for k in ("input_ids", "reward_tensor"))


def _dist_rl(work, rl_ref=None, gae_ref=None):
    """16f: RS-GRPO through rl_main's rl_mesh, build_trainer and
    run_training over a one-rank NCCL group at phase 9's 3B configuration
    (FSDP2 actor and reference policy, the rollout on the whole copy),
    RL_STEPS steps, against phase 9's run (run here on one device when it
    did not run): step 1's token ids and rewards equal and its loss bit
    for bit, step 2's loss within the one-rank bound (bit for bit); then
    one GAE step at phase 11's settings (the critic sharded too) held the
    same way to phase 11's first. → the runs' launch counts."""
    from visrag_tpu_torch import mesh as vmesh
    from visrag_tpu_torch.driver.rl_main import rl_mesh
    from visrag_tpu_torch.models.qwen25_vl import Qwen25VLConfig
    r = dataclasses.replace
    cfg = Qwen25VLConfig.b3()
    cfg = r(cfg, text=r(cfg.text, remat=True))
    rcfg = _rl_config(f"{work}/rl_dist", RL_STEPS)
    rcfg = r(rcfg, trainer=r(rcfg.trainer, save_freq=0))
    gcfg = r(cfg, text=r(cfg.text, num_hidden_layers=GAE_LAYERS))
    grcfg = _rl_config(f"{work}/gae_dist", 1)
    grcfg = r(grcfg, algorithm=r(grcfg.algorithm, adv_estimator="gae"),
              actor=r(grcfg.actor, kl_coef=0.0),
              trainer=r(grcfg.trainer, critic_warmup=1, save_freq=0))
    held_to = "phase 9's" if rl_ref is not None else "one device's"
    if rl_ref is None:
        rl_ref = _rl_run(work, cfg, rcfg)[:2]
    if gae_ref is None:
        gae_ref = _rl_run(work, gcfg, grcfg, gae=True)[:2]
    runs = {}
    for name, mcfg, c, gae in (("rl", cfg, rcfg, False),
                               ("gae", gcfg, grcfg, True)):
        with vmesh.distributed(f"localhost:{vmesh.free_port()}", 0, 1, DEV):
            runs[name] = _rl_run(work, mcfg, c, rl_mesh(c), gae=gae)
    hist, batches, launches, secs, peak = runs["rl"]
    ref_hist, ref_batches = rl_ref
    same_rollout = _same_batches(batches, ref_batches)
    losses = [m["loss"] for m in hist]
    ref_losses = [m["loss"] for m in ref_hist[:RL_STEPS]]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    ghist, gbatches, glaunches, gsecs, gpeak = runs["gae"]
    keys = ("critic/vf_loss", "critic/grad_norm", "critic/values/mean")
    gsame = _same_batches(gbatches, gae_ref[1]) and all(
        ghist[0][k] == gae_ref[0][0][k] for k in keys)
    log(f"[16f] RS-GRPO through rl_main.rl_mesh / build_trainer / "
        f"run_training on a one-rank NCCL group (FSDP2 actor and reference "
        f"policy, the engine on the whole copy), {RL_STEPS} steps in "
        f"{secs:.1f} s incl. init | step 1 token ids and rewards equal to "
        f"{held_to} {same_rollout} | "
        f"losses {losses} against {ref_losses}: step 1 bit for bit "
        f"{losses[0] == ref_losses[0]}, step 2 rel err "
        f"{abs(losses[1] - ref_losses[1]) / abs(ref_losses[1]):.3g} (max "
        f"{rel:.3g}; bound: bit for bit) | peak {peak:.2f} GB | launches "
        f"{launches}")
    log(f"[16f] GAE, {GAE_LAYERS} text layers, one step (critic warmup) on "
        f"a one-rank group, critic sharded: {gsecs:.1f} s incl. init | "
        f"token ids and rewards equal and {keys} "
        f"{[ghist[0][k] for k in keys]} against "
        f"{[gae_ref[0][0][k] for k in keys]}: bit for bit {gsame} | peak "
        f"{gpeak:.2f} GB | launches {glaunches}")
    if not same_rollout or losses != ref_losses or not gsame:
        raise RuntimeError(f"RS-GRPO across ranks: rollout equal "
                           f"{same_rollout}, losses {losses} against "
                           f"{ref_losses}; GAE equal {gsame}")
    if not all(launches[k] > 0 for k in ("stacked", "kvgrid", "paged",
                                         "seg_fwd", "seg_dq", "seg_dkv",
                                         "rmsnorm")) or \
            not all(glaunches[k] > 0 for k in ("stacked", "fwd_lse", "dq",
                                               "dkv", "paged")):
        raise RuntimeError(f"RS-GRPO across ranks launches {launches}, "
                           f"GAE {glaunches}")
    return {"rl": launches, "gae": glaunches}


TP_WORLD = 2              # phase 16h: two ranks on the one card over gloo
TP_NEW_TOKENS = 32
TP_RL_LAYERS = 8          # the hybrid rollout's 3B text depth (of 36)
TP_RL_STEPS = 2           # step 2's rollout runs on the refilled shards
TP_JOB_TIMEOUT = 600      # s, one job of the two ranks
# phase 7's requests that 16h serves: the text pair (batched prefill) and
# the small page with its n = 2 fork (whole prefill, the vision tower);
# the 3-page requests (chunked prefill) cost ~12 s each a run over gloo,
# and the CPU tests hold chunked prefill under tensor parallelism
TP_REQUESTS = ("text0", "text1", "page1_small")


@contextlib.contextmanager
def _tp_recording(model, every_step):
    """While open, each Engine.run over `model` appends to the yielded
    list a record of what phase 16h compares: its requests' tokens,
    prompts, sampling and group leaders; the logits of every prompt end
    (the rows of each prefill and final-chunk call, in call order, and the
    leaders in the order of their first tokens) and of the first decode
    step, or (every_step) of every decode step, with the request each
    active slot serves; the run's schedule, seconds and pool heads."""
    from visrag_tpu_torch.serving.engine import Engine
    runs, state = [], {}
    calls = {n: getattr(model, n) for n in ("prefill", "prefill_chunk",
                                            "decode")}

    def prefill(*a, **kw):
        out = calls["prefill"](*a, **kw)
        state["prefill"].extend(out[0].float().cpu())
        return out

    def prefill_chunk(*a, **kw):
        out = calls["prefill_chunk"](*a, **kw)
        if out is not None:
            state["prefill"].extend(out.float().cpu())
        return out

    def decode(*a, **kw):
        out = calls["decode"](*a, **kw)
        engine = state["engine"]
        if every_step or not state["decode"]:
            rids = [r.request_id if r is not None and engine.active[i]
                    else None for i, r in enumerate(engine.slot_req)]
            state["decode"].append((out.float().cpu(), rids))
        return out

    run = Engine.run

    def recorded(engine):
        if engine.model is not model:
            return run(engine)
        engine.record_schedule = True
        n_sched = len(engine.sched_log)
        requests = list(engine.queue)
        state.update(engine=engine, prefill=[], decode=[])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(engine)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        first, leader = {}, {}
        for r in requests:
            key = id(r.group) if r.group is not None else -r.request_id
            leader[r.request_id] = first.setdefault(key, r.request_id)
        by_first = sorted((r for r in requests
                           if leader[r.request_id] == r.request_id),
                          key=lambda r: r.t_first)
        pool = engine.k_cache.data if hasattr(engine.k_cache, "data") \
            else engine.k_cache
        runs.append({
            "tokens": {r.request_id: list(r.output_ids) for r in requests},
            "prompts": {r.request_id: r.input_ids for r in requests},
            "sampling": {r.request_id: r.sampling for r in requests},
            "groups": leader,
            "prefill_order": [r.request_id for r in by_first],
            "prefill": state["prefill"], "decode": state["decode"],
            "secs": secs, "sched": "".join(engine.sched_log[n_sched:]),
            "pool_kv_heads": pool.shape[2]})
        return out
    model.prefill, model.prefill_chunk, model.decode = \
        prefill, prefill_chunk, decode
    Engine.run = recorded
    try:
        yield runs
    finally:
        Engine.run = run
        for n in calls:
            delattr(model, n)


def _tp_serve(engine, reqs, sp, every_step):
    """Serve `reqs` on `engine` under _tp_recording. → the run's record,
    with each request's name."""
    names = {}
    for name, req, n in reqs:
        rid = engine.add_request(sampling=sp, n=n, **req)
        names.update({r: name for r in (rid if isinstance(rid, list)
                                        else [rid])})
    with _tp_recording(engine.model, every_step) as runs:
        engine.run()
    return dict(runs[0], names=names)


def _tp_engine_settings():
    """Phase 7's engine settings (evisrag_predict.ENGINE_SETTINGS) with a
    1024-token prompt bucket: the prompts of TP_REQUESTS then pad to 1024
    tokens, not 4096, and gloo carries a quarter of the prefill's
    all-reduces."""
    from visrag_tpu_torch.driver.evisrag_predict import ENGINE_SETTINGS
    return dict(ENGINE_SETTINGS,
                prompt_buckets=(1024,) + ENGINE_SETTINGS["prompt_buckets"])


def _tp_sampling():
    from visrag_tpu_torch.driver.evisrag_predict import sampling_params
    tok = StandInTokenizer()
    return tok, sampling_params(tok, tok, 0.0, TP_NEW_TOKENS)


def _tp_margins(ref, rid):
    """The one-process run's top-2 margin at each token of request `rid`,
    on the logits its sampler saw (its logit bias, then its repetition
    penalty over the prompt and the tokens before): the first token from
    its prompt end's logits (a fork: its group leader's), the others from
    the decode steps that served it."""
    toks, sp = ref["tokens"][rid], ref["sampling"][rid]
    rows = [ref["prefill"][ref["prefill_order"].index(ref["groups"][rid])]]
    for logits, rids in ref["decode"]:
        if rid in rids and len(rows) < len(toks):
            rows.append(logits[rids.index(rid)])
    seen = set(int(t) for t in ref["prompts"][rid])
    out = []
    for j, row in enumerate(rows):
        row = row.clone()
        for t, b in sp.logit_bias:
            row[t] += b
        if sp.repetition_penalty != 1.0:
            idx = torch.tensor(sorted(seen))
            vals = row[idx]
            row[idx] = torch.where(vals > 0, vals / sp.repetition_penalty,
                                   vals * sp.repetition_penalty)
        top = torch.topk(row, 2).values
        out.append(float(top[0] - top[1]))
        seen.add(int(toks[j]))
    return out


def _tp_compare(tag, ref, got):
    """A tensor-parallel run (rank 0's record) against the one-process
    run of the same requests: every prompt end's logits and the first
    decode step's within RTOL_BLOCK (relative Frobenius); each request's
    tokens equal up to the first step whose top-2 margin in the
    one-process run is below twice the largest logit error of those
    steps. → (per-request agreement, errors)."""
    if len(got["prefill"]) != len(ref["prefill"]) or \
            got["prefill_order"] != ref["prefill_order"]:
        raise RuntimeError(f"{tag}: other prompt ends than one process's "
                           f"(schedule {got['sched']} against "
                           f"{ref['sched']})")
    errs, abs_err = [], 0.0
    for g, r in zip(got["prefill"], ref["prefill"]):
        errs.append(_rel(g, r))
        abs_err = max(abs_err, float((g - r).abs().max()))
    (g, g_rids), (r, r_rids) = got["decode"][0], ref["decode"][0]
    if g_rids != r_rids:
        raise RuntimeError(f"{tag}: first decode step serves {g_rids}, one "
                           f"process {r_rids}")
    live = [i for i, rid in enumerate(r_rids) if rid is not None]
    first = _rel(g[live], r[live])
    abs_err = max(abs_err, float((g[live] - r[live]).abs().max()))
    names = ref.get("names", {})
    agree = {}
    ok = max(errs) <= RTOL_BLOCK and first <= RTOL_BLOCK
    for rid, want in ref["tokens"].items():
        have = got["tokens"][rid]
        n = 0
        while n < min(len(have), len(want)) and have[n] == want[n]:
            n += 1
        tie = next((j for j, m in enumerate(_tp_margins(ref, rid))
                    if m < 2 * abs_err), len(want))
        held = n == len(want) == len(have) or n >= tie
        agree[f"{names.get(rid, 'request')}#{rid}"] = (n, len(want), tie,
                                                       held)
        ok = ok and held
    log(f"{tag} prompt ends' logits against one process, rel err "
        f"{[round(e, 5) for e in errs]}; first decode step {first:.5f} "
        f"(bound {RTOL_BLOCK}); max abs logit err {abs_err:.4g}; schedule "
        f"{got['sched']} (one process {ref['sched']}) | tokens (agreeing, "
        f"of, first step with a top-2 margin below {2 * abs_err:.4g}, held) "
        f"{agree}")
    if not ok:
        raise RuntimeError(f"{tag}: the tensor-parallel run disagrees with "
                           f"one process (prompt ends {errs}, first decode "
                           f"step {first}, tokens {agree})")
    return agree, {"prompt_end_rel": max(errs), "first_step_rel": first,
                   "max_abs": abs_err}


def _tp_live_lengths(rec, rids):
    """Each request's prompt plus its tokens: the lengths its K5 launches
    reach at its last decode step."""
    return [len(rec["prompts"][r]) + len(rec["tokens"][r]) for r in rids]


def _tp_serve_reference(reqs, qcfg):
    """Phase 7's one-process run at TP_NEW_TOKENS: the 7B of seed 0 through
    phase 7's engine (_tp_engine_settings), bf16 then int8 pools, every
    decode step recorded."""
    from visrag_tpu_torch.driver.common import build_qwen25_vl
    from visrag_tpu_torch.serving.engine import Engine
    tok, sp = _tp_sampling()
    model = build_qwen25_vl(qcfg, device=DEV, seed=0)
    out = {}
    for dtype in ("bfloat16", "int8"):
        engine = Engine(model, eos_token_ids=[tok.eos_token_id],
                        cache_dtype=dtype, **_tp_engine_settings())
        out[dtype] = _tp_serve(engine, reqs, sp, every_step=True)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _tp_serve_child(work, mesh):
    """A rank of 16h's serving job: the 7B of seed 0 (phase 7's init) cut
    into this rank's shard, then phase 7's engine settings over the model
    group, bf16 then int8 pools; each run's record and launch counts."""
    from visrag_tpu_torch.driver.common import build_qwen25_vl
    from visrag_tpu_torch.mesh import shard_module_tp
    from visrag_tpu_torch.models.qwen25_vl import Qwen25VLConfig
    from visrag_tpu_torch.ops import attention_kvgrid as kg
    from visrag_tpu_torch.ops import attention_lengths as al
    from visrag_tpu_torch.serving import paged_kv as pk
    from visrag_tpu_torch.serving.engine import Engine
    reqs = torch.load(f"{work}/reqs.pt", weights_only=False)
    tok, sp = _tp_sampling()
    t0 = time.perf_counter()
    model = build_qwen25_vl(Qwen25VLConfig.b7(), device=DEV, seed=0)
    shard = shard_module_tp(model, mesh)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    out = {"init_s": time.perf_counter() - t0}
    for dtype in ("bfloat16", "int8"):
        for mod in (al, kg, pk):
            mod.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        engine = Engine(shard, mesh=mesh, eos_token_ids=[tok.eos_token_id],
                        cache_dtype=dtype, **_tp_engine_settings())
        rec = _tp_serve(engine, reqs, sp, every_step=False)
        rec["launches"] = {"stacked": al.stacked_launches,
                           "flat": al.flat_launches, "kvgrid": kg.launches,
                           "paged": pk.launches,
                           "paged_int8": pk.int8_launches,
                           "paged_legacy": pk.legacy_launches}
        rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out[dtype] = rec
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _tp_rl_configs(out_dir, tp):
    """16h's RS-GRPO run: phase 9's configuration for TP_RL_STEPS steps at
    TP_RL_LAYERS text layers, the rollout greedy over `tp` model ranks,
    and 8192-token micro-batches (two ranks' updates share the one card).
    A greedy group's samples are equal, so its advantages are 0 and step
    1's gradient too; lr 1e-3 with weight decay 100 makes step 1's
    decoupled decay scale every weight by 0.9, so that step 2's rollout
    serves other weights than step 1's (through the refill, under a
    mesh)."""
    from visrag_tpu_torch.models.qwen25_vl import Qwen25VLConfig
    r = dataclasses.replace
    cfg = Qwen25VLConfig.b3()
    cfg = r(cfg, text=r(cfg.text, remat=True,
                        num_hidden_layers=TP_RL_LAYERS))
    rcfg = _rl_config(out_dir, TP_RL_STEPS)
    rcfg = r(rcfg, trainer=r(rcfg.trainer, save_freq=0),
             rollout=r(rcfg.rollout, tensor_parallel_size=tp,
                       temperature=0.0),
             actor=r(rcfg.actor, micro_batch_tokens=8192, lr=1e-3,
                     weight_decay=100.0))
    return cfg, rcfg


def _tp_rl_rows(work):
    """Phase 9's two text prompts, twice (a rollout batch of 4): 16h's
    hybrid rollout without the 3-page prompts, whose vision tower costs
    ~6 s a prompt over gloo (the serving run takes the tower at tp 2)."""
    with open(_rl_rows(work)) as f:
        rows = [r for r in map(json.loads, f) if not r.get("images")]
    path = f"{work}/rl_text_prompts.jsonl"
    with open(path, "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows * 2)
    return path


def _tp_rl_child(work, mesh):
    """A rank of 16h's RS-GRPO job on a (data 1, model 2) mesh: the
    rollout tensor-parallel over the model group, the update FSDP2 over
    data. → its steps' metrics, token ids and rewards, whole batches,
    rollout records (the first decode step's logits), launches."""
    from visrag_tpu_torch.mesh import MODEL, axis_index
    own = f"{work}/rl_rank{axis_index(mesh, MODEL)}"
    os.makedirs(own, exist_ok=True)
    cfg, rcfg = _tp_rl_configs(own, TP_WORLD)
    kept, rollouts = [], []
    hist, batches, launches, secs, peak = _rl_run(
        own, cfg, rcfg, mesh, keep=kept, rows_path=_tp_rl_rows(own),
        rollouts=rollouts)
    return {"history": hist, "batches": batches, "kept": kept,
            "rollouts": rollouts, "launches": launches, "secs": secs,
            "peak_gb": peak}


def _tp_child(rank, port, work):
    """One rank of 16h's job (`python3 chip_smoke.py --tp-child ...`): a
    gloo group of TP_WORLD processes on the one card whose collectives
    carry CUDA tensors, on a (data 1, model TP_WORLD) mesh: the serving
    runs, then (their memory back in the allocator's pool) the hybrid
    RS-GRPO run; the records go to work/serve_RANK.pt and
    work/rl_RANK.pt."""
    import datetime

    import torch.distributed as dist

    from visrag_tpu_torch.config import MeshConfig
    from visrag_tpu_torch.mesh import build_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=TP_WORLD,
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = build_mesh(MeshConfig(model=TP_WORLD, data=1),
                          device_type="cuda")
        torch.save(_tp_serve_child(work, mesh), f"{work}/serve_{rank}.pt")
        gc.collect()
        torch.cuda.empty_cache()
        torch.save(_tp_rl_child(work, mesh), f"{work}/rl_{rank}.pt")
    finally:
        dist.destroy_process_group()
    return 0


def _tp_spawn(work):
    """TP_WORLD processes of 16h's job (`--tp-child`), each on the one
    card; every one is waited for with a deadline and killed on any
    failure. → (the serving records, the hybrid run's records), each in
    rank order."""
    from visrag_tpu_torch.mesh import free_port
    port = free_port()
    logs = [open(f"{work}/tp_{r}.log", "w") for r in range(TP_WORLD)]
    # two processes' caching allocators share the card: segments that
    # grow in place leave less of it reserved and unused
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--tp-child",
         "--tp-rank", str(r), "--tp-port", str(port), "--tp-work", work],
        stdout=logs[r], stderr=subprocess.STDOUT, env=env,
        cwd=os.path.dirname(os.path.abspath(__file__)))
        for r in range(TP_WORLD)]
    deadline = time.monotonic() + TP_JOB_TIMEOUT
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(
                    p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    if any(p.returncode != 0 for p in procs):
        tails = []
        for r in range(TP_WORLD):
            with open(f"{work}/tp_{r}.log") as f:
                tails.append(f"rank {r} (rc {procs[r].returncode}):\n"
                             + "".join(f.readlines()[-30:]))
        raise RuntimeError("16h: a rank failed or hung\n" + "\n".join(tails))
    return tuple([torch.load(f"{work}/{job}_{r}.pt", weights_only=False)
                  for r in range(TP_WORLD)] for job in ("serve", "rl"))


def _tp_kernel_checks(gen, by, qcfg, served, rollout):
    """K5, K1 GQA and K3 at the per-rank shapes of tensor parallelism
    against their plain versions, timed beside the library call and the
    bound, at the shapes 16h's runs gave them: the 7B at tp 2 (K5 14/2 on
    bf16 and int8 pools at the served requests' lengths after their last
    token; K1 14/2 at the 1024-token bucket on page1_small's whole prefill
    and on the text pair's batched one; K3 at 8 of the tower's 16 heads on
    page1_small's window and image ids), the 3B hybrid rollout at tp 2
    (K5 8/1 at its first 8 slots' lengths after their last token), and
    kernel-only the tp 4 shapes of the same lengths (K5 7/1 and 4/1, K1
    7/1)."""
    from visrag_tpu_torch.models.qwen25_vl import Qwen25VLConfig
    tc, vc = qcfg.text, qcfg.vision
    h, kvh, d = tc.num_attention_heads, tc.num_key_value_heads, tc.head_dim
    h3 = Qwen25VLConfig.b3().text.num_attention_heads
    bucket = _tp_engine_settings()["prompt_buckets"][0]
    whole = [len(by["page1_small"]["input_ids"])]
    pair = [len(by[n]["input_ids"]) for n in ("text0", "text1")]
    live = _tp_live_lengths(served, sorted(served["tokens"]))
    slots = _tp_live_lengths(rollout, sorted(rollout["tokens"])[:8])

    def k5(label, lens, hq, bs, quantized=False):
        return _k5_check("[16h]", gen, label, lens, hq, max(kvh * hq // h,
                                                            1),
                         d, bs, quantized, True)

    def k1(label, lens, hq):
        return _gen_k1_check("[16h]", f"K1 GQA, {label}", gen, lens, bucket,
                             hq, max(kvh * hq // h, 1), d)
    return {
        "paged": k5("7B decode, a tp 2 rank", live, h // 2, 128),
        "paged_int8": k5("7B decode, a tp 2 rank", live, h // 2, 128, True),
        "gqa": k1("whole prefill, a tp 2 rank", whole, h // 2),
        "gqa_pair": k1("batched prefill, a tp 2 rank", pair, h // 2),
        "kvgrid": _k3_checks(gen, by["page1_small"]["vision_batch"],
                             vc.num_heads // 2, vc.head_dim),
        "paged_rl": _k5_check("[16h]", gen, "3B hybrid rollout, a tp 2 rank",
                              slots, h3 // 2, 1, d, 8, False, True),
        "tp4": [k5("7B decode, a tp 4 rank", live, h // 4, 128),
                _k5_check("[16h]", gen, "3B hybrid rollout, a tp 4 rank",
                          slots, h3 // 4, 1, d, 8, False, True),
                k1("whole prefill, a tp 4 rank", whole, h // 4)]}


def _dist_tp(work, gen):
    """16h: tensor parallelism as two processes on the one card over a
    gloo group whose collectives carry CUDA tensors (one NCCL rank a
    card): Qwen2.5-VL-7B served at tp 2 (Engine(mesh=), phase 7's
    requests, weights and engine settings, greedy, TP_NEW_TOKENS new
    tokens, bf16 then int8 pools) against the same run in one process;
    TP_RL_STEPS RS-GRPO steps at Qwen2.5-VL-3B's width with TP_RL_LAYERS
    text layers on a (data 1, model 2) mesh, each step's greedy rollout
    (step 2's on the shards refilled from FSDP2) against one process's
    greedy rollout of the same weights, and the steps' losses against one
    process's update of the hybrid's batches; then the per-rank kernels
    against their plain versions at the runs' shapes. → the runs'
    launches and the kernel checks."""
    from visrag_tpu_torch.models.qwen25_vl import Qwen25VLConfig
    t_phase = time.perf_counter()
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    if mode != "Default":
        raise RuntimeError(f"16h needs two processes on the card; compute "
                           f"mode {mode!r}")
    qcfg = Qwen25VLConfig.b7()
    reqs = [r for r in _serving_requests(StandInTokenizer(), qcfg)
            if r[0] in TP_REQUESTS]
    torch.save(reqs, f"{work}/reqs.pt")
    t0 = time.perf_counter()
    ref = _tp_serve_reference(reqs, qcfg)
    ref_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    serve, rl = _tp_spawn(work)
    tp_s = time.perf_counter() - t0
    agree = {}
    for dtype in ("bfloat16", "int8"):
        got = serve[0][dtype]
        agree[dtype] = _tp_compare(f"[16h] {dtype} pools:", ref[dtype], got)
        n_layers = qcfg.text.num_hidden_layers
        log(f"[16h] 7B at tp 2, {dtype} pools: {got['secs']:.2f} s serving "
            f"(one process {ref[dtype]['secs']:.2f} s), pools of "
            f"{got['pool_kv_heads']} kv heads a rank, launches a rank "
            f"{got['launches']} ({n_layers} K1 / K5 a prefill / decode "
            f"step, {qcfg.vision.depth} K3 a tower run), peak a rank "
            f"{got['peak_gb']:.2f} GB | {smi()}")
    bf16, int8 = serve[0]["bfloat16"]["launches"], \
        serve[0]["int8"]["launches"]
    if not (bf16["paged"] > 0 and int8["paged_int8"] > 0
            and bf16["stacked"] > 0 and bf16["kvgrid"] > 0
            and bf16["paged_legacy"] == int8["paged_legacy"] == 0
            and bf16["paged_int8"] == int8["paged"] == 0):
        raise RuntimeError(f"16h launches: bf16 {bf16}, int8 {int8}")
    del ref
    gc.collect()
    torch.cuda.empty_cache()

    got = rl[0]
    cfg, rcfg = _tp_rl_configs(f"{work}/rl_one", 1)
    own, rollouts = [], []
    t0 = time.perf_counter()
    one = _rl_run(work, cfg, rcfg, keep=own, replay=got["kept"],
                  rows_path=_tp_rl_rows(work), rollouts=rollouts,
                  every_step=True)[0]
    one_s = time.perf_counter() - t0
    if not len(rollouts) == len(got["rollouts"]) == len(one) \
            == len(got["history"]) == TP_RL_STEPS:
        raise RuntimeError(f"16h RS-GRPO: {len(got['rollouts'])} rollouts "
                           f"and {len(got['history'])} steps at tp 2, "
                           f"{len(rollouts)} and {len(one)} in one process")
    rl_agree = [_tp_compare(f"[16h] RS-GRPO step {i} greedy rollout at "
                            f"(data 1, model 2):", want, have)
                for i, (want, have) in enumerate(
                    zip(rollouts, got["rollouts"]), 1)]
    rewards = [a["reward_tensor"].shape == b["reward_tensor"].shape
               and bool((a["reward_tensor"] == b["reward_tensor"]).all())
               for a, b in zip(own, got["kept"])]
    # what step 1's update moved: the same prompt's step-2 prompt-end
    # logits against its step-1 ones, in one process
    step1 = {tuple(rollouts[0]["prompts"][r]): rollouts[0]["prefill"][i]
             for i, r in enumerate(rollouts[0]["prefill_order"])}
    moved = [_rel(rollouts[1]["prefill"][i], step1[key])
             for i, r in enumerate(rollouts[1]["prefill_order"])
             if (key := tuple(rollouts[1]["prompts"][r])) in step1]
    keys = ("loss", "grad_norm")
    rel = [{k: abs(h[k] - o[k]) / max(abs(o[k]), 1e-30) for k in keys}
           for h, o in zip(got["history"], one)]
    log(f"[16h] RS-GRPO, Qwen2.5-VL-3B width at {TP_RL_LAYERS} of 36 text "
        f"layers, {TP_RL_STEPS} steps on (data 1, model 2), the greedy "
        f"rollout over the model group (phase 9's text prompts): rewards "
        f"equal to one process's own rollout's {rewards}; step 2's prompt "
        f"ends moved from step 1's by rel {[round(m, 4) for m in moved]} "
        f"(step 1's decay, carried to the shards by the refill); {keys} "
        f"{[[h[k] for k in keys] for h in got['history']]} against one "
        f"process's update of the same batches "
        f"{[[o[k] for k in keys] for o in one]} (rel err {rel}, bound "
        f"{RTOL_TRAIN}; one process {one_s:.1f} s); {got['secs']:.1f} s a "
        f"rank with init, peak a rank {got['peak_gb']:.2f} GB; launches a "
        f"rank {got['launches']}")
    if max(v for r in rel for v in r.values()) > RTOL_TRAIN \
            or got["launches"]["paged"] == 0:
        raise RuntimeError(f"16h RS-GRPO at (data 1, model 2): {keys} rel "
                           f"err {rel}, launches {got['launches']}")
    by = {name: req for name, req, _ in reqs}
    checks = _tp_kernel_checks(gen, by, qcfg, serve[0]["bfloat16"],
                               got["rollouts"][0])
    log(f"[16h] in {time.perf_counter() - t_phase:.1f} s (one-process "
        f"serving {ref_s:.1f} s, the two ranks' serving and hybrid runs "
        f"{tp_s:.1f} s, the 7B's init and cut {serve[0]['init_s']:.1f} s)")
    return {"serve": {"bfloat16": bf16, "int8": int8},
            "rl": got["launches"], "checks": checks, "agree": agree,
            "rl_agree": rl_agree, "vision_depth": qcfg.vision.depth,
            "full_layers": len(qcfg.vision.fullatt_block_indexes)}


def tp_kernel_rows(tp):
    """16h's rows: K5 at 14/2 on bf16 and int8 pools, K1 GQA at 14/2 and
    K3 at 8 heads (window and full layers) with launches from the tp 2
    serving run's rank 0, K5 at 8/1 with launches from the hybrid
    rollout's rank 0; the tp 4 shapes' checks under the K5 and K1 rows."""
    from visrag_tpu_torch.ops import attention_kvgrid as kg
    from visrag_tpu_torch.ops import attention_lengths as al
    from visrag_tpu_torch.serving import paged_kv as pk
    c, serve = tp["checks"], tp["serve"]
    runs = serve["bfloat16"]["kvgrid"] + serve["int8"]["kvgrid"]
    runs //= tp["vision_depth"]
    n_full = tp["full_layers"]
    rows = []
    for name, source, replaces, launches, rec, extra in (
            ("paged_decode_attention (a tp 2 rank, 14/2)", pk.SOURCE,
             REPLACES["paged"], serve["bfloat16"]["paged"], c["paged"],
             c["tp4"][:2]),
            ("paged_decode_attention (int8 pools, a tp 2 rank, 14/2)",
             pk.SOURCE, REPLACES["paged"] + " (quantized=True)",
             serve["int8"]["paged_int8"], c["paged_int8"], []),
            ("flash_fwd_lengths (GQA, a tp 2 rank, 14/2, d=128)", al.SOURCE,
             REPLACES["fwd"], serve["bfloat16"]["stacked"]
             + serve["int8"]["stacked"], c["gqa"],
             [c["gqa_pair"]] + c["tp4"][2:]),
            ("flash_attention_kvgrid (window layers, a tp 2 rank, 8 heads)",
             kg.SOURCE, REPLACES["kvgrid"],
             runs * (tp["vision_depth"] - n_full), c["kvgrid"][0],
             c["kvgrid"][2:]),
            ("flash_attention_kvgrid (full layers, a tp 2 rank, 8 heads)",
             kg.SOURCE, REPLACES["kvgrid"], runs * n_full, c["kvgrid"][1],
             []),
            ("paged_decode_attention (the hybrid rollout, a tp 2 rank, 8/1)",
             pk.SOURCE, REPLACES["paged"], tp["rl"]["paged"], c["paged_rl"],
             [])):
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches,
                     **{k: rec.get(k) for k in KEYS},
                     "checks": [rec] + extra})
    return rows


def phase16_distributed(gen, scan_ids=None, phase5_losses=None,
                        phase10_history=None, rl_ref=None, gae_ref=None):
    """The multi-GPU layer on one card: every distributed entry point over
    a one-rank NCCL group at full width (eval_retriever and
    train_retriever under --coordinator, make_sharded_topk, SFT on a
    mesh, LoRA retriever training, RS-GRPO and GAE across ranks) and K4
    at Ulysses' per-rank shapes of the SFT batch and of the RL packed
    update. → {"launches", "ulysses", "scan_ms"}."""
    from visrag_tpu_torch import mesh as vmesh
    from visrag_tpu_torch.config import MeshConfig
    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="visrag_dist_")
    ulysses, ulysses_launches = {}, {}
    try:
        eval_launches = _dist_eval(work)
        with vmesh.distributed(f"localhost:{vmesh.free_port()}", 0, 1, DEV):
            mesh = vmesh.build_mesh(MeshConfig())
            k6, scan_ms = _dist_scan(mesh, scan_ids)
            t0 = time.perf_counter()
            for tag, ids in (("SFT batch", _sft_batch_ids()),
                             ("RL packed update", _rl_packed_ids(work))):
                ulysses_launches[tag], ulysses[tag] = _dist_ulysses(
                    mesh, gen, ids, tag)
            log(f"[16g] K4 at the Ulysses shapes in "
                f"{time.perf_counter() - t0:.1f} s")
        train_launches = _dist_train(work, phase5_losses)
        sft_launches = _dist_sft(work, phase10_history)
        t0 = time.perf_counter()
        lora_launches = _dist_lora(work)
        log(f"[16e] in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        rl_launches = _dist_rl(work, rl_ref, gae_ref)
        log(f"[16f] in {time.perf_counter() - t0:.1f} s")
        tp = _dist_tp(work, gen)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"[16] phase 16 in {time.perf_counter() - t_phase:.1f} s")
    return {"launches": {"eval": eval_launches, "train": train_launches,
                         "sft": sft_launches, "scan_int8_gemm": k6,
                         "ulysses": ulysses_launches, "lora": lora_launches,
                         **rl_launches},
            "ulysses": ulysses, "scan_ms": scan_ms, "tp": tp}


def dist_kernel_rows(dist_results):
    """K4's rows at the Ulysses per-rank shapes of the SFT batch and of
    the RL packed update (launches from phase 16's ulysses_attention runs,
    numbers from its checks), then 16h's (tp_kernel_rows)."""
    from visrag_tpu_torch.ops import attention as seg
    rows = []
    for tag, suffix in (("SFT batch", ""), ("RL packed update",
                                            ", RL packed update")):
        for n, h, hk in ULYSSES_SHAPES:
            rec = dist_results["ulysses"][tag][n]
            for kind, name in (("seg_fwd", "segment_fwd"),
                               ("seg_dq", "segment_bwd_dq"),
                               ("seg_dkv", "segment_bwd_dkv")):
                rows.append({"name": f"{name} (Ulysses {n}-way per rank, "
                                     f"{h}/{hk} heads{suffix})",
                             "route": "cuda", "source": seg.HOPPER_SOURCE,
                             "replaces": SEG_REPLACES[kind],
                             "launches": dist_results["launches"][
                                 "ulysses"][tag][n][kind],
                             **{k: rec[kind][k] for k in KEYS},
                             "pr4_ms": rec[kind].get("pr4_ms"),
                             "checks": [rec[kind]]})
    return rows + tp_kernel_rows(dist_results["tp"])


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--rl-only", action="store_true",
                    help="phases 0, 1, 1b and 8-11 only, for work on the "
                         "training slices; the run then ends without the "
                         "ok line")
    ap.add_argument("--gen-only", action="store_true",
                    help="phases 0, 1, 1b and 12-14 only, for work on "
                         "VisRAG-Gen; the run then ends without the ok line")
    ap.add_argument("--ret-only", action="store_true",
                    help="phases 0, 1, 1b and 15 only, for work on the "
                         "SigLIP baseline and the int8 scan; the run then "
                         "ends without the ok line")
    ap.add_argument("--dist-only", action="store_true",
                    help="phases 0, 1, 1b and 16 only, for work on the "
                         "multi-GPU layer; the run then ends without the "
                         "ok line")
    # one rank of phase 16h's job, started by phase 16h itself
    ap.add_argument("--tp-child", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--tp-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--tp-port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--tp-work", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.tp_child:
        return _tp_child(args.tp_rank, args.tp_port,
                         args.tp_work)
    # full fp32 wherever fp32 is asked for (pos embed, the fp32 references)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase0_environment()
    phase1_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    norm_results = phase1b_norm_kernel(gen)
    if args.rl_only:
        seg_results, rl_launches, sft_launches, _ = rl_phases(gen)
        print(smi())
        print(json.dumps({"kernels": segment_kernel_rows(
            seg_results, rl_launches) + [k8_row(
                "chunk_attention (K8, 3B rollout 16/2, d=128)",
                rl_launches["chunk"], rl_launches["chunk_checks"])]
            + norm_kernel_rows(norm_results, sft_launches, None)}))
        print(json.dumps({"ok": False, "partial": "--rl-only"}))
        return 1
    if args.gen_only:
        rows = gen_kernel_rows(gen_phases(gen))
        print(smi())
        print(json.dumps({"kernels": rows}))
        print(json.dumps({"ok": False, "partial": "--gen-only"}))
        return 1
    if args.ret_only:
        rows = ret_kernel_rows(phase15_retrieval(gen))
        print(smi())
        print(json.dumps({"kernels": rows}))
        print(json.dumps({"ok": False, "partial": "--ret-only"}))
        return 1
    if args.dist_only:
        rows = dist_kernel_rows(phase16_distributed(gen))
        print(smi())
        print(json.dumps({"kernels": rows}))
        print(json.dumps({"ok": False, "partial": "--dist-only"}))
        return 1
    setup = phase3_setup()
    results = phase2_kernel(gen, setup)
    serve_launches = phase3_slice(setup)
    int8_checks, int8_launches = phase3b_int8_encode(gen, setup)
    train_results = phase4_training_kernels(gen, setup)
    train_launches = phase5_training(setup)
    del setup                       # the retriever: its memory goes to 7B
    gc.collect()
    torch.cuda.empty_cache()
    from visrag_tpu_torch.models.qwen25_vl import Qwen25VLConfig
    qcfg = Qwen25VLConfig.b7()
    t0 = time.perf_counter()
    reqs = _serving_requests(StandInTokenizer(), qcfg)
    log(f"[6] six serving requests assembled by the driver in "
        f"{time.perf_counter() - t0:.2f} s (prompt tokens "
        f"{[len(r['input_ids']) for _, r, _ in reqs]})")
    qwen_results = phase6_serving_kernels(gen, reqs, qcfg)
    qwen_launches, qmodel, dec_ref = phase7_serving(reqs, qcfg)
    k5q_checks, k5q_launches = phase7b_int8_serving(gen, reqs, qcfg, qmodel,
                                                    dec_ref)
    del reqs, qmodel, dec_ref
    gc.collect()
    torch.cuda.empty_cache()
    seg_results, rl_launches, sft_launches, gae_launches = rl_phases(gen)
    gc.collect()
    torch.cuda.empty_cache()
    gen_results = gen_phases(gen)
    gc.collect()
    torch.cuda.empty_cache()
    ret_results = phase15_retrieval(gen)
    gc.collect()
    torch.cuda.empty_cache()
    dist_results = phase16_distributed(gen, ret_results["scan_ids"],
                                       train_launches["losses"],
                                       sft_launches["history"],
                                       rl_launches["reference"],
                                       gae_launches["reference"])
    log(f"[K2] Hopper launches by kernel and head dim (route counters): "
        f"phase 5 {train_launches['k2_by_head_dim']}, phase 9 (padded "
        f"update) {rl_launches['padded_update']['k2_by_head_dim']}, phase 10 "
        f"{sft_launches['k2_by_head_dim']}, phase 11 "
        f"{gae_launches['k2_by_head_dim']}")
    from visrag_tpu_torch.ops import attention_kvgrid as kg
    from visrag_tpu_torch.ops import attention_lengths as al
    from visrag_tpu_torch.ops import matmul_int8 as mi
    from visrag_tpu_torch.serving import paged_kv as pk
    keys = KEYS
    kernels = []
    for form, name in (("flat", "flash_fwd_lengths_flat"),
                       ("stacked", "flash_fwd_lengths")):
        page = results[form][0]
        kernels.append({"name": name, "route": "cuda", "source": al.SOURCE,
                        "replaces": REPLACES["fwd"],
                        "launches": serve_launches[form],
                        **{k: page[k] for k in keys},
                        "pr1_ms": page["pr1_ms"],
                        "sdpa_ms": page["library_ms"],
                        "checks": results[form]})
    # K2 by form: the ViT's flat d 72 (the micro-batch's pages) and the
    # LM's stacked causal d 64 (its token batch), launches from phase 5's
    # route counters by head dim
    k2_by_d = train_launches["k2_by_head_dim"]
    lm_at = next(i for i, r in enumerate(train_results["dq"])
                 if r["shape"].startswith("LM causal, training pages"))
    for kind, name, source, replaces, at in (
            ("fwd_lse", "flash_fwd_lse", al.SOURCE, REPLACES["fwd"], 0),
            ("dq", "flash_bwd_dq", al.BWD_SOURCE, REPLACES["dq"], 0),
            ("dkv", "flash_bwd_dkv", al.BWD_SOURCE, REPLACES["dkv"], 0),
            ("dq", "flash_bwd_dq (LM causal, d=64)", al.BWD_SOURCE,
             REPLACES["dq"], lm_at),
            ("dkv", "flash_bwd_dkv (LM causal, d=64)", al.BWD_SOURCE,
             REPLACES["dkv"], lm_at)):
        page = train_results[kind][at]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": train_launches[kind] if kind == "fwd_lse"
                        else k2_by_d[kind][page["head_dim"]],
                        **{k: page[k] for k in keys},
                        **({"pr1_ms": page["pr1_ms"]}
                           if kind == "fwd_lse" else
                           {"pr5_ms": page["pr5_ms"]}),
                        "sdpa_ms": page["library_ms"],
                        "checks": train_results[kind] if at == 0 else []})
    for kind, name, source, replaces, count in (
            ("gqa", "flash_fwd_lengths (GQA 28/4, d=128)", al.SOURCE,
             REPLACES["fwd"], "stacked"),
            ("paged", "paged_decode_attention", pk.SOURCE,
             REPLACES["paged"], "paged")):
        first = qwen_results[kind][0]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": qwen_launches[count],
                        **{k: first[k] for k in keys},
                        **({"pr1_ms": first["pr1_ms"]}
                           if kind == "gqa" else {}),
                        **({"legacy_ms": first["legacy_ms"],
                            "legacy_source": pk.LEGACY_SOURCE}
                           if kind == "paged" else {}),
                        "checks": qwen_results[kind]})
    # K3 by layer kind: phase 7's launches (asserted: depth per vision-tower
    # run) split as the tower's layers are, numbers at the first 3-page
    # request's window and image ids
    vc = qcfg.vision
    n_full = len(vc.fullatt_block_indexes)
    runs = qwen_launches["kvgrid"] // vc.depth
    for at, name, layers in ((0, "flash_attention_kvgrid (window layers)",
                              vc.depth - n_full),
                             (1, "flash_attention_kvgrid (full layers)",
                              n_full)):
        first = qwen_results["kvgrid"][at]
        kernels.append({"name": name, "route": "cuda", "source": kg.SOURCE,
                        "replaces": REPLACES["kvgrid"],
                        "launches": layers * runs,
                        **{k: first[k] for k in keys},
                        "pr3_ms": first["pr3_ms"],
                        "legacy_source": kg.LEGACY_SOURCE,
                        "checks": qwen_results["kvgrid"] if at == 0 else []})
    # K8 at the 7B's 2048-token chunks, launches from phase 7's chunks
    # (asserted: one a layer a chunk); numbers at L 6144, the last chunk of
    # the answer cell's longest prompts
    kernels.append(k8_row("chunk_attention (K8, 28/4, d=128)",
                          qwen_launches["chunk"], qwen_results["chunk"]))
    kernels.append({"name": "int8_matmul_fused", "route": "cuda",
                    "source": mi.SOURCE, "replaces": INT8_REPLACES,
                    "launches": int8_launches["int8_gemm"],
                    **{k: int8_checks[0][k] for k in keys},
                    "pr5_ms": int8_checks[0]["pr5_ms"],
                    "int_mm_ms": int8_checks[0]["int_mm_ms"],
                    "checks": int8_checks})
    kernels.append({"name": "paged_decode_attention (int8 pools)",
                    "route": "cuda", "source": pk.SOURCE,
                    "replaces": REPLACES["paged"] + " (quantized=True)",
                    "launches": k5q_launches["paged_int8"],
                    **{k: k5q_checks[0][k] for k in keys},
                    "legacy_ms": k5q_checks[0]["legacy_ms"],
                    "legacy_source": pk.LEGACY_SOURCE,
                    "checks": k5q_checks})
    kernels += segment_kernel_rows(seg_results, rl_launches)
    kernels.append(k8_row("chunk_attention (K8, 3B rollout 16/2, d=128)",
                          rl_launches["chunk"], rl_launches["chunk_checks"]))
    for phase in ("12", "13"):      # K7 at the generation runs' shapes
        k7 = gen_results[phase][1]["k7"]
        norm_results["rmsnorm"] += k7["rms"]
        norm_results["layernorm"] += k7["ln"]
    kernels += norm_kernel_rows(norm_results, sft_launches, serve_launches)
    kernels += gen_kernel_rows(gen_results)
    kernels += ret_kernel_rows(ret_results)
    kernels += dist_kernel_rows(dist_results)
    for k in kernels:
        if not k["launches"] > 0:
            raise RuntimeError(f"{k['name']} was not launched on its path")
    print(smi())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    sys.stdout.flush()


if __name__ == "__main__":
    sys.exit(main())
