#!/usr/bin/env python3
"""Drive the PyTorch port (skypilot_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card

Phases (each one that fails makes the script exit non-zero):

1. The device: CUDA must be present; prints the card's name and power
   limit as `nvidia-smi --query-gpu=name,power.limit` gives them.
2. Builds every CUDA kernel of the port from csrc/ (one nvcc per
   source, in parallel) and prints the build seconds; then, for every
   kernel instantiation (flash and paged), ptxas's registers, stack
   and spills and the HGMMA / HMMA / FFMA counts of `cuobjdump -sass`
   (a wgmma kernel without HGMMA, or a wgmma or paged kernel with
   spills, fails the run).
3. Kernel parity on the card at the Llama-3-8B shapes (h_q 32, h_kv 8,
   d 128, bf16, page size 16): B1 paged decode and B2 int8 paged decode
   (one split-context kernel: splits of `split_pages` pages merged in
   order) with
   ragged lengths (1, 15, 16, 17, 1000), S = 1 and S = 5, tables that
   include the null page, a full batch of 8 slots at 1000, and S = 1 at
   the slice path's last tick (phase 5d: 4 slots at 3030, 7930, 130
   and 0 over 512-row tables) (two launches bit-equal); B3 flash forward at q_len 1, 100, 512
   and q_len < k_len, at the training shape (b 2 x 2048) and at
   `small`'s (16/8, d 64, b 8 x 512); one f32 case each.  B4 (dQ) and
   B5 (dK/dV) flash
   backward with a random output cotangent and a non-zero LSE
   cotangent: the training shape (b 2, 2048), ragged 100 and 1000,
   q 100 < k 612, Qwen2's group (28/4, rep 7), Gemma's (8/1, d 256),
   d 64 (`small`), one f32 and one non-causal case; two launches must
   give the same bits.  Each kernel is held against its plain PyTorch
   version on the same inputs: bf16 outputs within atol/rtol 2e-2
   (compared as f32; both accumulate in f32, in different orders), f32
   within 1e-4, the LSE within 1e-3; backward gradients within the same
   2e-2 / 1e-4 of the plain version's largest |value|.  A kernel's
   `ms` and the `library_ms` of its PyTorch yardstick are device time:
   the summed durations of the kernels 20 calls launch, after 3
   warm-up calls, in a torch.profiler trace, over 20 (`timed_by`
   "profiler"); where a trace holds fewer kernels than 20 times one
   profiled call's (none, on some windows), CUDA event pairs
   around calls queued behind a spin kernel (`queued_event_ms`, which
   also counts the gaps between a call's kernels; `timed_by`
   "queued_events"; "events_with_host" where the queueing outlasts the
   spin; `library_timed_by` for the yardstick); `ms_with_host`
   (CUDA events around the same 20 calls) keeps the host's launch work,
   and the plain version is timed that way.  B3 is timed at the
   training shape and the 512-token chunk; B1 and B2 at the slice
   tick (S = 1), at the serving phases' tick on the ragged lengths (B1
   S = 1, B2 S = 5) and at the full batch.  B3 is also held and
   timed at the ring hop of phase 5d (b 1, 32/8, d 128, 2048 x 2048,
   bf16), causal and non-causal, beside SDPA's forward for the same
   setting.  At the shapes sharded training gives them (phase 7c): B4
   and B5 at mesh A's ring hop (b 1, 32/8, 2048 x 2048), non-causal
   and causal, with an lse cotangent, B3-B5 at mesh B's Ulysses
   call (b 1, 16/4, 4096, causal) and at the tensor mesh's ring hop
   (a tensor rank's 16/4 heads, 2048 x 2048, causal and non-causal),
   each against its plain version and two launches bit-equal, timed
   beside SDPA (forward; backward as dq + dkv).  At a tensor rank's heads (llama3-8b at tensor 2 and 4:
   16/4 and 8/2): B1 (bf16, S = 1) and B2 (int8, S = 5) on the ragged
   lengths and B3 at the 512-token chunk, held and timed the same way
   (`check_tensor_ranks`).  Bounds from this run's
   bytes and FLOPs against 3.35 TB/s and 989 TFLOP/s (H100 SXM data
   sheet), labelled by whichever of the two is larger.  B4/B5 are timed at the training
   shape; their plain version computes dQ, dK and dV together, and so
   does their yardstick, SDPA's backward (the device time of fwd + bwd
   minus fwd's).
4. The serving path: ModelServer('llama3-8b') with seeded random
   weights at full width, its 32 layers cut to SERVE_LAYERS (8: every
   serving phase below runs these weights, and a serving window's time
   is mostly its ticks' host work, which grows with depth), paged
   continuous batching,
   answering concurrent POST /generate requests over HTTP (greedy, one
   seeded sampled request, then prefix-cache hits).  Its pool journals
   its pages (SKYTPU_SERVE_PAGE_EVENTS set while it is made, under the
   run's own SKYTPU_HOME): once every slot is released, the
   `kv_pages_alloc` / `kv_pages_free` records of serve.jsonl, replayed
   as the reference's `page_pool_balance` defines it, free no page that
   is not held and leave held exactly the prefix cache's pages.  Then an int8-KV
   engine with speculative decoding (k = 4) on the same weights, whose
   greedy tokens must equal the same int8 engine's with speculation
   off.  Launch counts are zeroed just before and read just after:
   every serving kernel must have run on it.
   Then, on the same server before it closes, the observability plane
   in two windows, each with its own launch counts, zeroed just before
   its requests and read just after its route reads: "observability"
   on phase 4's bf16 pool (B1, B3), then "observability (int8 pool)" on
   a second server with an int8 pool over the same weights (B2, B3).
   Each window: 6 concurrent /generate requests with client-chosen
   X-SkyTPU-Request-Ids (each echoed).
   /metrics parses, and once the engine is idle its ticks and decode
   tokens grew by what engine.stats() counted, the TTFT histogram by 6;
   /spans holds one engine segment per id (status ok, TTFT within the
   duration, queue -> prefill -> decode in order without overlap,
   tokens as returned); /profile a non-empty ring of the reference's
   phases, each tick's phases within its duration, memory within the
   allocator's peak; /logs one access record per id.  After the
   windows, in this thread on identical inputs (clones of one cache
   and state), the sentinel-wrapped step and prefill between
   begin_tick / lap / end_tick launch the bare entries' kernels
   (`serve/plane_check.py`: per-call kernel-name multisets from
   torch.profiler and B1/B2/B3 counts equal).  Then an
   engine with SKYTPU_PROFILE_DISABLE=1 on the same weights gives the
   same greedy tokens as the server's engine on two prompt sets new to
   both (off, on, on, off).  The host ms a tick of each, the tick
   profile and the plane's modeled cost are printed, never held: which
   ticks admit or prefill is up to the worker thread's timing.
5. More serving paths on the same 8B weights, each with its own launch
   counts, zeroed just before it and read just after:
   - "replica front": a paged server behind the asyncio front
     (`async_server.start_background`): greedy /generate, 5 concurrent
     /generate_stream, a batch-class request (the class's
     max_new_tokens set to 8 through SKYTPU_QOS_SPEC), POST
     /role_budget decode then a 24-token prompt (prefill pieces of one
     token: B3's chunk 0 at the 16 bucket, then 22 width-1 masked
     continuations) then mixed, POST /drain with a stream in flight
     (/generate must answer 503 + Retry-After while the stream ends
     with all its tokens), and a stream whose client hangs up after
     two events (its span must read 'cancelled', the busy slots and the
     pages held beyond the prefix cache's must come back to their
     baseline within 120 s).  B1 and B3 must run, B2 must not.  After
     the read, the threaded front of a second server on the same
     weights serves the same prompts (new to both, so no prefix hit
     changes what runs), unclamped: /generate, the streams and the
     drained stream must give equal tokens, the batch request the first
     8 of its prompt's; the decode-budget prompt equal tokens or, where
     they part, every token held at its own context as below (its
     pieces ran the masked path, the reference's prefill the flash
     kernel).  TTFT, tokens/s and ms are printed, never held.
   - "spec beyond one bucket": the int8 + spec engine at 16 slots,
     k = 4 (an 80-row verify tick, two 64-row blocks), counted alone;
     greedy tokens must equal those of spec-off, run after the read.  Then one verify tick timed in its blocks
     and as one 128-row call (what the blocks cost).
   - "dense serving": ModelServer in the reference's default mode
     (continuous batching, no --kv-pages: the dense slot cache) over
     HTTP: 6 concurrent /generate requests (tokens/s), TTFT of a
     100-token prompt, /generate_stream (equal to /generate) and
     /generate_text (streamed text equal to the whole).  B3 must run,
     B1 and B2 must not.
   - "legacy": the un-pipelined loop (pipelined=False) on the same
     prompts.
   - "handoff": a prefill engine (paged bf16) exports a 100-token
     prompt through the binary frame (B3 must run there, and no paged
     kernel); a decode engine (paged bf16, then an int8 pool) imports
     it and generates (B1, then B2, must run there).
   Each window holds the engine work only: the reference paths and the
   checks run after its counts are read.  Then, outside the windows:
   each decode engine serves the prompt again while a single engine of
   its pool type serves it at the same time, each engine on its own
   CUDA stream (the two streams' paged launches overlap): the decode
   engine's tokens must equal its own from the window, and every
   ticket counter must read 0 after.  Every generated token is held
   at its own context (teacher forcing): under the logits of one flash
   forward of prompt + tokens, each token is the argmax at its
   position or within twice the largest logit difference between that
   forward and the masked einsum path on the same tokens (for an int8
   pool, that path's k/v go through the pool's quantizer).  The
   reference path's tokens (dense: decode.generate; legacy: the dense
   pipelined engine; handoff: the single engine) say where the two
   part.
5b. Real weights (models/quantize.py, models/import_weights.py,
   data/checkpoints.py), each path with its own launch counts:
   - quantize_params over a depth-1 full-width llama3-8b f32 tree on
     the card equals the same call on the CPU, byte for byte.
   - "int8 weights": ModelServer('llama3-8b', quantize='int8') at full
     width and SERVE_LAYERS deep (seeded init quantized on the card leaf by leaf,
     paged, 1024 pages) answers 6 concurrent greedy /generate requests;
     its weights' GiB are printed beside the bf16 model's.  After the
     read, a server on the bf16 model whose kernels are the dequantized
     values (`convert.dequantize_model`, computed once) answers the same
     requests: the tokens must be equal (both GEMMs see the same bf16
     operands).  Then the int8 and the bf16 paged ticks are timed with
     profile_decode's method (printed, not held).  B1 and B3 must run,
     B2 must not.
   - "checkpoint": a seeded depth-2 llama3-8b-width model whose values
     are all bf16 values is written as an HF source (HF names, [out, in],
     rotate-half q/k rows, BF16, config.json, a tiny SentencePiece
     tokenizer.model) with the port's safetensors writer;
     `import_weights.convert` makes step 0, whose restore must equal the
     writer bit for bit; ModelServer('auto', checkpoint_dir=...) answers
     /generate and /generate_text, a second seed is saved as step 1 and
     POST /weights_swap must answer weight_version 1.  After the read,
     in-memory servers on the same weights must give the same tokens
     (and /generate_text the tokenizer's decode of them).  The
     temporary directories are deleted as soon as they are not needed;
     the disk use, convert and restore seconds are printed.
5c. MoE: mixtral-8x7b at full width (d_model 4096, 32/8 heads,
   head_dim 128, d_ff 14336, 8 experts, top-2, vocab 32000), its 32
   layers cut to 8 (2.90 GB a layer in bf16: 32 would not fit the
   card's 80 GB), seeded bf16 weights, after the 8B models are freed.
   Three windows, each with its own launch counts, zeroed just before
   its requests and read just after: "moe paged" (ModelServer
   ('mixtral-8x7b'), paged, 1024 pages of 16, max_len 1024, 8 slots),
   "moe int8 pool" (the same with int8 KV) and "moe dense" (the dense
   slot cache).  Each answers 6 concurrent greedy /generate requests of
   5-700 tokens and one seeded sampled request, 32 new tokens each,
   then the 100-token prompt again (the same tokens, and no prefix
   entry: MoE prefill couples every prompt token, so pages never
   share).  Each prompt prefills whole, so B3 must run exactly once per
   prompt and layer; B1 only on the bf16 pool, B2 only on the int8
   pool, neither in dense mode.  After the windows every greedy token
   is held at its own context as in phase 5, the forward computing the
   MoE blocks as the engine does (the capacity dispatch over the
   prompt's rows, the dense gather over each generated row); the
   (token, expert) assignments the prefill dispatch dropped are
   printed per prompt.  Printed, not held: the paged MoE tick at 8
   slots (`profile_decode.profile_tick`: host ms, device ms, kernels)
   and the f32 expert casts' ms a tick, by CUDA events (the
   reference's decode ticks compute every expert in f32).  "moe checkpoint": a depth-1
   Mixtral-width HF source (the port's writer, BF16) ->
   `import_weights.convert` -> ModelServer('auto') answers /generate
   (B1, B3), the directories deleted once read; after the read an
   in-memory server on the writer's weights must give the same tokens.
   Then a depth-1 f32 cut served on the GPU (kernels) and the CPU
   (plain versions) from the same weights must give the same greedy
   tokens for 2 prompts, paged and dense.  Before the depth-8 model is
   freed, its tensor windows (A16c: the expert stacks cut on d_ff, the
   routing once a card, the ranks' expert partials summed in f32 in
   rank order): the model cut into tensor 2 on the card repeated;
   "moe tensor 2", a paged ModelServer('mixtral-8x7b', tensor=2)
   behind the asyncio front answering 4 concurrent greedy /generate
   requests of 5, 100, 250 and 700 tokens (32 new tokens each), and
   "moe tensor 2 (int8 pool)", an engine with an int8 pool on the same
   prompts; then the model cut into tensor 4 and "moe tensor 4", an
   engine with a bf16 pool on the same prompts.  Held: launches
   exactly (B3 L tp a prompt, the window's paged kernel L tp a tick,
   the other 0), /health's tensor degree,
   every token at its own context under the tensor model's own forward
   (the MoE blocks as served), tensor 1's "moe paged" tokens saying
   where they part.  Printed, not held: the logits' distance from the
   tensor-1 model's on the same context (a routing flip near a top-2
   tie moves a logit far past DRIFT_LIMIT), the tp-2 and tp-4 ticks
   beside the tp-1 one, the weight GiB a rank and each degree's
   seconds.
5d. The slice (serve/slice_replica.py, sequence-parallel serving) on
   phase 4's llama3-8b weights (full width, SERVE_LAYERS), every rank of
   a mesh on the one card (`devices=[cuda:0] * sp`), max_len 8192 (the
   preset's max_seq_len):
   - ring_attention and ulysses_attention at sp 2 and 4 on [1, 32,
     8192, 128] / [1, 8, 8192, 128] bf16, within 2e-2 of the plain
     causal attention of the whole sequence, B3 launched sp (sp + 1) / 2
     (ring) or sp (Ulysses) times; device ms beside one B3 call.
   - prefill_sp at sp 1, 2 and 4 on a 7,936-token prompt: the caches
     against decode.prefill's (sp 1 bit for bit; sp 2 and 4 within 2e-2
     relative, Frobenius, per leaf), B3 launched L sp (sp + 1) / 2
     times (L = SERVE_LAYERS), the first greedy token held at its own context; device ms
     and host-clock ms per sp beside the engine's chunked prefill of the
     same prompt (512-token pieces).
   - "slice": SliceReplicaEngine(num_hosts=4, sequence=4), paged bf16
     pool (2048 pages of 16), sp_threshold 1024, 4 slots; prompts of
     3000, 7900 and 100 tokens submitted at once, 32 greedy tokens
     each.  Held: sp_prefills == 2, sync_count > 0, slice_sync_ms on
     every span, launches equal to PERF.md's prediction (B3 L x 10
     per SP prefill and L for the short prompt's chunk 0, B1 L a
     tick, B2 none), and every token at its own context against the
     single paged engine on the same prompts (`hold_tokens`, as in
     phase 5: the masked forward of ~8,000 tokens holds ~17 GB of f32
     scores a layer for a moment).
     "slice (int8 pool)": the same at sequence=2 with an int8 pool
     (B3 L x 3 per SP prefill, B2 L a tick, B1 none).
   - "slice http": ModelServer(num_hosts=4, slice_sequence=4,
     slice_devices=[cuda:0] * 4) behind the asyncio front: one greedy
     /generate of the 3000-token prompt equals the slice engine's
     tokens, /health carries `slice` (one SP prefill); B3 10 L, B1 L a
     tick.
5e. Tensor serving (models/tensor_parallel.py) on phase 4's llama3-8b
   weights (full width, SERVE_LAYERS), every tensor rank on the one card
   (a device list that repeats `cuda:0`): the weights cut into 2, then 4
   ranks (`convert.to_tensor_parallel`), 4 prompts of 5-700 tokens and
   32 greedy tokens each.  A tensor-1 engine on the same prompts first
   (its counts are the base the tensor paths multiply).  Paths, each
   with its launch counts zeroed just before and read once the worker
   has read its last tick, held exactly to PERF.md's prediction (B3 L
   tp a prompt, tp times the tensor-1 count; B1, or B2 on an int8 pool,
   L tp a tick; B3 L tp sp (sp + 1) / 2 per SP prefill): "tensor 2"
   (ModelServer(tensor=2, tensor_devices=[cuda:0] * 2), paged, over
   HTTP behind the asyncio front; /health's tensor_degree 2), "tensor 2
   dense" (the dense slot cache, pipelined then the legacy loop),
   "tensor x sequence slice" (SliceReplicaEngine over sequence 2 x
   tensor 2, max_len 8192, prompts of 1100, 2000 and 100 tokens: two
   SP prefills), "tensor 4" (as tensor 2), "tensor 4 (int8 pool)"
   (int8 KV and spec k = 4) and "tensor slice" (ModelServer(num_hosts=4,
   slice_devices=[cuda:0] * 4): llama3-8b's default layout is tensor 4;
   one 1100-token /generate, an SP prefill at sp 1).  Every generated
   token is held at its own context as in phase 5, under the tensor
   model's own forward (flash vs masked), the tensor-1 engine's tokens
   saying where they part; and on the same contexts the tensor model's
   logits are held to the tensor-1 model's: max |A_tp - A_1| at most
   DRIFT_LIMIT times tensor-1's own flash-vs-masked delta.  Also:
   prefill_sp of 7,936 tokens over sequence 2 x tensor 2 (B3 L x 3 x
   2, the cache within 2e-2 relative of decode.prefill's, the first
   token held, device ms); the handoff across degrees (a tensor-2
   prefill export of 100 tokens against the tensor-1 export: hashes
   equal, k and v of every layer within HANDOFF_LAYER_LIMIT relative;
   the tensor-1 frame imported into a tensor-1 and a tensor-2 engine and
   exported again: byte-equal frames; the tensor-2 engine's decode from
   the imported pages held); a depth-1 f32 cut at tensor 2, GPU ==
   CPU greedy tokens (paged and dense); and the paged tick at tp 1 / 2
   / 4 (`profile_decode.profile_tick`, 10 timed ticks and one profiled:
   host ms, device ms, kernels; printed, not held).  Both limits are
   shown to catch a fault each run: with rank tp-1's partial left out
   of every row-parallel sum (`planted_drift`), the drift must pass
   DRIFT_LIMIT; with the ranks' heads joined in reverse order on
   export (`tensor_handoff`), a layer must pass HANDOFF_LAYER_LIMIT
   (the code is patched in this process, for that call only).
6. A reference check: a depth-2, f32 cut of llama3-8b served on the
   GPU (CUDA kernels) and on the CPU (the plain versions) from the same
   weights must give the same greedy tokens, paged and dense engines.
7. The training path: llama3-8b at full width cut to 4 layers, seeded
   random trainable weights (f32 master copy, bf16 compute), batch
   2 x 2048, TrainConfig() defaults, 2 warm-up and 5 timed
   `train_step`s on one repeated batch: step ms, tokens/s, peak memory,
   the loss per step (finite and falling), one profiled step (its wall
   time, device busy time and idle share, all from the one trace).
   Launch counts are zeroed just before and read
   just after: B3 must run 2L times a step (forward and its remat
   recompute), B4 and B5 L times.  Then 2 steps with fused CE and
   accum_steps = 2 from the same initial weights, whose step-1 loss and
   grad_norm must equal the unfused run's within 1e-3 relative; then
   the CLI, `train_llama --model small` (d 64 kernels) for 3 steps.
7b. Training resume (data/loader.py, data/prefetch.py, the training
   half of data/checkpoints.py, callbacks/): llama3-8b at full width
   (d_model 4096, 32/8 heads, head_dim 128, d_ff 14336, vocab 128256),
   depth cut 32 -> 1 (a training step is 12 B a parameter: 15.2 GB on
   disk and in host RAM at depth 1), batch 2 x 2048.  A seeded token
   file (4,194,304 ids, uint32) and a depth-1 HF source written with the
   port's safetensors writer, converted into an init directory; then
   `train_llama.run` with `--model auto --init-from <init> --data
   <tokens>`: run U (5 steps, no checkpoint directory), run A
   (SKYTPU_CHECKPOINT_DIR set, 1 step: saves step 0, on the 10-step
   interval), run B (the same directory, 5 steps: resumes at 1).  Held:
   A's step-0 loss equal to U's; B's losses for steps 1-4 within 1e-5
   relative of U's (the largest difference and whether they are
   bit-equal printed); the state `restore_or_init` restores bit-equal
   to run A's final state (every parameter, both moments, the counts);
   the prefetched batches equal `batch_at` for steps 0 and 1;
   ModelServer('auto', checkpoint_dir=<ckpt>) restores the step's
   params bit-equal to the in-memory cast and answers /generate with an
   in-memory server's greedy tokens (2 prompts).  Launch counts are
   zeroed just before U and read just after B ("training resume"): B3
   exactly 20, B4 and B5 exactly 10 (10 steps, 2L / L / L).  Printed
   with the card: convert, checkpoint write (the save histogram),
   blocked and restore seconds, each run's summary.json
   (compute_seconds_per_step, data_wait_seconds, prefetch_wait_seconds,
   peak memory), the free disk before and the disk used at peak, the
   phase's seconds.  Every temporary directory is deleted.
7c. Sharded training ("sharded training"): llama3-8b width at depth
   2, bf16, remat, batch 2 x 4096, 3 steps from seed 0: the unsharded
   step, then mesh A (fsdp 2 x sequence 2, ring) and mesh B (data 2 x
   sequence 2, Ulysses) and the tensor mesh (sequence 2 x tensor 2,
   ring: each tensor rank runs its 16/4 heads, the o_proj and MLP
   partials summed across the tensor ranks, the fused or plain loss
   vocab-parallel) over four entries of the card.  Held: losses
   finite and falling, step-1 loss within 1e-2 of the unsharded step's,
   launches exactly `shard_launches` (ring: ranks x L x sp(sp+1)/2 hops,
   Ulysses: ranks x L x sp calls; each times tp, the tensor degree;
   B3 twice for the layer checkpoint);
   printed: step ms, peak memory, params + moments a mesh position
   holds and those stored on each distinct device (`device_bytes`: one
   copy a block over entries of one card).  With four cards, mesh B
   also runs over cuda:0 ... cuda:3 ("sharded training (ulysses, four
   cards)"), a copy of each replicated block on each card: launches,
   losses and step 1 held as above, every copy bit-equal to its owner
   after the steps (`train.check_copies`), the same bytes stored on
   each card; printed: step ms, each card's peak and stored bytes.
   With fewer cards it is printed as skipped.  An f32 cut (depth 1, 2 x 1024): the three meshes against the
   unsharded GPU step, loss within rtol 1e-5, every gradient within
   1e-3 of max |unsharded|.  `train_llama --model small` over four
   entries (fsdp 2 x sequence 2) with --preflight and a checkpoint
   directory, launches held; its step 0 restored onto fsdp 4
   (`restore_sharded`) bit-equal to the step's files.
7d. MoE training ("moe sharded training (tensor)"): mixtral-8x7b
   width at depth 1, bf16, remat, batch 1 x 2048, 3 steps from seed 0
   on one batch: the unsharded step, then tensor 2 over two entries of
   the card (each rank's expert products over its d_ff half, the
   capacity dispatch over the global batch), the first state (~27 GB:
   1.71 G f32 parameters, gradients and two moments) freed before the
   second is built.  Held: losses finite and falling, launches exactly
   `shard_launches` (B3 2 L tp a step, B4 and B5 L tp), the tensor
   step-1 loss within 1e-2 of the unsharded one; printed: step ms,
   peak memory, params + moments a position, the phase's seconds.
7e. Pipeline training ("pipeline training", parallel/pipeline.py):
   llama3-8b width at depth 4, bf16, remat, batch 4 x 2048, 3 steps
   from seed 0 on one batch: the unsharded step, then
   `pipeline_train_step` at pipeline 2 (two layers a stage) over two
   entries of the card at M = 1, 2 ("pipeline training") and 4
   microbatches, and at M = 2 pipeline 2 x tensor 2 and pipeline 2 x
   sequence 2 (ring) over four entries, each state freed before the
   next is built.  Held: losses finite and falling, launches exactly
   `pipeline_launches` (`shard_launches` of the other axes times M: B3
   2 L M a step, B4 and B5 L M, times tp and the ring's hops), step-1
   loss within 1e-2 of the unsharded step's; printed: step ms, peak
   memory, params + moments a mesh position and stored a device.  An
   f32 cut (depth 2, one
   layer a stage, 2 x 1024, M = 2) against the unsharded GPU step:
   loss within rtol 1e-5, every gradient within 1e-3 of max
   |unsharded|.
7f. Multi-host training ("multihost training", parallel/distributed.py):
   two host processes of `python -m skypilot_tpu_torch.train_llama`
   with SKYTPU_NUM_HOSTS=2, SKYTPU_HOST_RANK and
   SKYTPU_COORDINATOR_ADDRESS=127.0.0.1:<a free port>, set here (no
   gang supervisor): llama3-8b width at depth 2, bf16, remat, batch 2
   x 1024 a host, 2 steps from seed 0, both hosts on cuda:0 over gloo
   (`--dist-backend gloo`: NCCL refuses two ranks on one card; gloo
   stages the gradients through host memory), against one process
   over a data-2 mesh of two entries of cuda:0 with the same global
   batch of 4, run after the hosts have exited.  Held: losses finite
   and falling, step 1 within rtol 1e-5 of the one process's and step
   2 within 1e-2, both hosts' digests (sha256 of the parameters and
   moments) equal, each host's B3 / B4 / B5 launches exactly 2 L / L /
   L a step (its one-position mesh's).  With two or more cards the
   same run over NCCL, a card a host (else printed as skipped); with
   four, two hosts of two cards over NCCL against one process over the
   four.  Printed: step ms, reduction ms a step (CUDA events), bytes
   reduced, each host's peak.  An f32 cut (depth 1, 2 x 512 a host,
   fsdp 2 a host over two entries of cuda:0, one step) against the same
   global mesh without hosts (data 2 x fsdp 2 over four entries), which
   host 0 steps in its own process after its hosts' step: loss within
   rtol 1e-5, every parameter after the step within 1e-3 of max |one
   process|, digests equal.
   "multihost pipeline": two host processes of `python -m
   skypilot_tpu_torch.profile_pipeline --devices cuda:0
   --dist-backend gloo` (a stage a host: llama3-8b width at depth 2,
   bf16, remat, the global batch 2 x 1024 of which each host passes
   its row, M = 2, a warm-up and one timed step from seed 0; each
   stage's output sent to the other host, the backward driven host by
   host), against pipeline 2 over two entries of cuda:0 in this process
   (phase 7e's path) on the same batch, run after the hosts have
   exited.  Held: step 1 within rtol 1e-5 of the one process's, step 2
   within 1e-2, both hosts' digests equal (`train.state_digest`: each
   host hashes every leaf it holds, the end blocks on both, and takes
   the other's stage from it), each host's launches
   exactly its stage's share (2 L_h M / L_h M / L_h M a step: 8 / 4 / 4
   in all).  With two or more cards the same over NCCL, a card a host
   (else printed as skipped).  Printed: the timed step's ms, the
   boundary's bytes and ms and the bytes and ms reduced in the timed
   step (the warm-up left out), each host's peak.
   "multihost moe": two hosts of `MOE_HOST` (`train.create_train_state`
   and one `train.train_step`: mixtral-8x7b width at depth 1, bf16,
   remat, capacity factor 0.5, so that about half the assignments are
   dropped and the prefix of the other host's counts decides which; a
   row of 1024 tokens a host) on cuda:0 over gloo, against a data-2
   mesh of two entries of cuda:0 in this process on the same global
   batch.  Held: the loss within rtol 1e-5, the grad norm within
   1e-2, digests equal, launches 2 / 1 / 1 a host.  Printed: step ms,
   bytes and ms reduced, each host's peak.  Then one MoE layer at that
   width with random stacks on 2 x 1024 random rows
   (`compact_buffer_check`): the hosts' compact expert buffers (each
   its kept slots, [E, W, d]) give the whole [E, C, d] buffer's
   outputs within 1e-4 of their max, and a zero prefix on host 1
   leaves that bound.
7g. Elastic training ("elastic training", models/elastic.py): an
   `ElasticTrainer` at llama3-8b width, depth 1, bf16, remat, fused CE,
   batch 4 x 2048, saves every 2 steps, under a SKYTPU_HOME of its own
   in a temporary directory: fsdp 4 over four entries of the card
   (cuda:0-3 with four cards) takes steps 0-3 (saves 0 and 2, 15.2 GB
   each), `resize` to two entries (cuda:0-1) resumes at step 3 and
   takes steps 3-4 (saves 4), `resize` back to four resumes at step 5
   and takes step 5.  Held: each resize resumes after the newest save,
   the restored state's `train.state_digest` equal to the one taken
   when that step was saved, the recomputed step 3 within 1e-2 of its
   first run, the journal (training.jsonl) exactly train_resume
   (restored false) -> save start/end pairs of steps 0 and 2 with
   status ok -> gang_resize 4 -> 2 -> train_resume (step 3, restored)
   -> the pair of step 4 -> gang_resize 2 -> 4 -> train_resume (step
   5), and B3 / B4 / B5 launches exactly `shard_launches` of each size
   (48 / 24 / 24).  Printed: each size's step ms (a save step includes
   its snapshot), the save drain and resize (restore + setup) seconds,
   the digest seconds, params + moments stored on each card, each
   card's peak, each save's seconds, the phase's seconds.  Its
   temporary directory is deleted on a thread of its own, joined
   before the script exits.
8. A training reference check: depth-1 f32 llama3-8b, one 256-token
   sequence, loss.backward() on the GPU (kernels) and on the CPU (the
   plain versions) from the same weights: the loss and every gradient
   within 1e-3 of the CPU's largest |value| for that leaf.

The line before the last is the `kernels` JSON: each kernel's
`launches` is its count on the path `path` names ("moe tensor 2" for
B1, "moe tensor 2 (int8 pool)" for B2, "elastic training" (phase 7g,
the newest training path) for B3-B5), and
`launches_by_path` holds every
driven path's own count (serving, the two observability windows, the
five paths of phase 5, "int8 weights" and "checkpoint" of phase 5b,
the six MoE paths of phase 5c, the three slice paths of phase 5d,
the six tensor paths of phase 5e,
training, `train_llama small`, "training resume", the five paths of
phase 7c, the two of phase 7d, the six of phase 7e, the six of phase
7f: "multihost training", "multihost pipeline" and "multihost moe",
each with its "(one process)", "elastic training" of phase 7g), each path zeroed just before it and read just after (a host
process's count starts at 0 and is read at its end).  B3's
entry carries the 512-token chunk under `serving_chunk`, the ring hop
under `ring_hop_causal` / `ring_hop_full` and mesh B's call under
`ulysses`, the tensor mesh's hops under `tensor_ring_hop_full` /
`tensor_ring_hop_causal`; B4's and B5's top-level times are at the
tensor mesh's non-causal ring hop (16/4 heads), with its causal hop
under `tensor_ring_hop_causal`, mesh A's hops under `ring_hop_full` /
`ring_hop_causal`, the Ulysses shape under `ulysses` and the training
shape under `training_shape`;
B1's and B2's top-level times are
at the slice tick, with the serving tick under `serving_tick`, the
full batch under `full_batch` and their split span in pages,
`split_pages`.  B1's, B2's and B3's times at a tensor rank's heads are
under `tensor_rank` ('tp2', 'tp4').  Every time carries the method that took it
(`timed_by`, `library_timed_by`).
The last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12             # dense tensor cores
F32_FLOPS = 67e12               # outside the tensor cores


def log(msg: str) -> None:
    print(msg, flush=True)


class Laps:
    """Seconds by step: `laps(name)` records the seconds since the
    last call (or since it was made) under `name`."""

    def __init__(self):
        self.t0 = self.last = time.perf_counter()
        self.seconds = {}

    def __call__(self, name: str) -> float:
        now = time.perf_counter()
        self.seconds[name] = round(now - self.last, 1)
        self.last = now
        return self.seconds[name]

    def done(self, name: str) -> None:
        """A lap that is logged, with the seconds since the start."""
        s = self(name)
        log(f'[{self.last - self.t0:.1f} s] {name}: {s:.1f} s')


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], check=True,
                          capture_output=True,
                          text=True).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
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


def is_device_event(e) -> bool:
    """A profiler event that ran on the card (a kernel, memcpy or
    memset); a user annotation spans kernels that are counted alone."""
    import torch
    return (e.device_type == torch.autograd.DeviceType.CUDA and
            not getattr(e, 'is_user_annotation', False))


def device_time(fn, iters: int = 20, warmup: int = 3,
                host_gaps_ok: bool = False) -> dict:
    """{'ms': device time per call, 'timed_by': its method}.  By
    'profiler': the summed durations of every kernel that `iters` calls
    launch (torch.profiler, CUDA activity), over `iters`, after
    `warmup` calls; unlike `time_ms` it holds no host time.  A window
    counts only when it holds at least `iters` times the kernels of one
    profiled call (the fewer of two; copies and memsets, which a call
    may add only sometimes, are not counted): on some machines a window
    records none or only some of them (runs of this script on the H100,
    at different windows, once a B4 under its bound).  The same calls
    are then timed by 'queued_events' (`queued_event_ms`), which also
    counts the device's gaps between a call's kernels, and a line says
    so.  Where the queueing outlasts every spin (a call that waits on
    the device inside it, or a long queue), `queued_event_ms` raises;
    only with `host_gaps_ok` (a whole prefill_sp call, which syncs
    inside) are the calls then timed by 'events_with_host' (`time_ms`:
    CUDA events around the calls, the host's gaps included), and a line
    says so.  A kernel's row never takes that fallback."""
    import torch

    def profiled(n):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        return [e for e in prof.events() if is_device_event(e)]
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    def kernels(events):
        return sum(1 for e in events
                   if not e.name.startswith(('Memcpy', 'Memset')))
    per_call = min(kernels(profiled(1)), kernels(profiled(1)))
    events = profiled(iters)
    us = sum(e.time_range.end - e.time_range.start for e in events)
    if per_call > 0 and kernels(events) >= per_call * iters:
        return {'ms': us / 1e3 / iters, 'timed_by': 'profiler'}
    try:
        ms, timed_by = queued_event_ms(fn, iters), 'queued_events'
        how = 'CUDA event pairs on a queued stream'
    except AssertionError as e:
        if not host_gaps_ok:
            raise
        ms, timed_by = time_ms(fn, iters, warmup=0), 'events_with_host'
        how = f'{e}; CUDA events around the calls, host gaps included'
    log(f'device_time: the profiler window saw {kernels(events)} '
        f'kernels, under {iters} x {per_call}; {how}: {ms:.4f} ms a call')
    return {'ms': ms, 'timed_by': timed_by}


def queued_event_ms(fn, iters: int) -> float:
    """Device time per call without the profiler: a CUDA event pair
    around each of `iters` calls, all queued behind a spin kernel that
    holds the stream until the host has queued them, so no pair waits
    for the host.  The spin grows until it outlasts the queueing (three
    tries)."""
    import torch
    spin_s = 0.05
    for _ in range(3):
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
                 for _ in range(iters)]
        torch.cuda.synchronize()
        torch.cuda._sleep(int(spin_s * 2e9))  # pylint: disable=protected-access
        t0 = time.perf_counter()
        for start, end in pairs:
            start.record()
            fn()
            end.record()
        queued_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        if queued_s < spin_s / 2:
            return sum(a.elapsed_time(b) for a, b in pairs) / iters
        spin_s *= 4
    raise AssertionError(f'queued_event_ms: queueing took {queued_s:.3f} s, '
                         f'past a {spin_s / 4:.3f} s spin')


def timed_call(fn) -> dict:
    """`device_time`'s {'ms', 'timed_by'} and 'ms_with_host': CUDA-event
    time per call, the host's launch work included."""
    return dict(device_time(fn), ms_with_host=time_ms(fn))


def library_time(fn) -> dict:
    """{'library_ms', 'library_timed_by'}: `device_time` of the PyTorch
    call that computes a kernel's function."""
    t = device_time(fn)
    return {'library_ms': t['ms'], 'library_timed_by': t['timed_by']}


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def kernel_summary(r) -> str:
    """One kernel's times: device ms with its roofline share, the
    CUDA-event ms with the host, plain and library ms, bound."""
    return (f'{r["ms"]:.4f} ms device by {r["timed_by"]} '
            f'({100 * r["bound_ms"] / r["ms"]:.1f}% of the bound), '
            f'{r["ms_with_host"]:.4f} ms per call with host; plain '
            f'{r["plain_ms"]:.4f}, bound {r["bound_ms"]:.4f} by '
            f'{r["bound_by"]}, library {r["library_ms"]}'
            + (f' by {r["library_timed_by"]}'
               if r.get("library_timed_by") else ''))


def check_close(name, out, ref, tol) -> float:
    import torch
    err = max_err(out, ref)
    if not torch.isfinite(out.float()).all():
        raise AssertionError(f'{name}: non-finite output')
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol,
                               msg=lambda m: f'{name}: {m}')
    return err


def zero_counts(counters) -> None:
    """Set every kernel's launch count to 0 (just before a path runs)."""
    for table in counters.values():
        for key in table:
            table[key] = 0


def read_counts(counters) -> dict:
    """{kernel: launches since the last zero_counts}."""
    return {name: table[name] for name, table in counters.items()}


# ------------------------------------------------------------ phase 2


def kernel_label(mangled: str) -> str:
    """`flash_fwd_wgmma_kernel<bf16, d 128>` from a mangled name;
    `paged_decode_split_kernel<bf16, int8 pool, d 128>` for B2."""
    name = re.search(r'\d+((?:flash|paged)_[a-z0-9_]*kernel)', mangled)
    d = re.search(r'Li(\d+)E', mangled)
    if not name or not d:
        return mangled
    # wgmma kernels are bf16 only and the scalar forward f32 only; the
    # scalar backward and the paged kernels carry their (query) type,
    # the paged kernel then its pool's (int8_t mangles as 'a').
    types = mangled.split('Li')[0]
    dtype = ('bf16' if 'wgmma' in mangled or '__nv_bfloat16' in types
             else 'f32')
    pool = 'int8 pool, ' if types.endswith('a') else ''
    return f'{name.group(1)}<{dtype}, {pool}d {d.group(1)}>'


def compiled_report(build) -> None:
    """What nvcc made of every kernel: per kernel instantiation, ptxas's
    registers, stack and spills (from the build log) and the tensor-core
    (HGMMA, HMMA) and scalar FMA (FFMA) instructions in `cuobjdump
    -sass`.  Fails if a wgmma kernel has no HGMMA or spills."""
    import os
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), 'cuobjdump')
    for source in ('flash_fwd', 'flash_bwd', 'paged_attention'):
        ptxas, fn = {}, None
        for line in build.build_log(source).splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                fn = m.group(1)
                continue
            m = re.search(r'(\d+) bytes stack frame, (\d+) bytes spill '
                          r'stores, (\d+) bytes spill loads', line)
            if m and fn:
                ptxas[fn] = dict(stack=int(m.group(1)),
                                 spills=int(m.group(2)) + int(m.group(3)))
            m = re.search(r'Used (\d+) registers', line)
            if m and fn:
                ptxas.setdefault(fn, {})['registers'] = int(m.group(1))
                fn = None
        sass = subprocess.run([cuobjdump, '-sass', build.library_path(source)],
                              check=True, capture_output=True,
                              text=True).stdout
        ops, fn = {}, None
        for line in sass.splitlines():
            m = re.search(r'Function : (\S+)', line)
            if m:
                fn = m.group(1)
                ops[fn] = dict(HGMMA=0, HMMA=0, FFMA=0)
            elif fn:
                for op in ops[fn]:
                    ops[fn][op] += bool(re.search(rf'\b{op}\b', line))
        for fn in sorted(ops, key=kernel_label):
            log(f'  {source}: {kernel_label(fn)}: ptxas {ptxas.get(fn)}; '
                f'sass {ops[fn]}')
            if 'wgmma' in fn and ops[fn]['HGMMA'] == 0:
                raise AssertionError(f'{kernel_label(fn)}: no HGMMA in its '
                                     'SASS')
            if (('wgmma' in fn or 'paged' in fn) and
                    (ptxas.get(fn) or {}).get('spills')):
                raise AssertionError(f'{kernel_label(fn)}: spills '
                                     f'{ptxas[fn]}')


# ------------------------------------------------------------ phase 3


# Slot lengths of the paged cases, with their block-table rows: ragged
# (the serving tick) and a full batch of 8 slots at 1000 positions, as
# the 1024-token server holds them (64 rows); the slice path's last tick
# (phase 5d: 4 slots of an 8192-token engine, 512 rows, holding prompts
# of 3000, 7900 and 100 tokens 31 tokens on, and a free slot).
PAGED_RAGGED = [1, 15, 16, 17, 1000]
PAGED_FULL = [1000] * 8
PAGED_ROWS = 64
SLICE_TICK = [3030, 7930, 130, 0]
SLICE_ROWS = 512


def paged_case(dev, dtype, quantized, s_q, seed, lengths=PAGED_RAGGED,
               rows=PAGED_ROWS, heads=(32, 8)):
    """Pool, q, tables, lengths at the 8B decode shapes (`heads`: a
    tensor rank's (h_q, h_kv))."""
    import torch
    from skypilot_tpu_torch.models import decode
    gen = torch.Generator(device=dev).manual_seed(seed)
    (h_q, h_kv), b, d, ps = heads, len(lengths), 128, 16
    n_pages = 1 + b * rows
    kshape = (n_pages, h_kv, ps, d)
    k = torch.randn(kshape, generator=gen, device=dev)
    v = torch.randn(kshape, generator=gen, device=dev)
    if quantized:
        kq, ks = decode._quant_kv(k)  # pylint: disable=protected-access
        vq, vs = decode._quant_kv(v)  # pylint: disable=protected-access
        k_leaf, v_leaf = {'q': kq, 'scale': ks}, {'q': vq, 'scale': vs}
    else:
        k_leaf, v_leaf = k.to(dtype), v.to(dtype)
    tables = torch.zeros((b, rows), dtype=torch.int32)
    perm = torch.randperm(n_pages - 1, generator=torch.Generator()
                          .manual_seed(seed)) + 1
    for i, length in enumerate(lengths):
        need = -(-(length + s_q) // ps)
        tables[i, :need] = perm[i * rows:i * rows + need].to(torch.int32)
    tables[0, 0] = 0                    # a live row on the null page
    q = torch.randn((b, h_q, s_q, d), generator=gen, device=dev).to(dtype)
    return (q, k_leaf, v_leaf, tables.to(dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


def bound(n_bytes, flops, peak):
    """(bound_ms, bound_by): the larger of the bytes' time over the
    memory rate and the operations' time over the peak rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            'bytes' if t_bytes >= t_ops else 'operations')


def paged_bound(q, k_leaf, tables, lengths, quantized):
    b, h_q, s_q, d = q.shape
    pool = k_leaf['q'] if quantized else k_leaf
    h_kv, ps = pool.shape[1], pool.shape[2]
    pages = sum(min(tables.shape[1], -(-(int(n) + s_q) // ps))
                for n in lengths.tolist())
    per_token = d * pool.element_size() + (4 if quantized else 0)
    kv_bytes = 2 * pages * h_kv * ps * per_token
    io_bytes = 2 * q.numel() * q.element_size() + tables.numel() * 4 + b * 4
    keys = sum(int(n) + s_q for n in lengths.tolist())
    flops = 4 * h_q * s_q * keys * d
    peak = F32_FLOPS if q.dtype.itemsize == 4 else BF16_FLOPS
    return bound(kv_bytes + io_bytes, flops, peak)


def check_paged(dev, quantized):
    """B1 or B2 against its plain version: bf16 S = 1 and 5 and f32 S = 5
    on the ragged lengths, the serving phases' S (1 native, 5 (spec)
    int8) on the full batch, and S = 1 at the slice path's tick
    (`SLICE_TICK`, 512-row tables); two launches must give the same
    bits.  Timed at the slice tick (the kernels line's shape: its
    launches are the slice paths'), with the serving phases' tick on the
    ragged lengths under `serving_tick` and the full batch under
    `full_batch`; `split_pages` is their split span."""
    import torch
    from skypilot_tpu_torch.ops import paged_attention as pa
    errs = []
    timed = {}
    s_serve = 5 if quantized else 1
    cases = [(torch.bfloat16, 1, PAGED_RAGGED, PAGED_ROWS),
             (torch.bfloat16, 5, PAGED_RAGGED, PAGED_ROWS),
             (torch.float32, 5, PAGED_RAGGED, PAGED_ROWS),
             (torch.bfloat16, s_serve, PAGED_FULL, PAGED_ROWS),
             (torch.bfloat16, 1, SLICE_TICK, SLICE_ROWS)]
    for dtype, s_q, lens, rows in cases:
        q, kl, vl, tables, lengths = paged_case(dev, dtype, quantized, s_q,
                                                seed=s_q, lengths=lens,
                                                rows=rows)
        scale = q.shape[-1] ** -0.5
        out = pa.paged_attention(q, kl, vl, tables, lengths)
        again = pa.paged_attention(q, kl, vl, tables, lengths)
        ref = pa._paged_attention_reference(  # pylint: disable=protected-access
            q, kl, vl, tables, lengths, sm_scale=scale)
        torch.cuda.synchronize()
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        shape = ('full batch 8 x 1000' if lens is PAGED_FULL else
                 f'lengths {lens}, {rows}-row tables')
        name = f'paged{"_int8" if quantized else ""} {dtype} S={s_q} {shape}'
        if not torch.equal(out, again):
            raise AssertionError(f'{name}: two launches differ')
        errs.append(check_close(name, out, ref, tol))
        log(f'  {name}: max_abs_err {errs[-1]:.3g} (tol {tol}); two '
            'launches bit-equal')
        if lens is SLICE_TICK:
            timed['slice_tick'] = (q, kl, vl, tables, lengths, scale)
        elif dtype == torch.bfloat16 and s_q == s_serve:
            key = 'full_batch' if lens is PAGED_FULL else 'serving_tick'
            timed[key] = (q, kl, vl, tables, lengths, scale)
    shapes = {}
    for key, (q, kl, vl, tables, lengths, scale) in timed.items():
        kernel = timed_call(lambda: pa.paged_attention(q, kl, vl, tables,
                                                       lengths))
        plain = time_ms(lambda: pa._paged_attention_reference(  # pylint: disable=protected-access
            q, kl, vl, tables, lengths, sm_scale=scale))
        bound_ms, bound_by = paged_bound(q, kl, tables, lengths, quantized)
        shapes[key] = dict(max_abs_err=max(errs), **kernel, plain_ms=plain,
                           bound_ms=bound_ms, bound_by=bound_by,
                           library_ms=None)
    return dict(shapes['slice_tick'], serving_tick=shapes['serving_tick'],
                full_batch=shapes['full_batch'], split_pages=pa.SPLIT_PAGES)


# A tensor rank's heads (h_q, h_kv) of llama3-8b at tensor 2 and 4.
TENSOR_HEADS = {2: (16, 4), 4: (8, 2)}


def check_tensor_ranks(dev):
    """B1 (bf16, S = 1) and B2 (int8, S = 5) on the serving tick's
    ragged lengths, and B3 (bf16, causal) at the 512-token chunk, at a
    tensor rank's heads (`TENSOR_HEADS`): held against the plain version
    at phase 3's bf16 tolerance, two launches bit-equal; device ms,
    bound, plain ms and, for B3, SDPA's forward.  -> {kernel: {'tp2':
    result, 'tp4': result}}."""
    import torch
    import torch.nn.functional as F
    from skypilot_tpu_torch.ops import attention
    from skypilot_tpu_torch.ops import paged_attention as pa
    out = {'paged_attention': {}, 'paged_attention_int8': {},
           'flash_fwd': {}}
    for tp, heads in TENSOR_HEADS.items():
        for name, quantized, s_q in (('paged_attention', False, 1),
                                     ('paged_attention_int8', True, 5)):
            q, kl, vl, tables, lengths = paged_case(
                dev, torch.bfloat16, quantized, s_q, seed=40 + tp,
                heads=heads)
            scale = q.shape[-1] ** -0.5
            got = pa.paged_attention(q, kl, vl, tables, lengths)
            again = pa.paged_attention(q, kl, vl, tables, lengths)
            ref = pa._paged_attention_reference(  # pylint: disable=protected-access
                q, kl, vl, tables, lengths, sm_scale=scale)
            torch.cuda.synchronize()
            label = f'{name} tensor {tp} (h {heads[0]}/{heads[1]}, S={s_q})'
            if not torch.equal(got, again):
                raise AssertionError(f'{label}: two launches differ')
            err = check_close(label, got, ref, 2e-2)
            bound_ms, bound_by = paged_bound(q, kl, tables, lengths,
                                             quantized)
            out[name][f'tp{tp}'] = dict(
                max_abs_err=err, **timed_call(lambda: pa.paged_attention(
                    q, kl, vl, tables, lengths)),
                plain_ms=time_ms(lambda: pa._paged_attention_reference(  # pylint: disable=protected-access
                    q, kl, vl, tables, lengths, sm_scale=scale)),
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
        gen = torch.Generator(device=dev).manual_seed(512 + tp)
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16) for shape in ((1, heads[0], 512, 128),
                                          (1, heads[1], 512, 128),
                                          (1, heads[1], 512, 128)))
        got = attention.flash_attention(q, k, v)
        ref = attention._blockwise_attention(  # pylint: disable=protected-access
            q, k, v, causal=True, sm_scale=128 ** -0.5)
        torch.cuda.synchronize()
        label = f'flash_fwd tensor {tp} (h {heads[0]}/{heads[1]}, 512)'
        err = check_close(label, got, ref, 2e-2)
        flops = 4 * 128 * visible_entries(1, heads[0], 512, 512, True)
        io = ((2 * q.numel() + 2 * k.numel()) * q.element_size() +
              heads[0] * 512 * 4)
        bound_ms, bound_by = bound(io, flops, BF16_FLOPS)
        out['flash_fwd'][f'tp{tp}'] = dict(
            max_abs_err=err,
            **timed_call(lambda: attention.flash_attention(q, k, v)),
            plain_ms=time_ms(lambda: attention._blockwise_attention(  # pylint: disable=protected-access
                q, k, v, causal=True, sm_scale=128 ** -0.5)),
            bound_ms=bound_ms, bound_by=bound_by,
            **library_time(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True)))
    return out


# (dtype, b, h, h_kv, d, q_len, k_len) of B3 against its plain version:
# 8B serving prefill chunks (ragged, q_len < k_len, one f32), the
# training shape (b 2 x 2048) and `train_llama --model small`'s (16/8,
# d 64, b 8 x 512).  The 512-token chunk and the training shape are
# the ones timed.
FLASH_CASES = [
    ('bf16', 1, 32, 8, 128, 1, 1),
    ('bf16', 1, 32, 8, 128, 100, 100),
    ('bf16', 1, 32, 8, 128, 512, 512),
    ('bf16', 1, 32, 8, 128, 100, 612),
    ('f32', 1, 32, 8, 128, 100, 100),
    ('bf16', 2, 32, 8, 128, 2048, 2048),
    ('bf16', 8, 16, 8, 64, 512, 512),
]


def check_flash(dev):
    import torch
    import torch.nn.functional as F
    from skypilot_tpu_torch.ops import attention
    dtypes = {'bf16': torch.bfloat16, 'f32': torch.float32}
    errs = []
    cases = {}
    for dt, b, h, h_kv, d, q_len, k_len in FLASH_CASES:
        dtype = dtypes[dt]
        gen = torch.Generator(device=dev).manual_seed(q_len + k_len)
        q = torch.randn((b, h, q_len, d), generator=gen, device=dev)
        k = torch.randn((b, h_kv, k_len, d), generator=gen, device=dev)
        v = torch.randn((b, h_kv, k_len, d), generator=gen, device=dev)
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
        out, lse = attention.flash_attention_with_lse(q, k, v)
        ref, ref_lse = attention._blockwise_attention(  # pylint: disable=protected-access
            q, k, v, causal=True, sm_scale=d ** -0.5, return_lse=True)
        torch.cuda.synchronize()
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        name = (f'flash {dt} b={b} h={h}/{h_kv} d={d} q_len={q_len} '
                f'k_len={k_len}')
        errs.append(check_close(name, out, ref, tol))
        check_close(name + ' lse', lse, ref_lse, 1e-3)
        log(f'  {name}: max_abs_err {errs[-1]:.3g} (tol {tol})')
        if dt == 'bf16' and d == 128 and q_len == k_len and \
                (b, q_len) in ((1, 512), (TRAIN_BATCH, TRAIN_SEQ)):
            cases[q_len] = (q, k, v)
    # The 512-token serving chunk and the training shape; the kernels
    # line carries the training shape (B3's launches are the training
    # path's), the chunk rides along under `serving_chunk`.
    shapes = {}
    for n, (q, k, v) in cases.items():
        b, h, _, d = q.shape
        kernel = timed_call(lambda: attention.flash_attention(q, k, v))
        plain = time_ms(lambda: attention._blockwise_attention(  # pylint: disable=protected-access
            q, k, v, causal=True, sm_scale=d ** -0.5))
        library = library_time(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True))
        flops = 4 * d * visible_entries(b, h, n, n, True)
        io = ((2 * q.numel() + 2 * k.numel()) * q.element_size() +
              b * h * n * 4)
        bound_ms, bound_by = bound(io, flops, BF16_FLOPS)
        shapes[n] = dict(max_abs_err=max(errs), **kernel, plain_ms=plain,
                         bound_ms=bound_ms, bound_by=bound_by, **library)
    return dict(shapes[TRAIN_SEQ], serving_chunk=shapes[512])


# The hop of a ring over a 8192-token prompt at sp 4 (2048 rows a rank):
# the diagonal hop runs B3 causal, an earlier chunk's hop non-causal.
RING_HOP = 2048


def check_ring_hops(dev):
    """B3 at the ring-hop shape, bf16, b 1, 32/8 heads, d 128, q_len =
    k_len = 2048, causal and non-causal: held against the plain version
    at phase 3's bf16 tolerance; device ms (20 calls after 3 warm-ups),
    the bound by operations (989 TFLOP/s), the plain version's ms and
    SDPA's forward for the same setting.  -> {name: result}."""
    import torch
    import torch.nn.functional as F
    from skypilot_tpu_torch.ops import attention
    out = {}
    for causal in (True, False):
        gen = torch.Generator(device=dev).manual_seed(RING_HOP + causal)
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16) for shape in ((1, 32, RING_HOP, 128),
                                          (1, 8, RING_HOP, 128),
                                          (1, 8, RING_HOP, 128)))
        got, lse = attention.flash_attention_with_lse(q, k, v,
                                                      causal=causal)
        ref, ref_lse = attention._blockwise_attention(  # pylint: disable=protected-access
            q, k, v, causal=causal, sm_scale=128 ** -0.5, return_lse=True)
        torch.cuda.synchronize()
        name = f'ring hop {"causal" if causal else "non-causal"}'
        err = check_close(name, got, ref, 2e-2)
        check_close(name + ' lse', lse, ref_lse, 1e-3)
        kernel = timed_call(lambda: attention.flash_attention(
            q, k, v, causal=causal))
        plain = time_ms(lambda: attention._blockwise_attention(  # pylint: disable=protected-access
            q, k, v, causal=causal, sm_scale=128 ** -0.5))
        library = library_time(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True))
        flops = 4 * 128 * visible_entries(1, 32, RING_HOP, RING_HOP, causal)
        io = ((2 * q.numel() + 2 * k.numel()) * q.element_size() +
              32 * RING_HOP * 4)
        bound_ms, bound_by = bound(io, flops, BF16_FLOPS)
        out['ring_hop_causal' if causal else 'ring_hop_full'] = dict(
            max_abs_err=err, **kernel, plain_ms=plain, bound_ms=bound_ms,
            bound_by=bound_by, **library)
        log(f'  flash_fwd {name} (b 1, 32/8, d 128, {RING_HOP} x '
            f'{RING_HOP}): max_abs_err {err:.3g} (tol 2e-2); '
            f'{kernel["ms"]:.4f} ms device by {kernel["timed_by"]}, bound '
            f'{bound_ms:.4f} ms by {bound_by} '
            f'({100 * bound_ms / kernel["ms"]:.1f}% of it); SDPA forward '
            f'{library["library_ms"]:.4f} ms by '
            f'{library["library_timed_by"]}; plain {plain:.4f} ms')
    return out


# (dtype, b, h, h_kv, d, q_len, k_len, causal); the first is the
# training shape and is the one timed.
BWD_CASES = [
    ('bf16', 2, 32, 8, 128, 2048, 2048, True),
    ('bf16', 1, 32, 8, 128, 100, 100, True),
    ('bf16', 1, 32, 8, 128, 1000, 1000, True),
    ('bf16', 1, 32, 8, 128, 100, 612, True),
    ('bf16', 1, 28, 4, 128, 300, 300, True),      # Qwen2's group, rep 7
    ('bf16', 1, 8, 1, 256, 300, 300, True),       # Gemma's, rep 8, d 256
    ('bf16', 2, 16, 8, 64, 512, 512, True),       # small, d 64
    ('f32', 1, 32, 8, 128, 100, 100, True),
    ('bf16', 1, 32, 8, 128, 300, 300, False),
]


def bwd_inputs(dev, dtype, b, h, h_kv, d, q_len, k_len, causal, seed):
    """q, k, v, the forward's out and lse, a random output cotangent g
    and a non-zero LSE cotangent."""
    import torch
    from skypilot_tpu_torch.ops import attention
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, g = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                  for shape in ((b, h, q_len, d), (b, h_kv, k_len, d),
                                (b, h_kv, k_len, d), (b, h, q_len, d)))
    g_lse = torch.randn((b, h, q_len), generator=gen, device=dev)
    out, lse = attention.flash_attention_with_lse(q, k, v, causal=causal)
    return q, k, v, out, lse, g, g_lse


def visible_entries(b, h, q_len, k_len, causal) -> int:
    """Score entries the mask keeps: b * h * sum over query rows of the
    keys each sees."""
    if not causal:
        return b * h * q_len * k_len
    off = k_len - q_len
    return b * h * (q_len * off + q_len * (q_len + 1) // 2)


def bwd_bound(q, k, n_products, out_numel, causal=True):
    """Bound of a backward kernel: n_products products of 2 d FLOPs per
    visible score entry; bytes of q, dO, k, v, lse and delta read once
    and out_numel gradient elements written once."""
    b, h, q_len, d = q.shape
    entries = visible_entries(b, h, q_len, k.shape[2], causal)
    n_bytes = ((2 * q.numel() + 2 * k.numel() + out_numel) *
               q.element_size() + 2 * b * h * q_len * 4)
    peak = F32_FLOPS if q.dtype.itemsize == 4 else BF16_FLOPS
    return bound(n_bytes, n_products * 2 * d * entries, peak)


def check_flash_bwd(dev):
    """B4 and B5 against _flash_bwd_reference; -> {name: result}, timed
    at the training shape."""
    import torch
    from skypilot_tpu_torch.ops import attention
    dtypes = {'bf16': torch.bfloat16, 'f32': torch.float32}
    errs = {'flash_bwd_dq': [], 'flash_bwd_dkv': []}
    timed = None
    for i, (dt, b, h, h_kv, d, q_len, k_len, causal) in enumerate(BWD_CASES):
        dtype = dtypes[dt]
        args = bwd_inputs(dev, dtype, b, h, h_kv, d, q_len, k_len, causal,
                          seed=100 + i)
        kw = dict(causal=causal, sm_scale=d ** -0.5)
        got = attention._flash_bwd_cuda(*args, **kw)  # pylint: disable=protected-access
        again = attention._flash_bwd_cuda(*args, **kw)  # pylint: disable=protected-access
        ref = attention._flash_bwd_reference(*args, **kw)  # pylint: disable=protected-access
        torch.cuda.synchronize()
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        name = (f'flash_bwd {dt} b={b} h={h}/{h_kv} d={d} q_len={q_len} '
                f'k_len={k_len}{"" if causal else " non-causal"}')
        rels = []
        for grad, a, a2, r in zip(('dq', 'dk', 'dv'), got, again, ref):
            if not torch.equal(a, a2):
                raise AssertionError(f'{name} {grad}: two launches differ')
            if not torch.isfinite(a.float()).all():
                raise AssertionError(f'{name} {grad}: non-finite output')
            err = max_err(a, r)
            rel = err / max(float(r.float().abs().max()), 1e-30)
            if rel > tol:
                raise AssertionError(f'{name} {grad}: max err {err:.3g} is '
                                     f'{rel:.3g} of max |ref| (tol {tol})')
            errs['flash_bwd_dq' if grad == 'dq' else
                 'flash_bwd_dkv'].append(err)
            rels.append(rel)
        log(f'  {name}: rel err dq/dk/dv '
            f'{" ".join(f"{x:.2g}" for x in rels)} (tol {tol}); two '
            f'launches bit-equal')
        if i == 0:
            timed = args
    q, k, v, out, lse, g, g_lse = timed
    kw = dict(causal=True, sm_scale=q.shape[-1] ** -0.5)
    delta = attention._delta(out, g, g_lse).contiguous()  # pylint: disable=protected-access
    dq = timed_call(lambda: attention._flash_bwd_dq_cuda(  # pylint: disable=protected-access
        q, k, v, g, lse, delta, **kw))
    dkv = timed_call(lambda: attention._flash_bwd_dkv_cuda(  # pylint: disable=protected-access
        q, k, v, g, lse, delta, **kw))
    plain = time_ms(lambda: attention._flash_bwd_reference(  # pylint: disable=protected-access
        q, k, v, out, lse, g, g_lse, **kw))
    # SDPA's backward: the device time of forward + backward less the
    # forward's.
    sdpa_bwd = sdpa_times(q, k, v, g, True)[1]
    results = {}
    for name, kernel, n_products, out_numel in (
            ('flash_bwd_dq', dq, 3, q.numel()),
            ('flash_bwd_dkv', dkv, 4, 2 * k.numel())):
        bound_ms, bound_by = bwd_bound(q, k, n_products, out_numel)
        results[name] = dict(max_abs_err=max(errs[name]), **kernel,
                             plain_ms=plain, bound_ms=bound_ms,
                             bound_by=bound_by, **sdpa_bwd)
    return results


# The shapes sharded training (phase 7c, llama3-8b width, batch 2 x
# 4096) gives B3-B5: mesh A's ring hop (fsdp 2 x sequence 2: b 1, 32/8
# heads, 2048 x 2048; non-causal on the earlier chunk, causal on the
# diagonal, both with the lse cotangent of the merge) and mesh B's
# Ulysses call (data 2 x sequence 2: b 1, 16/4 heads, 4096 causal) and
# the tensor mesh's ring hop (sequence 2 x tensor 2: a tensor rank's
# 16/4 heads, 2048 x 2048, both kinds of hop).
SHARD_SHAPES = {'ring_hop_full': (1, 32, 8, 2048, False),
                'ring_hop_causal': (1, 32, 8, 2048, True),
                'ulysses': (1, 16, 4, 4096, True),
                'tensor_ring_hop_full': (1, 16, 4, 2048, False),
                'tensor_ring_hop_causal': (1, 16, 4, 2048, True)}


def sdpa_times(q, k, v, g, causal):
    """SDPA's forward and its backward (dq + dkv: forward + backward
    less the forward), device time, on the same inputs.  The difference
    takes both times by one method: where `device_time` timed the two
    calls by different ones, both are timed again by queued CUDA
    events."""
    import torch
    import torch.nn.functional as F
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]

    def fwd():
        return F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                              enable_gqa=True)

    def fwd_bwd():
        return torch.autograd.grad(fwd(), leaves, g)
    both = device_time(fwd_bwd)
    one = device_time(fwd)
    if both['timed_by'] != one['timed_by']:
        both = {'ms': queued_event_ms(fwd_bwd, 20),
                'timed_by': 'queued_events'}
        one = {'ms': queued_event_ms(fwd, 20), 'timed_by': 'queued_events'}
    return ({'library_ms': one['ms'], 'library_timed_by': one['timed_by']},
            {'library_ms': both['ms'] - one['ms'],
             'library_timed_by': both['timed_by']})


def check_sharded_shapes(dev):
    """B3-B5 at SHARD_SHAPES (bf16, d 128; the backward with a random
    output and lse cotangent): held against the plain versions (B3 at
    2e-2 absolute, B4/B5 at 2e-2 of max |plain|), two launches of each
    bit-equal, then device ms, the plain version's ms, SDPA's (forward;
    backward as dq + dkv) and the bound.  -> {kernel: {shape: result}}."""
    import torch
    from skypilot_tpu_torch.ops import attention
    out = {'flash_fwd': {}, 'flash_bwd_dq': {}, 'flash_bwd_dkv': {}}
    for label, (b, h, h_kv, n, causal) in SHARD_SHAPES.items():
        q, k, v, o, lse, g, g_lse = bwd_inputs(
            dev, torch.bfloat16, b, h, h_kv, 128, n, n, causal,
            seed=n + h + causal)
        kw = dict(causal=causal, sm_scale=128 ** -0.5)
        name = (f'{label} (b {b}, {h}/{h_kv}, d 128, {n} x {n}, '
                f'{"causal" if causal else "non-causal"})')
        ref_o, ref_lse = attention._blockwise_attention(  # pylint: disable=protected-access
            q, k, v, return_lse=True, **kw)
        again = attention.flash_attention_with_lse(q, k, v, causal=causal)
        if not (torch.equal(o, again[0]) and torch.equal(lse, again[1])):
            raise AssertionError(f'flash_fwd {name}: two launches differ')
        fwd_err = check_close(f'flash_fwd {name}', o, ref_o, 2e-2)
        check_close(f'flash_fwd {name} lse', lse, ref_lse, 1e-3)
        got = attention._flash_bwd_cuda(q, k, v, o, lse, g, g_lse, **kw)  # pylint: disable=protected-access
        again = attention._flash_bwd_cuda(q, k, v, o, lse, g, g_lse, **kw)  # pylint: disable=protected-access
        ref = attention._flash_bwd_reference(q, k, v, o, lse, g, g_lse, **kw)  # pylint: disable=protected-access
        torch.cuda.synchronize()
        errs = {}
        for grad, a, a2, r in zip(('dq', 'dk', 'dv'), got, again, ref):
            if not torch.equal(a, a2):
                raise AssertionError(f'flash_bwd {name} {grad}: two '
                                     'launches differ')
            if not torch.isfinite(a.float()).all():
                raise AssertionError(f'flash_bwd {name} {grad}: non-finite')
            err = max_err(a, r)
            rel = err / max(float(r.float().abs().max()), 1e-30)
            if rel > 2e-2:
                raise AssertionError(f'flash_bwd {name} {grad}: max err '
                                     f'{err:.3g} is {rel:.3g} of max |ref|')
            errs[grad] = err
        delta = attention._delta(o, g, g_lse).contiguous()  # pylint: disable=protected-access
        fwd_sdpa, bwd_sdpa = sdpa_times(q, k, v, g, causal)
        flops = 4 * 128 * visible_entries(b, h, n, n, causal)
        io = ((2 * q.numel() + 2 * k.numel()) * q.element_size() +
              b * h * n * 4)
        bound_ms, bound_by = bound(io, flops, BF16_FLOPS)
        if not label.startswith('ring_hop'):   # check_ring_hops'
            out['flash_fwd'][label] = dict(
                max_abs_err=fwd_err, **timed_call(
                    lambda: attention.flash_attention_with_lse(
                        q, k, v, causal=causal)),
                plain_ms=time_ms(lambda: attention._blockwise_attention(  # pylint: disable=protected-access
                    q, k, v, return_lse=True, **kw), iters=5, warmup=1),
                bound_ms=bound_ms, bound_by=bound_by, **fwd_sdpa)
        plain = time_ms(lambda: attention._flash_bwd_reference(  # pylint: disable=protected-access
            q, k, v, o, lse, g, g_lse, **kw), iters=5, warmup=1)
        for kname, fn, n_products, numel, err in (
                ('flash_bwd_dq', lambda: attention._flash_bwd_dq_cuda(  # pylint: disable=protected-access
                    q, k, v, g, lse, delta, **kw), 3, q.numel(),
                 errs['dq']),
                ('flash_bwd_dkv', lambda: attention._flash_bwd_dkv_cuda(  # pylint: disable=protected-access
                    q, k, v, g, lse, delta, **kw), 4, 2 * k.numel(),
                 max(errs['dk'], errs['dv']))):
            bound_ms, bound_by = bwd_bound(q, k, n_products, numel, causal)
            out[kname][label] = dict(max_abs_err=err, **timed_call(fn),
                                     plain_ms=plain, bound_ms=bound_ms,
                                     bound_by=bound_by, **bwd_sdpa)
        for kname in [k for k in out if label in out[k]]:
            r = out[kname][label]
            log(f'  {kname} at {name}: max_abs_err {r["max_abs_err"]:.3g}; '
                f'{kernel_summary(r)}'
                + ('; plain is dq + dkv' if kname != 'flash_fwd' else ''))
        del q, k, v, o, lse, g, g_lse, got, again, ref
        free_cuda()
    return out


# ------------------------------------------------------------ phase 4

# llama3-8b's 32 layers cut to 8 for every serving phase (4-5e): their
# windows spend most of a tick in host work that grows with depth.
SERVE_LAYERS = 8


def http_call(port, path, rid=None, body=None):
    """(status, echoed X-SkyTPU-Request-Id, body bytes) of a GET, or of
    a JSON POST when `body` is given."""
    from skypilot_tpu_torch.serve import http_protocol
    headers = {http_protocol.REQUEST_ID_HEADER: rid} if rid else {}
    data = None
    if body is not None:
        headers['Content-Type'] = 'application/json'
        data = json.dumps(body).encode()
    req = urllib.request.Request(f'http://127.0.0.1:{port}{path}',
                                 data=data, headers=headers)
    with urllib.request.urlopen(req, timeout=600) as resp:
        return (resp.status, resp.headers.get(
            http_protocol.REQUEST_ID_HEADER), resp.read())


def post(port, body):
    from skypilot_tpu_torch.serve import http_protocol
    status, _, raw = http_call(port, http_protocol.GENERATE, body=body)
    return status, json.loads(raw)


def prompt(seed, n, vocab):
    import torch
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, vocab, (n,), generator=gen).tolist()


def serve_over_http(server, vocab, new_tokens):
    """Concurrent /generate round, then a prefix-hit round."""
    from skypilot_tpu_torch.serve import http_protocol
    from skypilot_tpu_torch.serve import model_server
    port, stop = model_server.start_background(server)
    try:
        with urllib.request.urlopen(
                f'http://127.0.0.1:{port}{http_protocol.HEALTH}',
                timeout=60) as resp:
            health = json.loads(resp.read())
        if resp.status != 200 or health['status'] != 'ok':
            raise AssertionError(f'/health: {resp.status} {health}')
        lengths = [5, 37, 64, 100, 250, 700]
        bodies = [{'prompt_ids': [prompt(i, n, vocab)],
                   'max_new_tokens': new_tokens} for i, n in
                  enumerate(lengths)]
        bodies[2].update(temperature=0.8, top_k=40, seed=7)
        # Prefix hits: the 100- and 250-token prompts again, new tails.
        hits = [{'prompt_ids': [bodies[i]['prompt_ids'][0][:96] +
                                prompt(50 + i, 9, vocab)],
                 'max_new_tokens': new_tokens} for i in (3, 4)]
        results = [None] * len(bodies)

        def run(i):
            results[i] = post(port, bodies[i])
        t0 = time.perf_counter()
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        hit_results = [post(port, body) for body in hits]
    finally:
        stop()
    for (code, out), body in zip(results + hit_results, bodies + hits):
        toks = out['tokens']
        if code != 200 or len(toks) != 1 or len(toks[0]) != new_tokens:
            raise AssertionError(f'/generate {code}: {out}')
        if not all(0 <= t < vocab for t in toks[0]):
            raise AssertionError(f'out-of-vocab tokens: {toks}')
    n_tokens = new_tokens * len(bodies)
    return n_tokens / wall, wall


def int8_spec_parity(cfg, model, dev, new_tokens):
    from skypilot_tpu_torch.serve import batching_engine
    prompts = [prompt(100 + i, n, cfg.vocab_size)
               for i, n in enumerate([12, 60, 130, 333])]
    out = {}
    stats = {}
    for spec in (0, 4):
        engine = batching_engine.ContinuousBatchingEngine(
            cfg, model, max_len=1024, slots=8, kv_pages=1024,
            page_size=16, quantize_kv=True, spec_tokens=spec, device=dev)
        try:
            reqs = [engine.submit(p, new_tokens) for p in prompts]
            out[spec] = [r.result(timeout=600) for r in reqs]
            stats[spec] = engine.stats()
        finally:
            engine.stop()
    if out[0] != out[4]:
        raise AssertionError(f'int8 greedy spec-on != spec-off:\n'
                             f'{out[4]}\n{out[0]}')
    return stats[4]


def reference_check(dev):
    """Depth-2 f32 llama3-8b: GPU kernels vs the CPU plain versions."""
    import torch
    from skypilot_tpu_torch.models import configs
    from skypilot_tpu_torch.models import convert
    from skypilot_tpu_torch.models import decode
    from skypilot_tpu_torch.models.transformer import init_params
    from skypilot_tpu_torch.serve import batching_engine
    cfg = configs.get_config('llama3-8b', n_layers=2, dtype=torch.float32)
    gpu_model = init_params(cfg, seed=1, device=dev)
    cpu_model = convert.from_jax_params(
        cfg, convert.to_jax_params(gpu_model), device='cpu')
    prompts = [prompt(200, 12, cfg.vocab_size),
               prompt(201, 40, cfg.vocab_size)]
    toks = {}
    for mode, kv_pages in (('paged', 32), ('dense', None)):
        for device, model in (('gpu', gpu_model), ('cpu', cpu_model)):
            engine = batching_engine.ContinuousBatchingEngine(
                cfg, model, max_len=128, slots=2, kv_pages=kv_pages,
                page_size=16, device=model.device)
            try:
                toks[mode, device] = [engine.generate(p, 12)
                                      for p in prompts]
            finally:
                engine.stop()
        if toks[mode, 'gpu'] != toks[mode, 'cpu']:
            raise AssertionError(f'{mode}: GPU vs CPU greedy tokens '
                                 f'differ:\n{toks[mode, "gpu"]}\n'
                                 f'{toks[mode, "cpu"]}')
    p = torch.tensor([prompts[1]])
    gl, _ = decode.prefill(cfg, gpu_model, p.to(dev), max_len=64)
    cl, _ = decode.prefill(cfg, cpu_model, p, max_len=64)
    err = max_err(gl.cpu(), cl)
    if err > 1e-3:
        raise AssertionError(f'prefill logits GPU vs CPU: {err}')
    return err


# ---------------------------------------- phase 4, the observability plane


def family(parsed, name) -> float:
    """Sum of a parsed exposition family over its label sets."""
    return sum(parsed.get(name, {}).values())


def burst(engine, prompts, new_tokens):
    """Submit every prompt at once; (tokens, wall s, ticks) once the
    engine has read its last tick."""
    from skypilot_tpu_torch.serve import plane_check
    plane_check.settle(engine)
    ticks0 = engine.stats()['ticks']
    t0 = time.perf_counter()
    reqs = [engine.submit(p, new_tokens) for p in prompts]
    out = [list(r.result(timeout=600)) for r in reqs]
    wall = time.perf_counter() - t0
    plane_check.settle(engine)
    return out, wall, engine.stats()['ticks'] - ticks0


def route_window(server, dev, prompts, ids, new_tokens, counters):
    """One window of the plane on `server`, over HTTP with client-chosen
    request ids: /metrics (deltas equal the engine's own), /spans (one
    ordered engine segment per id), /profile (phases of the vocabulary,
    each tick's phases within its duration, the memory watermark within
    the allocator's peak), /logs (one access record per id).  The launch
    counts are zeroed just before the requests and read just after the
    route reads, so they are this window's own."""
    import torch
    from skypilot_tpu_torch.observability import metrics
    from skypilot_tpu_torch.observability import profiling
    from skypilot_tpu_torch.serve import http_protocol
    from skypilot_tpu_torch.serve import model_server
    from skypilot_tpu_torch.serve import plane_check
    engine = server.engine
    port, stop = model_server.start_background(server)
    try:
        plane_check.settle(engine)
        before = metrics.parse_exposition(
            http_call(port, http_protocol.METRICS)[2].decode())
        stats0 = engine.stats()
        replies = {}

        def run(p, rid):
            replies[rid] = http_call(port, http_protocol.GENERATE, rid, {
                'prompt_ids': [p], 'max_new_tokens': new_tokens})
        threads = [threading.Thread(target=run, args=(p, rid))
                   for p, rid in zip(prompts, ids)]
        zero_counts(counters)
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        plane_check.settle(engine)
        status, echoed, body = http_call(port, http_protocol.METRICS,
                                         f'{ids[0]}-scrape')
        after = metrics.parse_exposition(body.decode())
        stats1 = engine.stats()
        spans = {rid: json.loads(http_call(
            port, f'{http_protocol.SPANS}?request_id={rid}')[2])['segments']
                 for rid in ids}
        payload = json.loads(http_call(port, http_protocol.PROFILE)[2])
        peak = torch.cuda.max_memory_allocated(dev)
        records = {rid: json.loads(http_call(
            port, f'{http_protocol.LOGS}?request_id={rid}')[2])['records']
                   for rid in ids}
        launches = read_counts(counters)
    finally:
        stop()
    if status != 200 or echoed != f'{ids[0]}-scrape':
        raise AssertionError(f'/metrics {status}, echoed {echoed}')
    tokens = {}
    for rid in ids:
        code, echoed, body = replies[rid]
        if code != 200 or echoed != rid:
            raise AssertionError(f'/generate {rid}: {code}, echoed {echoed}')
        tokens[rid] = json.loads(body)['tokens'][0]
    for name, key in (('skytpu_engine_ticks_total', 'ticks'),
                      ('skytpu_engine_decode_tokens_total',
                       'tokens_generated')):
        grown = family(after, name) - family(before, name)
        if grown != stats1[key] - stats0[key]:
            raise AssertionError(f'/metrics {name} grew {grown}, the '
                                 f'engine counted {stats1[key] - stats0[key]}')
    ttft = (family(after, 'skytpu_engine_ttft_seconds_count') -
            family(before, 'skytpu_engine_ttft_seconds_count'))
    if ttft != len(ids):
        raise AssertionError(f'TTFT histogram grew {ttft}, not {len(ids)}')
    for rid in ids:
        engine_segs = [s for s in spans[rid] if s['name'] == 'engine']
        if len(engine_segs) != 1:
            raise AssertionError(f'/spans {rid}: {spans[rid]}')
        seg = engine_segs[0]
        phases = seg['phases']
        if (seg['status'] != 'ok' or seg['tokens'] != len(tokens[rid]) or
                seg['ttft_ms'] > seg['duration_ms'] or
                [p['name'] for p in phases] != ['queue', 'prefill',
                                                'decode']):
            raise AssertionError(f'/spans {rid}: {seg}')
        for p, nxt in zip(phases, phases[1:]):
            if p['start'] + p['duration_ms'] / 1e3 > nxt['start'] + 1e-5:
                raise AssertionError(f'/spans {rid}: phases overlap {phases}')
        access = [r for r in records[rid] if r['msg'].startswith('POST ')]
        if [r['msg'] for r in access] != [
                f'POST {http_protocol.GENERATE} -> 200']:
            raise AssertionError(f'/logs {rid}: {records[rid]}')
    prof = payload['profile']
    if not prof['enabled'] or not prof['ring']:
        raise AssertionError('/profile: empty ring')
    for rec in prof['ring']:
        names = {name for name, _, _ in rec['phases']}
        if not names <= set(profiling.PHASES):
            raise AssertionError(f'/profile: phases {names}')
        if sum(d for _, _, d in rec['phases']) > rec['dur_s'] + 1e-9:
            raise AssertionError(f'/profile: phases exceed the tick {rec}')
        if not 0 < rec['mem_bytes'] <= peak:
            raise AssertionError(f'/profile: mem_bytes {rec["mem_bytes"]} '
                                 f'against the peak {peak}')
    return {'launches': launches, 'profile': prof}


def page_balance(engine):
    """Phase 4's page journal (SKYTPU_SERVE_PAGE_EVENTS was set when the
    engine was made), replayed as the reference's `page_pool_balance`
    defines it: each `kv_pages_alloc` holds its pages until a
    `kv_pages_free` returns them, and no page is freed that is not held.
    Once every slot is released the pages still held must be the prefix
    cache's own.  -> (alloc records, free records, pages held)."""
    from skypilot_tpu_torch.observability import profiling
    wait_until(lambda: pages_in_slots(engine.stats()) == 0, 60,
               'slots released')
    held, counts = {}, {'kv_pages_alloc': 0, 'kv_pages_free': 0}
    for e in profiling.serve_journal().read():
        if e['event'] not in counts:
            continue
        counts[e['event']] += 1
        for p in e['pages']:
            n = held.get(p, 0) + (1 if e['event'] == 'kv_pages_alloc' else -1)
            if n < 0:
                raise AssertionError(f'page {p} freed without an alloc')
            held[p] = n
    held = sorted(p for p, n in held.items() if n > 0)
    cached = engine._kv.prefix.hot_entries(len(engine._kv.prefix))  # pylint: disable=protected-access
    if held != sorted(page for _, page in cached) or not counts[
            'kv_pages_free']:
        raise AssertionError(f'page journal: {counts}, held {held}, prefix '
                             f'cache {sorted(p for _, p in cached)}')
    return counts['kv_pages_alloc'], counts['kv_pages_free'], len(held)


def observability(server, dev, new_tokens, counters):
    """The plane on phase 4's full-width paged server (bf16 pool) and on
    a second server with an int8 pool over the same weights, one
    `route_window` each; then, in this thread on identical inputs, the
    wrapped step adds no device work (`plane_check`); then an engine
    with the plane off on the same weights gives the same tokens.  Times
    are printed, never held.  Returns the windows' launch counts under
    `launches`, by path."""
    import os
    import torch
    from skypilot_tpu_torch.serve import batching_engine
    from skypilot_tpu_torch.serve import model_server
    from skypilot_tpu_torch.serve import plane_check
    engine, cfg, vocab = server.engine, server.cfg, server.cfg.vocab_size
    lengths = (23, 77, 130, 300, 45, 200)
    prompts = [prompt(200 + i, n, vocab) for i, n in enumerate(lengths)]
    window = route_window(server, dev, prompts,
                          [f'chip-obs-{i}' for i in range(len(prompts))],
                          new_tokens, counters)
    int8_server = model_server.ModelServer(
        'llama3-8b', continuous_batching=True, kv_pages=1024,
        page_size=16, max_len=engine.max_len, max_batch=8,
        quantize_kv=True, device=dev, params=server.params,
        overrides={'n_layers': server.cfg.n_layers})
    try:
        int8_window = route_window(
            int8_server, dev, prompts,
            [f'chip-obs-int8-{i}' for i in range(len(prompts))],
            new_tokens, counters)
    finally:
        int8_server.close()
    del int8_server
    prof = window['profile']
    laps = sum(agg['count'] for agg in prof['phases'].values())
    ring_bytes = len(json.dumps(prof['ring']))
    durs = sorted(rec['dur_s'] * 1e3 for rec in prof['ring'])

    tick_tokens = torch.tensor(
        [prompts[2][:128]], dtype=torch.int32, device=dev)
    work = plane_check.same_device_work(engine, tick_tokens)

    os.environ['SKYTPU_PROFILE_DISABLE'] = '1'
    try:
        off = batching_engine.ContinuousBatchingEngine(
            cfg, server.params, max_len=engine.max_len, slots=8,
            kv_pages=1024, page_size=16, device=dev)
    finally:
        del os.environ['SKYTPU_PROFILE_DISABLE']
    host_ms = {True: [], False: []}
    try:
        if off.profile()['enabled']:
            raise AssertionError('SKYTPU_PROFILE_DISABLE left the plane on')
        # Each prompt set is new to both engines (no prefix hit); the
        # order alternates: off, on, on, off.
        sets = [[prompt(300 + 10 * k + i, n, vocab)
                 for i, n in enumerate(lengths)] for k in range(2)]
        outs = {}
        for k, plane in ((0, False), (0, True), (1, True), (1, False)):
            outs[k, plane], wall, n_ticks = burst(
                engine if plane else off, sets[k], new_tokens)
            host_ms[plane].append(wall * 1e3 / n_ticks)
    finally:
        off.stop()
    for k in range(2):
        if outs[k, True] != outs[k, False]:
            raise AssertionError(f'prompt set {k}: the engine with the '
                                 'plane off gave other tokens than on')
    sentinel = prof['recompiles']
    int8_prof = int8_window['profile']
    return {
        'launches': {'observability': window['launches'],
                     'observability (int8 pool)': int8_window['launches']},
        'ticks': prof['ticks'], 'ring': len(prof['ring']),
        'int8_ticks': int8_prof['ticks'], 'int8_ring': len(int8_prof['ring']),
        'tick_ms_p50': durs[len(durs) // 2], 'tick_ms_min': durs[0],
        'tick_ms_max': durs[-1],
        'phases': {n: round(a['total_s'] * 1e3, 3)
                   for n, a in prof['phases'].items()},
        'overhead_ms': prof['overhead_s'] * 1e3,
        'per_lap_us': prof['overhead_s'] / laps * 1e6,
        'laps_per_tick': laps / prof['ticks'],
        'ring_bytes_per_tick': ring_bytes / len(prof['ring']),
        'ring_ticks': prof['ring_ticks'],
        'mem_watermark_gib': prof['device_memory']['watermark_bytes'] / 2**30,
        'recompiles': {n: (f['calls'], f['compiles'],
                           f['steady_recompiles'])
                       for n, f in sentinel['fns'].items() if f['calls']},
        'work': work, 'host_ms_on': host_ms[True],
        'host_ms_off': host_ms[False]}


# ------------------------------------------------- phase 5: more serving


def post_raw(port, path, body):
    """POST a JSON body; (status, raw response body)."""
    status, _, raw = http_call(port, path, body=body)
    return status, raw


def sse_events(raw: bytes) -> list:
    return [line[len(b'data: '):].decode() for line in raw.split(b'\n')
            if line.startswith(b'data: ')]


def path_logits(cfg, model, ids, use_flash, quantize=False):
    """Logits [len(ids), V] of one forward of `ids` from position 0,
    attention by the flash kernel (`use_flash`) or the masked grouped
    einsum; with `quantize`, every k/v goes through the int8 pool's
    quantizer and back before attention reads it."""
    import torch
    from skypilot_tpu_torch.models import decode
    s = len(ids)
    tokens = torch.tensor([ids], device=model.device)
    cache = decode.init_cache(cfg, 1, s, device=model.device, model=model)

    def write(c, new):
        if quantize:
            q, scale = decode._quant_kv(new)  # pylint: disable=protected-access
            new = q.float() * scale[..., None]
        c[:, :, :s] = new.to(c.dtype)

    with torch.no_grad():
        logits, _, _ = decode._scan_layers_and_unembed(  # pylint: disable=protected-access
            cfg, model, decode._embed(cfg, model, tokens),  # pylint: disable=protected-access
            torch.arange(s, device=tokens.device), cache['k'], cache['v'],
            write, use_flash=use_flash, all_positions=True)
    return logits[0].float()


# A tensor model's logits against the tensor-1 model's on the same
# context: max |A_tp - A_1| over the generated positions and the
# vocabulary, at most this many times tensor-1's own flash-vs-masked
# delta (phase 5e; PERF.md gives a sound run's reading and a planted
# fault's).
DRIFT_LIMIT = 4.0


def hold_tokens(what, cfg, model, prompt_ids, got, ref, quantized=False,
                one=None, drift_limit=DRIFT_LIMIT):
    """Greedy tokens `got`, each held at its own context (teacher
    forcing): under the logits A of one flash forward of prompt + got,
    every got[j] is A's argmax at its position or within 2 delta of it,
    delta being the largest |A - B| over the generated positions and the
    vocabulary, B the same forward's logits through the masked einsum
    (two exact paths of one function: either path's bf16 rounding moves
    a logit by about delta).  With `quantized` (an int8 pool) B's k/v go
    through the pool's quantizer, so delta holds its effect too.  `ref`,
    the reference path's tokens, says where the two part.  With `one`
    (the tensor-1 model of a tensor `model`), A is also held to one's
    flash logits A1 on the same context: max |A - A1| at most
    `drift_limit` (DRIFT_LIMIT; None: printed, not held) times delta1,
    one's own max |A1 - B1| (`tensor_drift`).
    Returns (first j where got and ref part or None, tokens that are
    not A's argmax, the largest gap, delta), with `one` also (drift,
    delta1)."""
    import torch
    if len(got) != len(ref):
        raise AssertionError(f'{what}: {len(got)} tokens, reference '
                             f'{len(ref)}')
    n = len(prompt_ids)
    ids = list(prompt_ids) + list(got[:-1])
    a = path_logits(cfg, model, ids, use_flash=True)[n - 1:]
    b = path_logits(cfg, model, ids, use_flash=False,
                    quantize=quantized)[n - 1:]
    delta = float((a - b).abs().max())
    picked = a.gather(1, torch.tensor(got, device=a.device)[:, None])[:, 0]
    gaps = a.max(dim=1).values - picked
    worst = float(gaps.max())
    if worst > 2 * delta:
        j = int(gaps.argmax())
        raise AssertionError(
            f'{what}: token {j} is {got[j]}, {worst:.4f} below the best '
            f'logit ({int(a[j].argmax())}) > 2 x path difference '
            f'{delta:.3g}')
    parted = next((j for j, (x, y) in enumerate(zip(got, ref)) if x != y),
                  None)
    out = (parted, int((gaps > 0).sum()), worst, delta)
    if one is None:
        return out
    del b
    drift, delta1 = tensor_drift(cfg, one, ids, n, a)
    if drift_limit is not None and drift > drift_limit * delta1:
        raise AssertionError(
            f'{what}: logits {drift:.4f} from the tensor-1 model\'s > '
            f'{drift_limit:g} x its flash-vs-masked delta {delta1:.3g}')
    return out + (drift, delta1)


def tensor_drift(cfg, one, ids, n, a):
    """(max |a - A1|, delta1): `a` a tensor model's flash logits at
    positions n - 1.. of `ids`, A1 and B1 the tensor-1 model `one`'s
    flash and masked logits there, delta1 = max |A1 - B1|."""
    a1 = path_logits(cfg, one, ids, use_flash=True)[n - 1:]
    drift = float((a - a1).abs().max())
    b1 = path_logits(cfg, one, ids, use_flash=False)[n - 1:]
    return drift, float((a1 - b1).abs().max())


def hold_summary(holds, drift_held=True) -> str:
    equal = sum(1 for h in holds if h[0] is None)
    parted = [h[0] for h in holds if h[0] is not None]
    drift = ''
    if all(len(h) == 6 for h in holds):  # against tensor 1
        drift = (f'; logits vs tensor 1 at most {max_drift(holds):.3g} x '
                 f'its delta (' + (f'limit {DRIFT_LIMIT:g}' if drift_held
                                   else 'printed, not held') +
                 f'; largest {max(h[4] for h in holds):.3g})')
    return (f'{equal}/{len(holds)} equal to the reference path'
            + (f' (others part at tokens {parted})' if parted else '')
            + f'; all {len(holds)} held token by '
            f'token: {sum(h[1] for h in holds)} not the flash argmax, '
            f'largest gap {max(h[2] for h in holds):.3g} (2 delta >= '
            f'{2 * min(h[3] for h in holds):.3g})' + drift)


def max_drift(holds) -> float:
    """The largest drift / delta1 of holds made with a tensor-1 model."""
    return max(h[4] / h[5] for h in holds)


def dense_serving(cfg, model, dev, new_tokens):
    """ModelServer in the reference's default mode (continuous batching,
    no --kv-pages) over HTTP: 6 concurrent /generate requests,
    /generate_stream and /generate_text.  Engine work only: the greedy
    tokens are held after the window (`hold_dense`)."""
    from skypilot_tpu_torch.serve import http_protocol
    from skypilot_tpu_torch.serve import model_server
    server = model_server.ModelServer(
        'llama3-8b', continuous_batching=True, max_len=1024, max_batch=8,
        params=model, device=dev, overrides={'n_layers': cfg.n_layers})
    vocab = cfg.vocab_size
    prompts = [prompt(500 + i, n, vocab)
               for i, n in enumerate([5, 37, 64, 100, 250, 700])]
    port, stop = model_server.start_background(server)
    try:
        if server.engine.stats()['decode_kernel'] != 'dense':
            raise AssertionError('the server is not in dense mode')
        results = [None] * len(prompts)

        def run(i):
            results[i] = post(port, {'prompt_ids': [prompts[i]],
                                     'max_new_tokens': new_tokens})
        t0 = time.perf_counter()
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        req = server.engine.submit(prompt(9, 100, vocab), new_tokens)
        req.result(timeout=600)
        ttft_ms = req.ttft_s * 1e3
        code, raw = post_raw(port, http_protocol.GENERATE_STREAM, {
            'prompt_ids': [prompts[1]], 'max_new_tokens': new_tokens})
        events = sse_events(raw)
        streamed = [json.loads(e)['token'] for e in events[:-1]]
        if code != 200 or events[-1] != '[DONE]':
            raise AssertionError(f'/generate_stream {code}: {events[-3:]}')
        text = {}
        for stream in (False, True):
            code, raw = post_raw(port, http_protocol.GENERATE_TEXT, {
                'prompt': 'The quick brown fox jumps over the lazy dog',
                'max_new_tokens': 16, 'stream': stream})
            if code != 200:
                raise AssertionError(f'/generate_text {code}: {raw[:200]}')
            text[stream] = (''.join(json.loads(e)['text']
                                    for e in sse_events(raw)[:-1])
                            if stream else json.loads(raw)['completion'])
        stats = server.engine.stats()
    finally:
        stop()
        server.close()
    tokens = []
    for (code, out), p in zip(results, prompts):
        if code != 200 or len(out['tokens'][0]) != new_tokens:
            raise AssertionError(f'/generate {code}: {out}')
        tokens.append(out['tokens'][0])
    if streamed != tokens[1]:
        raise AssertionError(f'/generate_stream {streamed} != /generate '
                             f'{tokens[1]}')
    if text[True] != text[False]:
        raise AssertionError(f'/generate_text stream {text[True]!r} != '
                             f'{text[False]!r}')
    return {'tokens_per_s': new_tokens * len(prompts) / wall, 'wall': wall,
            'ttft_ms': ttft_ms, 'ticks': stats['ticks'], 'prompts': prompts,
            'tokens': tokens}


def hold_dense(cfg, model, dense, new_tokens):
    """The dense engine's greedy tokens, held with decode.generate's as
    the reference path."""
    import torch
    from skypilot_tpu_torch.models import decode
    holds = []
    for p, got in zip(dense['prompts'], dense['tokens']):
        _, ref = decode.generate(cfg, model,
                                 torch.tensor([p], device=model.device),
                                 max_new_tokens=new_tokens, max_len=1024)
        holds.append(hold_tokens('dense engine vs decode.generate', cfg,
                                 model, p, got, ref[0].tolist()))
    return holds


def legacy_serving(cfg, model, dev, new_tokens, dense):
    """pipelined=False on the same model and prompts.  Engine work only:
    the tokens are held after the window, with the dense pipelined
    engine's as the reference path."""
    from skypilot_tpu_torch.serve import batching_engine
    engine = batching_engine.ContinuousBatchingEngine(
        cfg, model, max_len=1024, slots=8, pipelined=False, device=dev)
    try:
        t0 = time.perf_counter()
        reqs = [engine.submit(p, new_tokens) for p in dense['prompts']]
        got = [r.result(timeout=600) for r in reqs]
        wall = time.perf_counter() - t0
    finally:
        engine.stop()
    return {'tokens_per_s': new_tokens * len(got) / wall, 'tokens': got}


def spec_past_one_bucket(cfg, model, dev, new_tokens, counters):
    """int8 + spec at 16 slots, k = 4: the verify tick has 80 rows, past
    one 64-row bucket.  Greedy tokens must equal spec-off's.  Returns
    (the launch counts of the spec-on run alone, its stats)."""
    from skypilot_tpu_torch.serve import batching_engine
    prompts = [prompt(600 + i, 12 + 21 * i, cfg.vocab_size)
               for i in range(16)]
    out, stats = {}, {}
    zero_counts(counters)
    for spec in (4, 0):
        engine = batching_engine.ContinuousBatchingEngine(
            cfg, model, max_len=1024, slots=16, kv_pages=1024,
            page_size=16, quantize_kv=True, spec_tokens=spec, device=dev)
        try:
            reqs = [engine.submit(p, new_tokens) for p in prompts]
            out[spec] = [r.result(timeout=600) for r in reqs]
            stats[spec] = engine.stats()
        finally:
            engine.stop()
        if spec:
            counts = read_counts(counters)
    if out[0] != out[4]:
        bad = [i for i, (a, b) in enumerate(zip(out[0], out[4])) if a != b]
        raise AssertionError(f'16 slots, k = 4: greedy spec-on != spec-off '
                             f'for prompts {bad}')
    return counts, stats[4]


def verify_tick_cost(cfg, model, dev):
    """Device and host ms of one int8 verify tick at 16 slots, k = 4
    (80 rows, two 64-row blocks), and of the same tick run as one call
    on the 128 padded rows (the blocks switched off for this timing):
    what the row blocks cost."""
    import torch
    from skypilot_tpu_torch.models import decode
    slots, k, ps, rows = 16, 4, 16, 64
    pool = decode.init_paged_cache(cfg, 1 + slots * rows, ps, slots, rows,
                                   quantize_kv=True, device=dev)
    for slot in range(slots):
        decode.paged_admit_slot(
            pool, slot, list(range(1 + slot * rows, 1 + (slot + 1) * rows)),
            5 + 45 * slot)
    state = decode.init_engine_state(slots, device=dev)
    for slot in range(slots):
        state = decode.admit_slot_state(state, slot, 1 + slot, 10 ** 6,
                                        [-1] * 16, [slot, 0], 0.0, 0)
    drafts = torch.randint(0, cfg.vocab_size, (slots, k), device=dev,
                           dtype=torch.int32)

    def tick():
        decode.paged_spec_engine_step(cfg, model, state, pool, drafts)

    with torch.no_grad():
        blocked = timed_call(tick)
        by_blocks = decode._by_blocks  # pylint: disable=protected-access
        decode._by_blocks = lambda fn, x, blocked: fn(x)  # pylint: disable=protected-access
        try:
            one_call = timed_call(tick)
        finally:
            decode._by_blocks = by_blocks  # pylint: disable=protected-access
    return blocked, one_call


def tickets_at_zero(engines):
    """Every ticket counter reads 0, and the engines' streams each had
    their own."""
    import torch
    from skypilot_tpu_torch.ops import paged_attention
    torch.cuda.synchronize()
    tickets = paged_attention._TICKETS  # pylint: disable=protected-access
    for key, counters in tickets.items():
        if int(counters.count_nonzero()):
            raise AssertionError(f'ticket counters {key} not at 0')
    keys = {(e.stream.device, e.stream.cuda_stream) for e in engines}
    if len(keys) != len(engines) or not keys <= set(tickets):
        raise AssertionError('the engines did not count in a ticket array '
                             'of their own stream each')


def handoff(cfg, model, dev, new_tokens, counters):
    """Prefill/decode disaggregation on one card: a prefill engine (paged
    bf16) exports a 100-token prompt through the binary frame; a decode
    engine (paged bf16, then an int8 pool) imports it and generates.
    Returns (the launch counts of that window, results).  Then, outside
    the window, each decode engine serves the prompt again while a
    single engine of its pool type serves it at once, each engine on its
    own CUDA stream: the decode engine's tokens must equal its window's,
    and every ticket counter must read 0 after."""
    from skypilot_tpu_torch.serve import batching_engine
    from skypilot_tpu_torch.serve import handoff as handoff_lib
    kw = dict(max_len=1024, slots=8, kv_pages=1024, page_size=16,
              device=dev)
    pools = {'bf16': False, 'int8': True}
    p = prompt(700, 100, cfg.vocab_size)
    engines = []

    def engine(**extra):
        engines.append(batching_engine.ContinuousBatchingEngine(
            cfg, model, **kw, **extra))
        return engines[-1]

    try:
        prefill_engine = engine()
        decode_engines = {pool: engine(quantize_kv=q)
                          for pool, q in pools.items()}
        singles = {'bf16': prefill_engine, 'int8': engine(quantize_kv=True)}
        out = {}
        zero_counts(counters)
        for pool, decode_engine in decode_engines.items():
            before = read_counts(counters)
            t0 = time.perf_counter()
            frame = prefill_engine.export_prefill(p, binary=True)
            export_ms = (time.perf_counter() - t0) * 1e3
            exported = read_counts(counters)
            decoded = handoff_lib.decode_binary(frame)
            t0 = time.perf_counter()
            got = decode_engine.import_pages(
                decoded['hashes'], decoded['page_size'], decoded['k'],
                decoded['v'])
            import_ms = (time.perf_counter() - t0) * 1e3
            if got != (6, 0):
                raise AssertionError(f'import: {got}, expected (6, 0)')
            via = decode_engine.generate(p, new_tokens)
            if decode_engine.stats()['prefix_cache_hits'] < 6:
                raise AssertionError('the import was not adopted')
            after = read_counts(counters)
            out[pool] = dict(
                via=via, frame_bytes=len(frame), export_ms=export_ms,
                import_ms=import_ms,
                export_launches={k: exported[k] - before[k]
                                 for k in before},
                import_launches={k: after[k] - exported[k] for k in before})
        counts = read_counts(counters)
        for pool, decode_engine in decode_engines.items():
            # One round of two engines' ticks on two streams at once.
            reqs = [decode_engine.submit(p, new_tokens),
                    singles[pool].submit(p, new_tokens)]
            again, ref = [r.result(timeout=600) for r in reqs]
            tickets_at_zero([decode_engine, singles[pool]])
            if again != out[pool]['via']:
                raise AssertionError(f'handoff ({pool} pool): the decode '
                                     'engine beside a second stream gave '
                                     'other tokens than alone')
            out[pool]['hold'] = hold_tokens(
                f'handoff ({pool} pool) vs one engine', cfg, model, p,
                out[pool]['via'], ref, quantized=pools[pool])
    finally:
        for e in engines:
            e.stop()
    return counts, out


# ------------------------------------------ phase 5: the replica front


BATCH_BUDGET = 8         # the batch class's max_new_tokens in this phase
FRONT_STREAMS = (5, 37, 64, 100, 250)
BUDGET_PROMPT = 24       # tokens; under the decode budget, 1 a piece


def http_post(port, path, body, headers=None):
    """(status, response headers, body bytes) of a JSON POST."""
    import http.client
    conn = http.client.HTTPConnection('127.0.0.1', port, timeout=600)
    try:
        conn.request('POST', path, body=json.dumps(body).encode(),
                     headers=dict({'Content-Type': 'application/json'},
                                  **(headers or {})))
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def open_stream(port, body, rid):
    """A socket that has sent one /generate_stream request."""
    import socket
    data = json.dumps(body).encode()
    sock = socket.create_connection(('127.0.0.1', port), timeout=600)
    sock.sendall(f'POST /generate_stream HTTP/1.1\r\nHost: x\r\n'
                 f'Content-Type: application/json\r\n'
                 f'Content-Length: {len(data)}\r\n'
                 f'X-SkyTPU-Request-Id: {rid}\r\n'
                 f'Connection: close\r\n\r\n'.encode() + data)
    return sock


def read_events(sock, raw, until):
    """Read the stream until `until(events)` holds or the socket ends;
    returns (raw bytes, SSE events)."""
    while not until(sse_events(raw)):
        chunk = sock.recv(65536)
        if not chunk:
            break
        raw += chunk
    return raw, sse_events(raw)


def stream_tokens(events) -> list:
    if not events or events[-1] != '[DONE]':
        raise AssertionError(f'stream did not end with [DONE]: {events[-3:]}')
    return [json.loads(e)['token'] for e in events[:-1]]


def wait_until(predicate, timeout, what):
    deadline = time.monotonic() + timeout
    while not predicate():
        if time.monotonic() > deadline:
            raise AssertionError(f'{what}: not within {timeout} s')
        time.sleep(0.02)


def pages_in_slots(stats) -> int:
    """Pages held beyond the prefix cache's pinned ones."""
    return stats['kv_pages_used'] - stats['kv_pages_pinned']


def replica_front(cfg, model, dev, counters, new_tokens):
    """The replica front at llama3-8b on phase 4's weights: a paged
    server behind the asyncio front (`async_server.start_background`).
    The window, zeroed just before and read just after its engine work:
    greedy /generate (its TTFT), 5 concurrent /generate_stream
    (tokens/s), a batch-class request (SKYTPU_QOS_SPEC gives the class
    max_new_tokens BATCH_BUDGET), /role_budget decode then a 24-token
    prompt (a B3 chunk 0 of one token at the 16 bucket, then width-1
    continuations) then mixed, /drain with a stream in flight (/generate
    503 + Retry-After, the stream finishes), and a stream whose client
    hangs up after two events (busy slots and slot pages back to their
    baseline, the span 'cancelled').  After the window, the threaded
    front of a second server on the same weights serves the same
    prompts, new to it, unclamped: /generate, the streams and the drain
    stream must give its tokens; the batch request its first
    BATCH_BUDGET; the decode-budget prompt its tokens, or else each
    token held at its own context (its pieces ran the masked path where
    the reference's one prefill ran the flash kernel).  Returns (launch
    counts, printed numbers)."""
    import os
    from skypilot_tpu_torch.serve import async_server
    from skypilot_tpu_torch.serve import http_protocol
    from skypilot_tpu_torch.serve import model_server
    vocab = cfg.vocab_size
    kw = dict(continuous_batching=True, kv_pages=1024, page_size=16,
              max_len=1024, max_batch=8, params=model, device=dev,
              overrides={'n_layers': cfg.n_layers})
    single = prompt(800, 40, vocab)
    streams = [prompt(801 + i, n, vocab)
               for i, n in enumerate(FRONT_STREAMS)]
    batch_p = prompt(810, 60, vocab)
    budget_p = prompt(811, BUDGET_PROMPT, vocab)
    drain_p = prompt(812, 30, vocab)
    gone_p = prompt(813, 50, vocab)
    qos_header = {http_protocol.QOS_CLASS_HEADER: 'batch'}
    t_phase = time.perf_counter()
    os.environ['SKYTPU_QOS_SPEC'] = json.dumps(
        {'batch': {'max_new_tokens': BATCH_BUDGET}})
    got = {}
    try:
        server = model_server.ModelServer('llama3-8b', **kw)
        engine = server.engine
        port, stop = async_server.start_background(server)
        try:
            zero_counts(counters)
            t0 = time.perf_counter()
            code, _, raw = http_post(port, http_protocol.GENERATE, {
                'prompt_ids': [single], 'max_new_tokens': new_tokens},
                {http_protocol.REQUEST_ID_HEADER: 'front-1'})
            if code != 200:
                raise AssertionError(f'/generate {code}: {raw[:200]}')
            got['single'] = json.loads(raw)['tokens'][0]
            generate_s = time.perf_counter() - t0
            results = [None] * len(streams)

            def run(i):
                results[i] = http_post(port, http_protocol.GENERATE_STREAM, {
                    'prompt_ids': [streams[i]], 'max_new_tokens': new_tokens})
            t0 = time.perf_counter()
            threads = [threading.Thread(target=run, args=(i,))
                       for i in range(len(streams))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(600)
            streams_s = time.perf_counter() - t0
            got['streams'] = []
            for code, headers, raw in results:
                if code != 200 or headers.get('Content-Type') != \
                        'text/event-stream':
                    raise AssertionError(f'/generate_stream {code}')
                got['streams'].append(stream_tokens(sse_events(raw)))
            code, _, raw = http_post(port, http_protocol.GENERATE, {
                'prompt_ids': [batch_p], 'max_new_tokens': new_tokens},
                qos_header)
            got['batch'] = json.loads(raw)['tokens'][0]
            code, _, raw = http_post(port, http_protocol.ROLE_BUDGET,
                                     {'role': 'decode', 'version': 1})
            budget = json.loads(raw)
            if code != 200 or not budget['applied'] or \
                    budget['budget']['prefill_tokens'] != 1:
                raise AssertionError(f'/role_budget decode: {budget}')
            chunks0 = engine.stats()['prefill_chunks']
            t0 = time.perf_counter()
            code, _, raw = http_post(port, http_protocol.GENERATE, {
                'prompt_ids': [budget_p], 'max_new_tokens': 16})
            budget_s = time.perf_counter() - t0
            got['budget'] = json.loads(raw)['tokens'][0]
            budget_chunks = engine.stats()['prefill_chunks'] - chunks0
            if budget_chunks != BUDGET_PROMPT - 1:
                raise AssertionError(f'decode budget: {budget_chunks} '
                                     f'prefill pieces for {BUDGET_PROMPT} '
                                     f'tokens, expected {BUDGET_PROMPT - 1}')
            code, _, raw = http_post(port, http_protocol.ROLE_BUDGET,
                                     {'role': 'mixed', 'version': 2})
            if code != 200 or not json.loads(raw)['morphed']:
                raise AssertionError(f'/role_budget mixed: {raw[:200]}')
            # /drain while a stream is in flight.
            sock = open_stream(port, {'prompt_ids': [drain_p],
                                      'max_new_tokens': new_tokens},
                               'front-drain')
            raw, _ = read_events(sock, b'', lambda ev: len(ev) >= 1)
            code, _, body = http_post(port, http_protocol.DRAIN, {})
            if code != 200 or not json.loads(body)['draining']:
                raise AssertionError(f'/drain {code}: {body[:200]}')
            refused = http_post(port, http_protocol.GENERATE, {
                'prompt_ids': [single], 'max_new_tokens': 4})
            if refused[0] != 503 or 'Retry-After' not in refused[1]:
                raise AssertionError(f'draining /generate: {refused[0]} '
                                     f'{refused[1]}')
            raw, events = read_events(sock, raw,
                                      lambda ev: ev[-1:] == ['[DONE]'])
            sock.close()
            got['drain'] = stream_tokens(events)
            code, _, raw = http_post(port, http_protocol.ROLE_BUDGET, {
                'role': 'mixed', 'resume': True, 'version': 3})
            if code != 200 or json.loads(raw)['draining']:
                raise AssertionError(f'resume: {raw[:200]}')
            # A client that hangs up after two events.
            base = engine.stats()
            sock = open_stream(port, {'prompt_ids': [gone_p],
                                      'max_new_tokens': 600}, 'front-gone')
            read_events(sock, b'', lambda ev: len(ev) >= 2)
            sock.close()
            t0 = time.perf_counter()
            wait_until(lambda: engine.span('front-gone') is not None, 120,
                       'the hung-up stream finishing')
            wait_until(lambda: engine.stats()['busy_slots'] == 0 and
                       pages_in_slots(engine.stats()) ==
                       pages_in_slots(base), 120,
                       'slots and pages back to their baseline')
            freed_s = time.perf_counter() - t0
            gone = engine.span('front-gone')
            counts = read_counts(counters)
            if gone['status'] != 'cancelled' or gone['tokens'] >= 600:
                raise AssertionError(f'hung-up stream: {gone}')
            ttft_ms = engine.span('front-1')['ttft_ms']
            sentinel = engine.profile()['recompiles']
        finally:
            stop()
            server.close()
        del server, engine
        # The threaded front of a second server: the reference path.
        ref_server = model_server.ModelServer('llama3-8b', **kw)
        ref_port, ref_stop = model_server.start_background(ref_server)
        try:
            def ref_tokens(p, n):
                code, _, raw = http_post(ref_port, http_protocol.GENERATE,
                                         {'prompt_ids': [p],
                                          'max_new_tokens': n})
                if code != 200:
                    raise AssertionError(f'threaded /generate {code}')
                return json.loads(raw)['tokens'][0]
            ref = {'single': ref_tokens(single, new_tokens),
                   'streams': [ref_tokens(p, new_tokens) for p in streams],
                   'batch': ref_tokens(batch_p, new_tokens),
                   'budget': ref_tokens(budget_p, 16),
                   'drain': ref_tokens(drain_p, new_tokens)}
        finally:
            ref_stop()
            ref_server.close()
    finally:
        os.environ.pop('SKYTPU_QOS_SPEC', None)
    for key in ('single', 'streams', 'drain'):
        if got[key] != ref[key]:
            raise AssertionError(f'replica front {key}: async {got[key]} '
                                 f'!= threaded {ref[key]}')
    if got['batch'] != ref['batch'][:BATCH_BUDGET]:
        raise AssertionError(f'batch class: {got["batch"]} != the first '
                             f'{BATCH_BUDGET} of {ref["batch"]}')
    hold = (None if got['budget'] == ref['budget'] else
            hold_tokens('decode budget vs unclamped', cfg, model, budget_p,
                        got['budget'], ref['budget']))
    n_stream_tokens = sum(len(t) for t in got['streams'])
    return counts, dict(
        wall_s=time.perf_counter() - t_phase, generate_s=generate_s, ttft_ms=ttft_ms,
        streams_tokens_per_s=n_stream_tokens / streams_s,
        streams_s=streams_s, budget_s=budget_s, freed_s=freed_s,
        gone_tokens=gone['tokens'], budget_hold=hold,
        sentinel={n: (f['calls'], f['compiles'], f['steady_recompiles'])
                  for n, f in sentinel['fns'].items()
                  if n in ('prefill', 'prefill_chunk', 'step')})


# ------------------------------------------- phase 5b: real weights

REAL_LENGTHS = (5, 37, 64, 100, 250, 700)


def weight_bytes(model) -> int:
    """Bytes of every leaf of a model: parameters and buffers (an int8
    kernel's qvalue and scale)."""
    return sum(t.numel() * t.element_size() for t in
               list(model.parameters()) + list(model.buffers()))


def greedy_burst(server, bodies):
    """POST every body to /generate at once through the server's threaded
    front; -> (each body's greedy tokens, wall seconds)."""
    from skypilot_tpu_torch.serve import model_server
    port, stop = model_server.start_background(server)
    results = [None] * len(bodies)

    def run(i):
        results[i] = post(port, bodies[i])
    try:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
    finally:
        stop()
    tokens = []
    for (code, out), body in zip(results, bodies):
        if code != 200 or len(out['tokens'][0]) != body['max_new_tokens']:
            raise AssertionError(f'/generate {code}: {out}')
        tokens.append(out['tokens'][0])
    return tokens, wall


def quantize_card_vs_cpu(dev):
    """quantize_params over a depth-1, full-width llama3-8b f32 tree on
    the card and the same call on the CPU: equal bytes, leaf for leaf."""
    import torch
    from skypilot_tpu_torch.models import configs
    from skypilot_tpu_torch.models import convert
    from skypilot_tpu_torch.models import quantize
    from skypilot_tpu_torch.models.transformer import init_params
    cfg = configs.get_config('llama3-8b', n_layers=1, dtype=torch.float32)
    tree = convert.param_tree(init_params(cfg, seed=11, device=dev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on_card = quantize.quantize_params(tree)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    host = convert._map_tree(lambda t: t.cpu(), tree)  # pylint: disable=protected-access
    del tree
    t0 = time.perf_counter()
    on_host = quantize.quantize_params(host)
    host_s = time.perf_counter() - t0
    leaves = n_int8 = 0

    def walk(a, b, path):
        nonlocal leaves, n_int8
        if isinstance(b, dict):
            if sorted(a) != sorted(b):
                raise AssertionError(f'quantize card vs CPU: keys at {path}')
            for k in b:
                walk(a[k], b[k], f'{path}/{k}')
            return
        if a.dtype != b.dtype or not torch.equal(a.cpu(), b):
            raise AssertionError(
                f'quantize on the card != CPU at {path}: '
                f'{int((a.cpu() != b).sum())} of {b.numel()} differ')
        leaves += 1
        n_int8 += b.dtype == torch.int8
    walk(on_card, on_host, '')
    if n_int8 != 8:
        raise AssertionError(f'{n_int8} int8 leaves in a depth-1 tree')
    return {'leaves': leaves, 'int8_leaves': n_int8, 'card_s': card_s,
            'host_s': host_s}


def int8_weights(dev, counters, new_tokens):
    """The int8-weight server at full width, SERVE_LAYERS deep: its
    weights' bytes beside bf16's, the greedy burst held to the dequantized bf16 model's
    tokens (computed once, `convert.dequantize_model`), the int8 and
    bf16 ticks timed.  Launches are read around the server's engine work
    alone."""
    import torch
    from skypilot_tpu_torch import profile_decode
    from skypilot_tpu_torch.models import configs
    from skypilot_tpu_torch.models import convert
    from skypilot_tpu_torch.models.transformer import Transformer
    from skypilot_tpu_torch.serve import model_server
    cfg = configs.get_config('llama3-8b', n_layers=SERVE_LAYERS)
    kw = dict(continuous_batching=True, kv_pages=1024, page_size=16,
              max_len=1024, max_batch=8, device=dev,
              overrides={'n_layers': SERVE_LAYERS})
    bodies = [{'prompt_ids': [prompt(300 + i, n, cfg.vocab_size)],
               'max_new_tokens': new_tokens}
              for i, n in enumerate(REAL_LENGTHS)]
    zero_counts(counters)
    t0 = time.perf_counter()
    server = model_server.ModelServer('llama3-8b', quantize='int8', seed=0,
                                      **kw)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    try:
        tokens, wall = greedy_burst(server, bodies)
    finally:
        server.close()
    launches = read_counts(counters)
    q8 = server.params
    del server
    out = {'init_s': init_s, 'tokens_per_s': new_tokens * len(bodies) / wall,
           'int8_gib': weight_bytes(q8) / 2**30,
           'bf16_gib': weight_bytes(Transformer(cfg, device='meta')) / 2**30}
    fp = convert.dequantize_model(q8)
    free_cuda()
    reference = model_server.ModelServer('llama3-8b', params=fp, **kw)
    try:
        ref_tokens, _ = greedy_burst(reference, bodies)
    finally:
        reference.close()
    del reference
    if tokens != ref_tokens:
        parted = [i for i, (a, b) in enumerate(zip(tokens, ref_tokens))
                  if a != b]
        raise AssertionError(f'int8 weights: greedy tokens of prompts '
                             f'{parted} differ from the dequantized bf16 '
                             f'model\'s')
    out['tick'] = {name: profile_decode.profile_tick(cfg, model, dev)
                   for name, model in (('int8', q8), ('bf16', fp))}
    del q8, fp
    free_cuda()
    return launches, out


SP_PIECES = ['▁hello', '▁world', '▁the', '▁quick', 'ing', '▁fox', 'hel',
             'lo', '▁', 'h', 'e', 'l', 'o', 'w', 'r', 'd', 't', 'q', 'u',
             'i', 'c', 'k', 'n', 'g', 'f', 'x']


def sp_model_bytes() -> bytes:
    """A tiny SentencePiece ModelProto (unigram): <unk>, <s>, </s>, word
    and character pieces, the 256 byte-fallback pieces."""
    import struct

    def varint(n):
        out = b''
        while True:
            b, n = n & 0x7F, n >> 7
            if n:
                out += bytes([b | 0x80])
            else:
                return out + bytes([b])

    def piece(text, score, ptype=1):
        body = (b'\x0a' + varint(len(text.encode())) + text.encode() +
                b'\x15' + struct.pack('<f', score))
        if ptype != 1:
            body += b'\x18' + varint(ptype)
        return b'\x0a' + varint(len(body)) + body

    pieces = [piece('<unk>', 0.0, 2), piece('<s>', 0.0, 3),
              piece('</s>', 0.0, 3)]
    pieces += [piece(p, -rank / 4.0 - 1.0)
               for rank, p in enumerate(SP_PIECES)]
    pieces += [piece(f'<0x{b:02X}>', -100.0, 6) for b in range(256)]
    trainer = b'\x18' + varint(1)
    return b''.join(pieces) + b'\x12' + varint(len(trainer)) + trainer


def bf16_exact_model(cfg, seed, dev):
    """Seeded weights whose every value is a bf16 value (the f32 lm_head
    rounded through bf16), so a bf16 HF source or step holds them
    exactly."""
    import torch
    from skypilot_tpu_torch.models.transformer import init_params
    model = init_params(cfg, seed=seed, device=dev)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(p.to(torch.bfloat16))
    return model


def write_hf_source(model, src) -> None:
    """The model as an HF Llama (or, with experts, Mixtral) checkpoint:
    HF names, [out, in] kernels, q/k rows in the rotate-half order,
    BF16, config.json, and a tiny SentencePiece tokenizer.model; written
    tensor by tensor with the port's own safetensors writer (no
    `transformers` needed)."""
    import os
    import torch
    from skypilot_tpu_torch.utils import safetensors_io
    cfg = model.cfg
    d, hd = cfg.d_model, cfg.head_dim

    def rotate_half_rows(kernel, heads):     # [d, h, hd] -> [h*hd, d]
        k = kernel.reshape(d, heads, hd)
        return torch.cat([k[..., 0::2], k[..., 1::2]], -1).reshape(
            d, heads * hd).t()

    leaves = [('model.embed_tokens.weight', lambda: model.embed.embedding),
              ('model.norm.weight', lambda: model.final_norm.scale),
              ('lm_head.weight', lambda: model.lm_head.kernel.t())]
    for i, layer in enumerate(model.layers):
        pre = f'model.layers.{i}.'
        leaves += [
            (pre + 'input_layernorm.weight',
             lambda x=layer: x.attn_norm.scale),
            (pre + 'post_attention_layernorm.weight',
             lambda x=layer: x.mlp_norm.scale),
            (pre + 'self_attn.q_proj.weight',
             lambda x=layer: rotate_half_rows(x.attn.q_proj.kernel,
                                              cfg.n_heads)),
            (pre + 'self_attn.k_proj.weight',
             lambda x=layer: rotate_half_rows(x.attn.k_proj.kernel,
                                              cfg.n_kv_heads)),
            (pre + 'self_attn.v_proj.weight',
             lambda x=layer: x.attn.v_proj.kernel.reshape(d, -1).t()),
            (pre + 'self_attn.o_proj.weight',
             lambda x=layer: x.attn.o_proj.kernel.reshape(-1, d).t()),
        ]
        if cfg.n_experts == 0:
            leaves += [(pre + f'mlp.{name}.weight',
                        lambda x=layer, n=name:
                        getattr(x.mlp, n).kernel.t())
                       for name in ('gate_proj', 'up_proj', 'down_proj')]
            continue
        moe = pre + 'block_sparse_moe.'
        leaves.append((moe + 'gate.weight',
                       lambda x=layer: x.moe_mlp.router.kernel.t()))
        for e in range(cfg.n_experts):
            leaves += [(moe + f'experts.{e}.{theirs}.weight',
                        lambda x=layer, n=ours, e=e:
                        getattr(x.moe_mlp, n)[e].t())
                       for ours, theirs in (('gate_proj', 'w1'),
                                            ('up_proj', 'w3'),
                                            ('down_proj', 'w2'))]
    specs = [(name, torch.bfloat16, tuple(fn().shape)) for name, fn in leaves]
    os.makedirs(src)
    safetensors_io.write_file(os.path.join(src, 'model.safetensors'), specs,
                              ((name, fn()) for name, fn in leaves))
    moe = ({'model_type': 'mixtral', 'num_local_experts': cfg.n_experts,
            'num_experts_per_tok': cfg.expert_top_k,
            'router_aux_loss_coef': cfg.router_aux_loss_coef}
           if cfg.n_experts else {'model_type': 'llama'})
    with open(os.path.join(src, 'config.json'), 'w', encoding='utf-8') as f:
        json.dump({**moe, 'vocab_size': cfg.vocab_size,
                   'hidden_size': d, 'intermediate_size': cfg.d_ff,
                   'num_hidden_layers': cfg.n_layers,
                   'num_attention_heads': cfg.n_heads,
                   'num_key_value_heads': cfg.n_kv_heads,
                   'max_position_embeddings': cfg.max_seq_len,
                   'rope_theta': cfg.rope_theta,
                   'rms_norm_eps': cfg.norm_eps,
                   'tie_word_embeddings': False,
                   'torch_dtype': 'bfloat16'}, f)
    with open(os.path.join(src, 'tokenizer.model'), 'wb') as f:
        f.write(sp_model_bytes())


def disk_bytes(path) -> int:
    import os
    return sum(os.path.getsize(os.path.join(root, name))
               for root, _, names in os.walk(path) for name in names)


def same_weights(a, b, what) -> None:
    """Fail unless two models hold the same leaves, bit for bit."""
    import torch
    from skypilot_tpu_torch.models import convert

    def walk(x, y, path):
        if isinstance(y, dict):
            for k in y:
                walk(x[k], y[k], f'{path}/{k}')
            return
        if x.dtype != y.dtype or not torch.equal(x, y):
            raise AssertionError(f'{what}: {path} differs')
    walk(convert.param_tree(a), convert.param_tree(b), '')


def generate_text(server, body):
    from skypilot_tpu_torch.serve import http_protocol
    from skypilot_tpu_torch.serve import model_server
    port, stop = model_server.start_background(server)
    try:
        return json.loads(http_call(port, http_protocol.GENERATE_TEXT,
                                    body=body)[2])
    finally:
        stop()


def checkpoint_round_trip(dev, counters, new_tokens):
    """HF source -> import_weights.convert -> restore (bit-equal to the
    writer) -> ModelServer('auto') -> /generate, /generate_text -> step
    1 -> POST /weights_swap, at full width and depth 2.  Launches are
    read around the 'auto' server's life; the in-memory servers on the
    same weights run after the read."""
    import shutil
    import tempfile
    import torch
    from skypilot_tpu_torch.data import checkpoints
    from skypilot_tpu_torch.models import configs
    from skypilot_tpu_torch.models import convert
    from skypilot_tpu_torch.models import import_weights
    from skypilot_tpu_torch.serve import http_protocol
    from skypilot_tpu_torch.serve import model_server
    cfg = configs.get_config('llama3-8b', n_layers=2)
    kw = dict(continuous_batching=True, kv_pages=256, page_size=16,
              max_len=1024, max_batch=8, device=dev)
    bodies = [{'prompt_ids': [prompt(400 + i, n, cfg.vocab_size)],
               'max_new_tokens': new_tokens}
              for i, n in enumerate(REAL_LENGTHS[:4])]
    text_body = {'prompt': 'hello the quick fox', 'max_new_tokens': 16}
    root = tempfile.mkdtemp(prefix='skytpu_real_weights_')
    out = {}
    try:
        src, ckpt = f'{root}/hf', f'{root}/ckpt'
        writer = bf16_exact_model(cfg, 21, dev)
        t0 = time.perf_counter()
        write_hf_source(writer, src)
        out['source_s'] = time.perf_counter() - t0
        out['source_gb'] = disk_bytes(src) / 1e9
        t0 = time.perf_counter()
        converted = import_weights.convert(src, ckpt, dtype='bfloat16')
        out['convert_s'] = time.perf_counter() - t0
        out['peak_disk_gb'] = (disk_bytes(src) + disk_bytes(ckpt)) / 1e9
        shutil.rmtree(src)
        if converted != cfg:
            raise AssertionError(f'converted config {converted} != {cfg}')
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree = checkpoints.restore_params(ckpt, device=dev)
        torch.cuda.synchronize()
        out['restore_s'] = time.perf_counter() - t0
        same_weights(convert.from_jax_params(cfg, tree, device=dev), writer,
                     'the imported tree vs the model that wrote it')
        del tree
        free_cuda()

        zero_counts(counters)
        t0 = time.perf_counter()
        auto = model_server.ModelServer('auto', checkpoint_dir=ckpt, **kw)
        torch.cuda.synchronize()
        out['auto_init_s'] = time.perf_counter() - t0
        try:
            if auto.cfg != cfg:
                raise AssertionError(f'--model auto read {auto.cfg}')
            if type(auto.tokenizer).__name__ != 'SentencePieceTokenizer':
                raise AssertionError(f'tokenizer {auto.tokenizer}')
            tokens, _ = greedy_burst(auto, bodies)
            text = generate_text(auto, text_body)
            second = bf16_exact_model(cfg, 22, dev)
            tree = convert.param_tree(second)
            tree['lm_head']['kernel'] = tree['lm_head']['kernel'].to(
                torch.bfloat16)
            checkpoints.save_params(ckpt, 1, tree)
            del tree
            out['step1_gb'] = disk_bytes(f'{ckpt}/1') / 1e9
            out['peak_disk_gb'] = max(out['peak_disk_gb'],
                                      disk_bytes(ckpt) / 1e9)
            port, stop = model_server.start_background(auto)
            try:
                swapped = json.loads(http_call(
                    port, http_protocol.WEIGHTS_SWAP,
                    body={'checkpoint_dir': ckpt})[2])
            finally:
                stop()
            swapped_tokens, _ = greedy_burst(auto, bodies)
        finally:
            auto.close()
        launches = read_counts(counters)
        same_weights(auto.params, second, 'the swapped-in weights')
        del auto
        free_cuda()
        if (swapped['weight_version'], swapped['step']) != (1, 1):
            raise AssertionError(f'/weights_swap answered {swapped}')
        out['swap_restore_ms'] = swapped['restore_ms']
        for weights, got, what in ((writer, tokens, 'step 0'),
                                   (second, swapped_tokens, 'after swap')):
            fresh = model_server.ModelServer('auto', checkpoint_dir=ckpt,
                                             params=weights, **kw)
            try:
                want, _ = greedy_burst(fresh, bodies)
                if what == 'step 0':
                    ref_text = generate_text(fresh, text_body)
                    decoded = fresh.tokenizer.decode(text['tokens'])
            finally:
                fresh.close()
            if got != want:
                raise AssertionError(f'--model auto tokens ({what}) differ '
                                     'from the in-memory server\'s')
        if (text['tokens'] != ref_text['tokens'] or
                text['completion'] != decoded):
            raise AssertionError(f'/generate_text {text} vs in memory '
                                 f'{ref_text}, decode {decoded!r}')
        out['text_tokens'] = len(text['tokens'])
        del writer, second
        free_cuda()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches, out


def real_weights(dev, counters, new_tokens):
    """Phase 5b; returns {path: launch counts}."""
    paths = {}
    t_phase = time.perf_counter()
    q = quantize_card_vs_cpu(dev)
    log(f'quantize_params on the card == CPU, byte for byte: depth-1 '
        f'llama3-8b f32 tree, {q["leaves"]} leaves ({q["int8_leaves"]} '
        f'int8); {q["card_s"]:.2f} s on the card, {q["host_s"]:.2f} s on '
        f'the CPU')
    free_cuda()
    paths['int8 weights'], w = int8_weights(dev, counters, new_tokens)
    expect_launches('int8 weights', paths['int8 weights'],
                    ('paged_attention', 'flash_fwd'),
                    ('paged_attention_int8',))
    ticks = {name: {k: t[k] for k in ('tick_ms', 'device_ms_per_tick',
                                      'device_idle_share',
                                      'kernels_per_tick')}
             for name, t in w['tick'].items()}
    log(f'int8 weights ({card()}): weights {w["int8_gib"]:.3f} GiB vs bf16 '
        f'{w["bf16_gib"]:.3f} GiB; init (seeded, quantized on the card '
        f'leaf by leaf) {w["init_s"]:.1f} s; 6 concurrent /generate '
        f'{w["tokens_per_s"]:.1f} tokens/s, greedy tokens equal to the '
        f'dequantized bf16 model\'s; paged tick (8 slots, profile_decode, '
        f'printed, not held) {json.dumps(ticks)}; top device ops int8 '
        f'{json.dumps(w["tick"]["int8"]["top_device_ops"][:6])}, bf16 '
        f'{json.dumps(w["tick"]["bf16"]["top_device_ops"][:4])}; launches '
        f'{json.dumps(paths["int8 weights"])}')
    paths['checkpoint'], c = checkpoint_round_trip(dev, counters, new_tokens)
    expect_launches('checkpoint', paths['checkpoint'],
                    ('paged_attention', 'flash_fwd'),
                    ('paged_attention_int8',))
    log(f'checkpoint (llama3-8b width, depth 2, bf16): HF source '
        f'{c["source_gb"]:.2f} GB written in {c["source_s"]:.1f} s; '
        f'import_weights.convert {c["convert_s"]:.1f} s; restore to the '
        f'card {c["restore_s"]:.2f} s, bit-equal to the writer; --model '
        f'auto init {c["auto_init_s"]:.1f} s, greedy tokens and '
        f'/generate_text ({c["text_tokens"]} tokens) equal to an in-memory '
        f'server\'s; step 1 ({c["step1_gb"]:.2f} GB) swapped in '
        f'(restore_ms {c["swap_restore_ms"]}), weight_version 1, tokens '
        f'equal to a fresh server\'s; peak disk {c["peak_disk_gb"]:.2f} GB; '
        f'launches {json.dumps(paths["checkpoint"])}; the phase '
        f'{time.perf_counter() - t_phase:.1f} s')
    return paths


# ------------------------------------------------------------ phase 5c

MOE_LAYERS = 8           # Mixtral-8x7B's 32 layers cut to 8 (2.90 GB each)
MOE_LENGTHS = (5, 37, 64, 100, 250, 700)


@contextlib.contextmanager
def moe_as_served(n_prompt, drops=None):
    """decode._tp_moe_mlp (every MoE block, at any tensor degree) as the
    engine applies it to a teacher-forced sequence (prompt + generated
    tokens in one forward): the capacity dispatch over the prompt's
    rows (its prefill), the dense gather over each generated row (its
    ticks); `drops` collects each layer's dropped (token, expert)
    assignments of the prompt."""
    import torch
    from skypilot_tpu_torch.models import decode
    from skypilot_tpu_torch.models import moe as moe_lib
    served = decode._tp_moe_mlp  # pylint: disable=protected-access

    def moe_mlp(cfg, moes, hs, capacity=False, key=None):
        b, s, d = hs[0].shape
        head = served(cfg, moes, [h[:, :n_prompt] for h in hs],
                      capacity=capacity, key=key)
        if drops is not None:
            drops.append(moe_lib.dropped_tokens(
                hs[0][0, :n_prompt].float() @ moes[0].router.kernel.float(),
                cfg))
        if s == n_prompt:
            return head
        tail = served(cfg, moes, [h[:, n_prompt:].reshape(-1, 1, d)
                                  for h in hs])
        return torch.cat([head, tail.reshape(b, s - n_prompt, d)], 1)

    decode._tp_moe_mlp = moe_mlp  # pylint: disable=protected-access
    try:
        yield
    finally:
        decode._tp_moe_mlp = served  # pylint: disable=protected-access


def moe_window(model, dev, counters, new_tokens, **engine_kw):
    """One MoE serving window: ModelServer('mixtral-8x7b') cut to
    MOE_LAYERS on `model`, 6 concurrent greedy /generate requests of
    MOE_LENGTHS and one seeded sampled request, then the 100-token
    prompt again; launch counts zeroed just before the requests and
    read just after."""
    from skypilot_tpu_torch.serve import model_server
    server = model_server.ModelServer(
        'mixtral-8x7b', overrides={'n_layers': MOE_LAYERS},
        continuous_batching=True, max_len=1024, max_batch=8, params=model,
        device=dev, **engine_kw)
    vocab = server.cfg.vocab_size
    prompts = [prompt(700 + i, n, vocab) for i, n in enumerate(MOE_LENGTHS)]
    bodies = [{'prompt_ids': [p], 'max_new_tokens': new_tokens}
              for p in prompts]
    bodies.append({'prompt_ids': [prompt(720, 48, vocab)],
                   'max_new_tokens': new_tokens, 'temperature': 0.8,
                   'top_k': 40, 'seed': 7})
    try:
        zero_counts(counters)
        tokens, wall = greedy_burst(server, bodies)
        again, _ = greedy_burst(server, bodies[3:4])
        launches = read_counts(counters)
        stats = server.engine.stats()
    finally:
        server.close()
    if any(not 0 <= t < vocab for t in tokens[-1]):
        raise AssertionError(f'sampled tokens out of the vocab: {tokens[-1]}')
    if again[0] != tokens[3]:
        raise AssertionError('the repeated greedy prompt gave other tokens')
    want_b3 = (len(bodies) + 1) * MOE_LAYERS
    if launches['flash_fwd'] != want_b3:
        raise AssertionError(f'B3 ran {launches["flash_fwd"]} times, not once '
                             f'per prompt and layer ({want_b3})')
    if stats.get('prefix_cache_entries', 0) or stats.get(
            'prefix_cache_hits', 0):
        raise AssertionError(f'MoE pages were reused: {stats}')
    return launches, {'prompts': prompts, 'tokens': tokens[:len(prompts)],
                      'tokens_per_s': new_tokens * len(bodies) / wall,
                      'ticks': stats['ticks']}


def hold_moe(what, cfg, model, window, ref, quantized=False):
    """Every greedy token of a window held at its own context
    (`hold_tokens` under `moe_as_served`); -> (holds, each prompt's
    dropped assignments summed over the layers)."""
    holds, dropped = [], []
    for p, got, other in zip(window['prompts'], window['tokens'], ref):
        drops = []
        with moe_as_served(len(p), drops):
            holds.append(hold_tokens(what, cfg, model, p, got, other,
                                     quantized=quantized))
        # hold_tokens runs two forwards; each records every layer.
        dropped.append(sum(drops[:cfg.n_layers]))
    return holds, dropped


def moe_expert_cast_ms(model):
    """ms of one tick's f32 expert casts: the three stacks of one layer
    to f32 (what the s == 1 dense gather makes), times the layers.  CUDA
    events: three launches of ~1.5 ms each carry no host time worth
    separating (and a profiler window here, after the earlier phases'
    many, once saw no device events)."""
    import torch
    moe = model.layers[0].moe_mlp

    def cast():
        for name in ('gate_proj', 'up_proj', 'down_proj'):
            moe.stack(name, torch.float32)
    return time_ms(cast, iters=5, warmup=1) * model.cfg.n_layers


def moe_checkpoint(dev, counters, new_tokens):
    """A depth-1 Mixtral-width HF source (the port's writer) ->
    import_weights.convert -> ModelServer('auto') answers /generate;
    launches read around that server's life; after the read an
    in-memory server on the writer's weights must give the same
    tokens.  The directories are deleted as soon as they are read."""
    import shutil
    import tempfile
    import torch
    from skypilot_tpu_torch.models import configs
    from skypilot_tpu_torch.models import import_weights
    from skypilot_tpu_torch.serve import model_server
    cfg = configs.get_config('mixtral-8x7b', n_layers=1)
    kw = dict(continuous_batching=True, kv_pages=256, page_size=16,
              max_len=1024, max_batch=8, device=dev)
    bodies = [{'prompt_ids': [prompt(740 + i, n, cfg.vocab_size)],
               'max_new_tokens': new_tokens}
              for i, n in enumerate(MOE_LENGTHS[:4])]
    root = tempfile.mkdtemp(prefix='skytpu_moe_ckpt_')
    out = {}
    try:
        src, ckpt = f'{root}/hf', f'{root}/ckpt'
        writer = bf16_exact_model(cfg, 41, dev)
        t0 = time.perf_counter()
        write_hf_source(writer, src)
        out['source_s'] = time.perf_counter() - t0
        out['source_gb'] = disk_bytes(src) / 1e9
        t0 = time.perf_counter()
        converted = import_weights.convert(src, ckpt, dtype='bfloat16')
        out['convert_s'] = time.perf_counter() - t0
        shutil.rmtree(src)
        if converted != cfg:
            raise AssertionError(f'converted config {converted} != {cfg}')
        zero_counts(counters)
        auto = model_server.ModelServer('auto', checkpoint_dir=ckpt, **kw)
        try:
            tokens, _ = greedy_burst(auto, bodies)
        finally:
            auto.close()
        launches = read_counts(counters)
        same_weights(auto.params, writer, 'the restored Mixtral checkpoint')
        del auto
        fresh = model_server.ModelServer('auto', checkpoint_dir=ckpt,
                                         params=writer, **kw)
        shutil.rmtree(ckpt)
        try:
            want, _ = greedy_burst(fresh, bodies)
        finally:
            fresh.close()
        if tokens != want:
            raise AssertionError('--model auto (Mixtral) tokens differ from '
                                 'the in-memory server\'s')
        del writer, fresh
        torch.cuda.synchronize()
    finally:
        shutil.rmtree(root, ignore_errors=True)
        free_cuda()
    return launches, out


def moe_reference_check(dev):
    """Depth-1 f32 Mixtral width: GPU kernels vs the CPU plain versions,
    greedy tokens of 2 prompts, paged and dense engines."""
    import torch
    from skypilot_tpu_torch.models import configs
    from skypilot_tpu_torch.models import convert
    from skypilot_tpu_torch.models.transformer import init_params
    from skypilot_tpu_torch.serve import batching_engine
    cfg = configs.get_config('mixtral-8x7b', n_layers=1,
                             dtype=torch.float32)
    gpu_model = init_params(cfg, seed=43, device=dev)
    cpu_model = convert.from_jax_params(
        cfg, convert.to_jax_params(gpu_model), device='cpu')
    prompts = [prompt(760, 12, cfg.vocab_size),
               prompt(761, 40, cfg.vocab_size)]
    toks = {}
    for mode, kv_pages in (('paged', 32), ('dense', None)):
        for device, model in (('gpu', gpu_model), ('cpu', cpu_model)):
            engine = batching_engine.ContinuousBatchingEngine(
                cfg, model, max_len=128, slots=2, kv_pages=kv_pages,
                page_size=16, device=model.device)
            try:
                reqs = [engine.submit(p, 8) for p in prompts]
                toks[mode, device] = [r.result(timeout=600) for r in reqs]
            finally:
                engine.stop()
        if toks[mode, 'gpu'] != toks[mode, 'cpu']:
            raise AssertionError(f'MoE {mode}: GPU vs CPU greedy tokens '
                                 f'differ:\n{toks[mode, "gpu"]}\n'
                                 f'{toks[mode, "cpu"]}')
    del gpu_model, cpu_model
    free_cuda()


# The prompts of phase 5c's tensor windows: its 5-, 100-, 250- and
# 700-token ones (MOE_LENGTHS), so the tensor-1 "moe paged" window's
# tokens say where the two part.
MOE_TENSOR_PROMPTS = (0, 3, 4, 5)


def moe_tensor_serving(cfg, model, dev, counters, new_tokens, window):
    """Phase 5c's tensor windows on `model` (MOE_LAYERS deep) cut into
    tensor 2, then tensor 4, on the card repeated.  "moe tensor 2": a
    paged ModelServer('mixtral-8x7b', tensor=2) behind the asyncio
    front, the MOE_TENSOR_PROMPTS as concurrent /generate requests;
    "moe tensor 2 (int8 pool)": an engine with an int8 pool on the same
    prompts; "moe tensor 4": an engine at tensor 4, bf16 pool.
    Launches held exactly (B3 L tp a prompt, the window's paged kernel
    L tp a tick, the other 0); every greedy token held at its own
    context under the tensor model's own forward (flash vs masked, the
    MoE blocks as served), tensor 1's "moe paged" tokens (`window`)
    saying where they part; the logits' distance from the tensor-1
    model's on the same context printed, not held (a routing flip near
    a top-2 tie moves a logit by far more than DRIFT_LIMIT); the tick at
    each degree printed.  -> (paths, report)."""
    from skypilot_tpu_torch import profile_decode
    t0 = time.perf_counter()
    prompts = [window['prompts'][i] for i in MOE_TENSOR_PROMPTS]
    ref = [window['tokens'][i] for i in MOE_TENSOR_PROMPTS]
    paths = {}
    report = {'rank_gib': {}, 'tick': {}, 'seconds': {}}
    for tp in (2, 4):
        t_tp = time.perf_counter()
        cut = tensor_cut(cfg, model, tensor_mesh(dev, tp))
        report['rank_gib'][tp] = weight_bytes(cut.ranks[0]) / 2**30
        windows = {}
        if tp == 2:
            launches, tokens, health, _ = tensor_http(
                cfg, cut, dev, counters, prompts, new_tokens,
                name='mixtral-8x7b', tensor=2, tensor_devices=[dev] * 2, **TENSOR_SERVER)
            if health['engine']['tensor_degree'] != 2:
                raise AssertionError(
                    f'moe tensor 2 /health: {health["engine"]}')
            windows['moe tensor 2'] = (launches, tokens,
                                       health['engine']['ticks'], False)
            launches, tokens, stats = engine_window(
                cfg, cut, dev, counters, prompts, new_tokens,
                quantize_kv=True)
            windows['moe tensor 2 (int8 pool)'] = (launches, tokens,
                                                   stats['ticks'], True)
        else:
            launches, tokens, stats = engine_window(
                cfg, cut, dev, counters, prompts, new_tokens)
            windows[f'moe tensor {tp}'] = (launches, tokens, stats['ticks'],
                                           False)
        for name, (launches, got, ticks, quantized) in windows.items():
            paths[name] = launches
            hold_launches(name, launches, tensor_predicted(
                cfg, tp, len(prompts), ticks,
                kernel='paged_attention_int8' if quantized
                else 'paged_attention'))
            holds = []
            for p, g, r in zip(prompts, got, ref):
                with moe_as_served(len(p)):
                    holds.append(hold_tokens(
                        f'{name} prompt {len(p)}', cfg, cut, p, g, r,
                        quantized=quantized, one=model, drift_limit=None))
            report[name] = dict(ticks=ticks, holds=holds)
        free_cuda()
        report['tick'][tp] = profile_decode.profile_tick(
            cfg, cut, dev, ticks=10, n_prof=1)
        del cut
        free_cuda()
        report['seconds'][tp] = time.perf_counter() - t_tp
    report['seconds']['all'] = time.perf_counter() - t0
    return paths, report


def log_moe_tensor(report, tick1) -> None:
    for name in ('moe tensor 2', 'moe tensor 2 (int8 pool)',
                 'moe tensor 4'):
        r = report[name]
        log(f'  {name} ({len(MOE_TENSOR_PROMPTS)} prompts of '
            f'{[MOE_LENGTHS[i] for i in MOE_TENSOR_PROMPTS]} tokens): '
            f'{r["ticks"]} ticks; held: '
            f'{hold_summary(r["holds"], drift_held=False)}')
    keys = ('tick_ms', 'device_ms_per_tick', 'device_idle_share',
            'kernels_per_tick')
    ticks = {1: tick1, **report['tick']}
    log(f'  MoE paged tick at 8 slots (printed, not held): '
        + '; '.join(f'tensor {tp} {json.dumps({k: t[k] for k in keys})}'
                    for tp, t in ticks.items())
        + '; weights a rank '
        + ', '.join(f'{g:.2f} GiB at tensor {tp}'
                    for tp, g in report['rank_gib'].items())
        + '; seconds ' + json.dumps({str(k): round(v, 1) for k, v in
                                     report['seconds'].items()}))


def moe_serving(dev, counters, new_tokens):
    """Phase 5c; returns {path: launch counts}."""
    import torch
    from skypilot_tpu_torch import profile_decode
    from skypilot_tpu_torch.models import configs
    from skypilot_tpu_torch.models.transformer import init_params
    t_phase = time.perf_counter()
    cfg = configs.get_config('mixtral-8x7b', n_layers=MOE_LAYERS)
    t0 = time.perf_counter()
    model = init_params(cfg, seed=31, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gib = weight_bytes(model) / 2**30
    paged = dict(kv_pages=1024, page_size=16)
    paths, windows = {}, {}
    for name, kw, launched, idle in (
            ('moe paged', paged, ('paged_attention', 'flash_fwd'),
             ('paged_attention_int8',)),
            ('moe int8 pool', dict(paged, quantize_kv=True),
             ('paged_attention_int8', 'flash_fwd'), ('paged_attention',)),
            ('moe dense', {}, ('flash_fwd',),
             ('paged_attention', 'paged_attention_int8'))):
        paths[name], windows[name] = moe_window(model, dev, counters,
                                                new_tokens, **kw)
        expect_launches(name, paths[name], launched, idle)
    holds, dropped = {}, None
    for name, other in (('moe paged', 'moe dense'),
                        ('moe int8 pool', 'moe paged'),
                        ('moe dense', 'moe paged')):
        holds[name], drops = hold_moe(
            f'{name} greedy', cfg, model, windows[name],
            windows[other]['tokens'], quantized=name == 'moe int8 pool')
        dropped = dropped or drops
    tick = profile_decode.profile_tick(cfg, model, dev)
    cast_ms = moe_expert_cast_ms(model)
    tensor_paths, tensor_report = moe_tensor_serving(
        cfg, model, dev, counters, new_tokens, windows['moe paged'])
    paths.update(tensor_paths)
    del model
    free_cuda()
    paths['moe checkpoint'], ck = moe_checkpoint(dev, counters, new_tokens)
    expect_launches('moe checkpoint', paths['moe checkpoint'],
                    ('paged_attention', 'flash_fwd'),
                    ('paged_attention_int8',))
    moe_reference_check(dev)
    summary = {k: tick[k] for k in ('tick_ms', 'device_ms_per_tick',
                                    'device_idle_share', 'kernels_per_tick')}
    top = [(k[:48], n, ms) for k, n, ms in tick['top_device_ops'][:6]]
    log(f'MoE (mixtral-8x7b width, depth {MOE_LAYERS}, bf16; {card()}): '
        f'weights {gib:.2f} GiB, seeded init {init_s:.1f} s; 7 concurrent '
        f'/generate (6 greedy of {list(MOE_LENGTHS)} tokens, 1 sampled) '
        + '; '.join(f'{n}: {w["tokens_per_s"]:.1f} tokens/s, {w["ticks"]} '
                    f'ticks, held: {hold_summary(holds[n])}'
                    for n, w in windows.items())
        + f'; the repeated 100-token prompt gave its tokens again, no '
        f'prefix entry; prefill dispatch dropped (token, expert) '
        f'assignments per prompt, summed over the layers: {dropped}; '
        f'paged tick at 8 slots (profile_decode, printed, not held) '
        f'{json.dumps(summary)}; f32 expert casts {cast_ms:.2f} ms a tick '
        f'(CUDA events; {cast_ms / tick["device_ms_per_tick"]:.1%} of the '
        f'device ms); '
        f'top device ops {json.dumps(top)}')
    log_moe_tensor(tensor_report, tick)
    log(f'MoE checkpoint (depth 1): HF source {ck["source_gb"]:.2f} GB '
        f'written in {ck["source_s"]:.1f} s, import_weights.convert '
        f'{ck["convert_s"]:.1f} s, --model auto greedy tokens equal to an '
        f'in-memory server\'s; depth-1 f32 GPU == CPU greedy tokens (paged '
        f'and dense); launches {json.dumps(paths)}; the phase '
        f'{time.perf_counter() - t_phase:.1f} s')
    return paths


# ------------------------------------------------------------ phase 7

TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ = 4, 2, 2048
WARMUP_STEPS, TIMED_STEPS = 2, 5
TRAIN_KERNELS = ('flash_fwd', 'flash_bwd_dq', 'flash_bwd_dkv')


def run_steps(dev, cfg, tcfg, batch, n_steps, state=None, step=None,
              cards=None):
    """n_steps train_steps (a fresh seed-0 state unless given; `step`
    in place of train_step(., ., tcfg) where given), each synchronised
    on every card of `cards` (default: the current one);
    -> (state, [(loss, grad_norm, ms)])."""
    import torch
    from skypilot_tpu_torch.models import train
    if state is None:
        state, _ = train.create_train_state(cfg, tcfg, device=dev, seed=0)
    step = step or (lambda st, b: train.train_step(st, b, tcfg))
    cards = cards or [None]

    def sync():
        for card_dev in cards:
            torch.cuda.synchronize(card_dev)
    out = []
    for _ in range(n_steps):
        sync()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss, norm = float(m['loss']), float(m['grad_norm'])
        sync()
        out.append((loss, norm, (time.perf_counter() - t0) * 1e3))
    return state, out


def profile_step(state, batch, tcfg):
    """One profiled train_step, its wall time and its device time both
    from the one trace: -> dict of device kernel ms, the step's wall ms
    (its range, closed by a synchronize), the device's busy ms inside it
    (the union of its kernels' intervals), the idle share, the kernel
    count, ms by kernel group and the top kernels."""
    import torch
    from skypilot_tpu_torch.models import train
    cuda = torch.autograd.DeviceType.CUDA
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function('chip_smoke_train_step'):
            train.train_step(state, batch, tcfg)
            torch.cuda.synchronize()

    def dev_us(e):
        return float(getattr(e, 'self_device_time_total', 0.0) or 0.0)
    step = [e for e in prof.events() if e.name == 'chip_smoke_train_step'
            and e.device_type != cuda]
    if len(step) != 1:
        raise AssertionError(f'train profile: {len(step)} step ranges')
    wall_us = step[0].time_range.end - step[0].time_range.start
    busy_us, until = 0.0, -math.inf
    for start, end in sorted((e.time_range.start, e.time_range.end)
                             for e in prof.events() if is_device_event(e)):
        busy_us += max(0.0, end - max(start, until))
        until = max(until, end)
    idle = 1 - busy_us / wall_us
    if not 0 <= idle <= 1:
        raise AssertionError(f'train profile: device busy {busy_us} us '
                             f'against a {wall_us} us step')
    events = [e for e in prof.key_averages() if is_device_event(e)]
    top = sorted(events, key=dev_us, reverse=True)[:16]
    groups = {}
    for e in events:
        group = kernel_group(e.key)
        groups[group] = groups.get(group, 0.0) + dev_us(e) / 1e3
    return dict(device_ms=sum(dev_us(e) for e in events) / 1e3,
                wall_ms=wall_us / 1e3, busy_ms=busy_us / 1e3, idle=idle,
                n_kernels=sum(e.count for e in events),
                groups={k: round(v, 3) for k, v in sorted(groups.items())},
                top=[(e.key[:60], e.count, round(dev_us(e) / 1e3, 3))
                     for e in top])


def kernel_group(name: str) -> str:
    """A CUDA kernel's group in the step breakdown, from its name."""
    low = name.lower()
    if 'flash_' in low:
        return 'attention B3/B4/B5'
    if any(tag in low for tag in ('gemm', 'nvjet', 'xmma', 'cutlass')):
        if 'f32f32' in low or 'sgemm' in low:
            return 'f32 GEMM (lm_head)'
        return 'bf16 GEMM'
    if 'multi_tensor_apply' in low:
        return 'optimizer (foreach)'
    return 'other (elementwise, reductions, copies)'


def free_cuda():
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def train_main_path(dev, counters):
    """llama3-8b at 4 layers: the unfused run (launch counts read around
    it), a profiled step, then fused CE + accum_steps=2 from the same
    initial weights.  -> launches of the run."""
    import torch
    from skypilot_tpu_torch.models import configs
    from skypilot_tpu_torch.models import train
    cfg = configs.get_config('llama3-8b', n_layers=TRAIN_LAYERS)
    tcfg = train.TrainConfig()
    gen = torch.Generator().manual_seed(0)
    batch = {'tokens': torch.randint(0, cfg.vocab_size,
                                     (TRAIN_BATCH, TRAIN_SEQ + 1),
                                     generator=gen).to(dev)}
    free_cuda()
    log(f'train: llama3-8b n_layers={TRAIN_LAYERS}, batch {TRAIN_BATCH} x '
        f'{TRAIN_SEQ}, {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB '
        'allocated before')
    torch.cuda.reset_peak_memory_stats(dev)
    n_steps = WARMUP_STEPS + TIMED_STEPS
    zero_counts(counters)
    state, steps = run_steps(dev, cfg, tcfg, batch, n_steps)
    counts = read_counts(counters)
    launches = {name: counts[name] for name in TRAIN_KERNELS}
    peak = train.peak_memory_bytes(dev)
    n_params = sum(p.numel() for p in state.model.parameters())
    losses = [x[0] for x in steps]
    step_ms = statistics.median(x[2] for x in steps[WARMUP_STEPS:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f'train: {n_params / 1e9:.3f} B parameters; losses '
        f'{" ".join(f"{x:.4f}" for x in losses)}; grad_norms '
        f'{" ".join(f"{x[1]:.3f}" for x in steps)}')
    log(f'train: step ms {" ".join(f"{x[2]:.1f}" for x in steps)}; median '
        f'of the {TIMED_STEPS} timed {step_ms:.1f} ms = '
        f'{tokens / step_ms * 1e3:.0f} tokens/s; peak memory '
        f'{peak / 2**30:.2f} GiB; launches {launches}')
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f'train: non-finite loss {losses}')
    if not losses[-1] < losses[0]:
        raise AssertionError(f'train: loss did not fall: {losses}')
    want = {'flash_fwd': 2 * TRAIN_LAYERS * n_steps,
            'flash_bwd_dq': TRAIN_LAYERS * n_steps,
            'flash_bwd_dkv': TRAIN_LAYERS * n_steps}
    if launches != want:
        raise AssertionError(f'train: launches {launches}, expected {want} '
                             f'(2L / L / L per step)')
    prof = profile_step(state, batch, tcfg)
    log(f'train profile: one profiled step of {prof["wall_ms"]:.1f} ms '
        f'wall, device busy {prof["busy_ms"]:.1f} ms of it (idle share '
        f'{prof["idle"]:.4f}), {prof["device_ms"]:.1f} ms of device '
        f'kernels ({prof["n_kernels"]} kernels); by group '
        f'{json.dumps(prof["groups"])}; top {json.dumps(prof["top"])}')
    del state
    free_cuda()

    fused = train.TrainConfig(fused_ce=True, accum_steps=2)
    torch.cuda.reset_peak_memory_stats(dev)
    state, fsteps = run_steps(dev, cfg, fused, batch, 2)
    log(f'train fused_ce + accum_steps=2: losses '
        f'{" ".join(f"{x[0]:.4f}" for x in fsteps)}, grad_norms '
        f'{" ".join(f"{x[1]:.3f}" for x in fsteps)}, step ms '
        f'{" ".join(f"{x[2]:.1f}" for x in fsteps)}, peak memory '
        f'{train.peak_memory_bytes(dev) / 2**30:.2f} GiB')
    for i, what in ((0, 'loss'), (1, 'grad_norm')):
        a, b = fsteps[0][i], steps[0][i]
        if not abs(a - b) <= 1e-3 * abs(b):
            raise AssertionError(f'train: fused+accum step-1 {what} {a} vs '
                                 f'unfused {b}')
    del state
    free_cuda()
    return counts


def cli_check(counters):
    """`train_llama --model small`: -> launches of the run."""
    from skypilot_tpu_torch import train_llama
    with train_log_dir():
        zero_counts(counters)
        history = train_llama.main(['--model', 'small', '--steps', '3',
                                    '--batch-size', '8', '--seq-len', '512'])
        counts = read_counts(counters)
    launches = {name: counts[name] for name in TRAIN_KERNELS}
    losses = [h['loss'] for h in history]
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f'train_llama small: non-finite loss {losses}')
    if min(launches.values()) <= 0:
        raise AssertionError(f'train_llama small: launches {launches}')
    log(f'train_llama --model small: losses '
        f'{" ".join(f"{x:.4f}" for x in losses)}; launches {launches}')
    free_cuda()
    return counts


# ----------------------------------------------------------- phase 7b

RESUME_STEPS = 5
RESUME_TOKENS = 4_194_304        # a 16 MB uint32 token file
RESUME_DISK_GB = 20.0            # 15.2 GB step + 2.5 GB HF source + init


@contextlib.contextmanager
def train_log_dir():
    """A summary.json directory of its own for the train_llama runs
    inside (a fresh callbacks singleton), deleted after; yields its
    path."""
    import os
    import shutil
    import tempfile
    from skypilot_tpu_torch.callbacks import base as callbacks
    log_dir = tempfile.mkdtemp(prefix='skytpu_train_logs_')
    before = os.environ.get(callbacks.ENV_LOG_DIR)
    os.environ[callbacks.ENV_LOG_DIR] = log_dir
    callbacks.reset()
    try:
        yield log_dir
    finally:
        callbacks.reset()
        if before is None:
            os.environ.pop(callbacks.ENV_LOG_DIR, None)
        else:
            os.environ[callbacks.ENV_LOG_DIR] = before
        shutil.rmtree(log_dir, ignore_errors=True)


class Tee:
    """sys.stdout that also keeps what was printed."""

    def __init__(self, out):
        self.out, self.kept = out, []

    def write(self, text):
        self.kept.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def resume_run(argv, ckpt=None):
    """train_llama.run(argv) with SKYTPU_CHECKPOINT_DIR=ckpt (or unset)
    and a summary of its own; -> (history, state, printed, summary)."""
    import os
    from skypilot_tpu_torch import train_llama
    from skypilot_tpu_torch.callbacks import base as callbacks
    from skypilot_tpu_torch.data import checkpoints
    if ckpt is None:
        os.environ.pop(checkpoints.ENV_CHECKPOINT_DIR, None)
    else:
        os.environ[checkpoints.ENV_CHECKPOINT_DIR] = ckpt
    try:
        with train_log_dir() as log_dir:
            tee = Tee(sys.stdout)
            with contextlib.redirect_stdout(tee):
                history, state = train_llama.run(argv)
            with open(f'{log_dir}/{callbacks.SUMMARY_FILE}',
                      encoding='utf-8') as f:
                summary = json.load(f)
    finally:
        os.environ.pop(checkpoints.ENV_CHECKPOINT_DIR, None)
    return history, state, ''.join(tee.kept), summary


def train_state_leaves(state):
    """{name: tensor} of every parameter, both AdamW moments and the
    optimizer's step count, plus the TrainState's step."""
    from skypilot_tpu_torch.models import train
    out = {'step': state.step}
    for path, p in train.param_paths(state.model):
        name = '/'.join(path)
        st = state.optimizer.state[p]
        out.update({name: p.detach(), f'mu/{name}': st['exp_avg'],
                    f'nu/{name}': st['exp_avg_sq'],
                    f'count/{name}': st['step']})
    return out


def same_train_state(a, b, what) -> None:
    """Fail unless two TrainStates hold the same leaves, bit for bit."""
    import torch
    la, lb = train_state_leaves(a), train_state_leaves(b)
    if sorted(la) != sorted(lb) or la['step'] != lb['step']:
        raise AssertionError(f'{what}: leaves or step differ')
    for name, x in la.items():
        if name == 'step':
            continue
        y = lb[name]
        if x.dtype != y.dtype or not torch.equal(x.cpu(), y.cpu()):
            raise AssertionError(f'{what}: {name} differs')


def training_resume(dev, counters):
    """Phase 7b: token file + converted init -> run U (5 steps), run A
    (1 step, saves step 0), run B (resumes at 1); -> (launches of the
    three runs, numbers to print)."""
    import os
    import shutil
    import tempfile
    import numpy as np
    import torch
    from skypilot_tpu_torch.data import checkpoints
    from skypilot_tpu_torch.data import loader
    from skypilot_tpu_torch.models import configs
    from skypilot_tpu_torch.models import convert
    from skypilot_tpu_torch.models import import_weights
    from skypilot_tpu_torch.models import train
    from skypilot_tpu_torch.serve import model_server
    cfg = configs.get_config('llama3-8b', n_layers=1)
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix='skytpu_train_resume_')
    out = {'free_gb': shutil.disk_usage(root).free / 1e9}
    if out['free_gb'] < RESUME_DISK_GB:
        shutil.rmtree(root)
        raise AssertionError(f'training resume needs ~{RESUME_DISK_GB} GB '
                             f'of free disk under {root}: '
                             f'{out["free_gb"]:.1f} GB')
    try:
        tok, src = f'{root}/tokens.bin', f'{root}/hf'
        init, ckpt = f'{root}/init', f'{root}/ckpt'
        loader.write_token_file(tok, np.random.default_rng(17).integers(
            0, cfg.vocab_size, RESUME_TOKENS, dtype=np.uint32))
        writer = bf16_exact_model(cfg, 31, dev)
        write_hf_source(writer, src)
        del writer
        free_cuda()
        t0 = time.perf_counter()
        if import_weights.convert(src, init, dtype='bfloat16') != cfg:
            raise AssertionError('converted config differs')
        out['convert_s'] = time.perf_counter() - t0
        out['used_gb'] = disk_bytes(root) / 1e9
        shutil.rmtree(src)
        argv = ['--model', 'auto', '--init-from', init, '--data', tok,
                '--batch-size', str(TRAIN_BATCH), '--seq-len', str(TRAIN_SEQ),
                '--device', str(dev)]
        save_hist = checkpoints.checkpoint_save_hist()
        blocked = checkpoints.checkpoint_blocked_counter()

        zero_counts(counters)
        hist_u, state, _, sum_u = resume_run(
            argv + ['--steps', str(RESUME_STEPS)])
        del state
        free_cuda()
        saves, save_s, blocked_s = (save_hist.count, save_hist.sum,
                                    blocked.value)
        hist_a, state_a, printed_a, _ = resume_run(argv + ['--steps', '1'],
                                                   ckpt)
        out['save_s'] = save_hist.sum - save_s
        out['blocked_s'] = blocked.value - blocked_s
        if save_hist.count - saves != 1 or checkpoints.latest_step(
                ckpt) != 0:
            raise AssertionError(f'run A: {save_hist.count - saves} saves, '
                                 f'newest step '
                                 f'{checkpoints.latest_step(ckpt)}')
        out['step_gb'] = disk_bytes(f'{ckpt}/0') / 1e9
        out['used_gb'] = max(out['used_gb'], disk_bytes(root) / 1e9)
        fresh, _ = train.create_train_state(cfg, device=dev, seed=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored, start = checkpoints.restore_or_init(fresh, ckpt)
        torch.cuda.synchronize()
        out['restore_s'] = time.perf_counter() - t0
        if start != 1:
            raise AssertionError(f'restore_or_init start_step {start}')
        same_train_state(restored, state_a,
                         'restore_or_init vs run A\'s final state')
        served = convert.from_jax_params(cfg, convert.param_tree(
            state_a.model), device=dev)
        del fresh, restored, state_a
        free_cuda()
        hist_b, state, printed_b, sum_b = resume_run(
            argv + ['--steps', str(RESUME_STEPS)], ckpt)
        launches = read_counts(counters)
        del state
        free_cuda()

        for text, step in ((printed_a, 0), (printed_b, 1)):
            if f'resuming from step {step}' not in text:
                raise AssertionError(f'no "resuming from step {step}"')
        if [h['step'] for h in hist_b] != list(range(1, RESUME_STEPS)):
            raise AssertionError(f'run B ran {[h["step"] for h in hist_b]}')
        if hist_a[0]['loss'] != hist_u[0]['loss']:
            raise AssertionError(f'run A step 0 loss {hist_a[0]["loss"]} vs '
                                 f'U {hist_u[0]["loss"]}')
        rel = [abs(b['loss'] - u['loss']) / abs(u['loss'])
               for b, u in zip(hist_b, hist_u[1:])]
        out['max_rel'] = max(rel)
        out['bit_equal'] = all(b['loss'] == u['loss'] and
                               b['grad_norm'] == u['grad_norm']
                               for b, u in zip(hist_b, hist_u[1:]))
        if out['max_rel'] > 1e-5:
            raise AssertionError(f'run B losses vs U: {rel}')
        out['losses_u'] = [h['loss'] for h in hist_u]
        out['losses_ab'] = [h['loss'] for h in hist_a + hist_b]

        batches = loader.HostShardedBatches(
            loader.TokenDataset(tok), global_batch=TRAIN_BATCH,
            seq_len=TRAIN_SEQ)
        with loader.prefetch_to_device(batches.batches(0),
                                       device=dev) as prefetched:
            for step in range(2):
                got = next(prefetched)['tokens']
                want = torch.from_numpy(batches.batch_at(step)['tokens'])
                if (got.device != dev or got.dtype != torch.int32 or
                        not torch.equal(got.cpu(), want)):
                    raise AssertionError(f'prefetched batch {step} differs '
                                         'from batch_at')

        kw = dict(continuous_batching=True, kv_pages=256, page_size=16,
                  max_len=1024, max_batch=8, device=dev)
        bodies = [{'prompt_ids': [prompt(700 + i, n, cfg.vocab_size)],
                   'max_new_tokens': 16} for i, n in enumerate((37, 250))]
        auto = model_server.ModelServer('auto', checkpoint_dir=ckpt, **kw)
        try:
            tokens, _ = greedy_burst(auto, bodies)
        finally:
            auto.close()
        same_weights(auto.params, served, 'the served training step')
        del auto
        free_cuda()
        fresh = model_server.ModelServer('auto', checkpoint_dir=ckpt,
                                         params=served, **kw)
        try:
            want, _ = greedy_burst(fresh, bodies)
        finally:
            fresh.close()
        if tokens != want:
            raise AssertionError('the training step\'s server and the '
                                 'in-memory server differ')
        del fresh, served
        free_cuda()
        out['summary'] = {run: {k: s[k] for k in (
            'compute_seconds_per_step', 'data_wait_seconds',
            'prefetch_wait_seconds', 'peak_memory_bytes')}
            for run, s in (('U', sum_u), ('B', sum_b))}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out['wall_s'] = time.perf_counter() - t_phase
    return launches, out


def log_training_resume(r, launched) -> None:
    summary = {run: {k: (round(v, 6) if isinstance(v, float) else v)
                     for k, v in x.items()} for run, x in r['summary'].items()}
    log(f'training resume ({card()}): llama3-8b width at depth 1, batch '
        f'{TRAIN_BATCH} x {TRAIN_SEQ}, --model auto --init-from --data; '
        f'losses U {" ".join(f"{x:.6f}" for x in r["losses_u"])}, A+B '
        f'{" ".join(f"{x:.6f}" for x in r["losses_ab"])}; A step 0 == U; '
        f'B steps 1-4 vs U largest relative difference {r["max_rel"]:.3g} '
        f'(bit-equal: {r["bit_equal"]}); restore_or_init bit-equal to run '
        f'A\'s final state; prefetched batches 0-1 == batch_at; the step\'s '
        f'server == an in-memory server on the same params (2 prompts)')
    log(f'training resume seconds ({card()}): convert {r["convert_s"]:.2f}; '
        f'checkpoint write {r["save_s"]:.2f} ({r["step_gb"]:.2f} GB step); '
        f'blocked {r["blocked_s"]:.3f}; restore {r["restore_s"]:.2f}; '
        f'summary.json {json.dumps(summary)}; free disk before '
        f'{r["free_gb"]:.1f} GB, used at peak {r["used_gb"]:.2f} GB; the '
        f'phase {r["wall_s"]:.1f} s; launches {json.dumps(launched)}')


# ------------------------------------------------------------ phase 7c

SHARD_LAYERS, SHARD_BATCH, SHARD_SEQ, SHARD_STEPS = 2, 2, 4096, 3
SHARD_F32_SEQ = 1024
# label -> (mesh axes over four entries of the one card, SP mode).
SHARD_MESHES = {'sharded training': (dict(data=1, fsdp=2, sequence=2),
                                     'ring'),
                'sharded training (ulysses)': (dict(data=2, sequence=2),
                                               'ulysses'),
                'sharded training (tensor)': (dict(data=1, sequence=2,
                                                   tensor=2), 'ring')}


def shard_launches(axes, mode, n_layers, n_steps):
    """B3/B4/B5 launches of n_steps steps on a mesh, with one forward per
    batch rank and a layer checkpoint (the forward runs again in the
    backward): a causal ring over sp ranks launches sp (sp + 1) / 2
    hops, Ulysses one call a rank, each tensor rank over its own heads;
    each launch has one B4 and one B5."""
    ranks = axes.get('data', 1) * axes.get('fsdp', 1)
    sp, tp = axes.get('sequence', 1), axes.get('tensor', 1)
    per_rank = sp * (sp + 1) // 2 if mode == 'ring' else sp
    fwd = ranks * tp * n_layers * per_rank
    return {'flash_fwd': 2 * fwd * n_steps, 'flash_bwd_dq': fwd * n_steps,
            'flash_bwd_dkv': fwd * n_steps}


def full_grads(state):
    """{parameter name: its gradient, whole, on the host}."""
    import torch
    out = {}
    for name, p in state.model.named_parameters():
        if state.shards is None:
            out[name] = p.grad.detach().cpu()
            continue
        full = torch.empty(p.shape, dtype=p.dtype)
        for t, idx in state.shards.pieces(name):
            full[idx] = t.grad.detach().cpu()
        out[name] = full
    return out


def sharded_f32_check(dev):
    """Depth-1 f32 llama3-8b width, batch 2 x SHARD_F32_SEQ: the loss and
    every gradient of meshes A and B against the unsharded GPU step
    from the same seed (loss rtol 1e-5, gradients within 1e-3 of max
    |unsharded| per leaf).  -> {mesh: (loss, unsharded loss, worst)}."""
    import torch
    from skypilot_tpu_torch.models import configs
    from skypilot_tpu_torch.models import train
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    cfg = configs.get_config('llama3-8b', n_layers=1, dtype=torch.float32)
    gen = torch.Generator().manual_seed(11)
    batch = {'tokens': torch.randint(0, cfg.vocab_size,
                                     (SHARD_BATCH, SHARD_F32_SEQ + 1),
                                     generator=gen).to(dev)}
    state, _ = train.create_train_state(cfg, device=dev, seed=1)
    ref_loss = float(train.value_and_grad(state, batch).detach())
    ref = full_grads(state)
    del state
    free_cuda()
    out = {}
    for label, (axes, mode) in SHARD_MESHES.items():
        mesh = mesh_lib.build_mesh(mesh_lib.MeshConfig(**axes), [dev] * 4)
        state, _ = train.create_train_state(
            cfg.replace(sequence_parallel=mode), mesh=mesh, seed=1)
        loss = float(train.value_and_grad(state, batch).detach())
        if not abs(loss - ref_loss) <= 1e-5 * abs(ref_loss):
            raise AssertionError(f'{label} f32: loss {loss} vs unsharded '
                                 f'{ref_loss}')
        worst = (0.0, '')
        for name, g in full_grads(state).items():
            scale = max(float(ref[name].abs().max()), 1e-30)
            rel = float((g - ref[name]).abs().max()) / scale
            if rel > 1e-3:
                raise AssertionError(f'{label} f32: {name} gradient '
                                     f'{rel:.3g} of max |unsharded|')
            worst = max(worst, (rel, name))
        out[label] = (loss, ref_loss, worst)
        del state
        free_cuda()
    return out


def sharded_cli(dev, counters):
    """`train_llama --model small` over four entries of the card (fsdp
    2 x sequence 2, ring) with --preflight and a checkpoint directory,
    then its step 0 restored onto fsdp 4 (`restore_sharded`), held
    bit-equal to the step's files.  -> (launches, report)."""
    import os
    import shutil
    import tempfile
    import torch
    from skypilot_tpu_torch.data import checkpoints
    from skypilot_tpu_torch.models import configs
    from skypilot_tpu_torch.models import train
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    ckpt = tempfile.mkdtemp(prefix='skytpu_shard_ckpt_')
    try:
        argv = ['--model', 'small', '--steps', '3', '--batch-size', '8',
                '--seq-len', '512', '--mesh-devices',
                ','.join([str(dev)] * 4), '--fsdp', '2', '--sequence', '2',
                '--preflight']
        zero_counts(counters)
        history, state, printed, _ = resume_run(argv, ckpt)
        counts = read_counts(counters)
        losses = [h['loss'] for h in history]
        if not all(map(math.isfinite, losses)):
            raise AssertionError(f'train_llama small mesh: losses {losses}')
        if 'collective preflight: healthy' not in printed:
            raise AssertionError('train_llama small mesh: no preflight line')
        want = shard_launches(dict(fsdp=2, sequence=2), 'ring',
                              configs.get_config('small').n_layers, 3)
        got = {k: counts[k] for k in want}
        if got != want:
            raise AssertionError(f'train_llama small mesh: launches {got}, '
                                 f'predicted {want}')
        if state.shards is None:
            raise AssertionError('train_llama small mesh: unsharded state')
        del state
        cfg = configs.get_config('small')
        mesh = mesh_lib.build_mesh(mesh_lib.MeshConfig(data=1, fsdp=4),
                                   [dev] * 4)
        abstract, shardings = train.abstract_train_state(cfg, mesh=mesh)
        t0 = time.perf_counter()
        restored, start = checkpoints.restore_sharded(ckpt, abstract,
                                                      shardings)
        restore_s = time.perf_counter() - t0
        saved = checkpoints.restore_params(ckpt, device='cpu')
        if start != 1:
            raise AssertionError(f'restore_sharded: start {start}, not 1')
        for path, t in train.snapshot(restored).params:
            node = saved
            for key in path:
                node = node[key]
            if not torch.equal(t, node):
                raise AssertionError(f'restore_sharded: {path} differs')
        blocks = len(restored.shards.blocks['embed.embedding'])
        report = dict(losses=losses, restore_s=restore_s, blocks=blocks,
                      printed=[line for line in printed.splitlines()
                               if line.startswith(('mesh:', 'collective'))])
        del restored
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
        os.environ.pop(checkpoints.ENV_CHECKPOINT_DIR, None)
    free_cuda()
    return counts, report


def sharded_training(dev, counters):
    """Phase 7c: llama3-8b width at SHARD_LAYERS layers, bf16, remat,
    batch SHARD_BATCH x SHARD_SEQ: the unsharded step, then meshes A and
    B over four entries of the card, SHARD_STEPS steps each from the
    same seed on the same batch; launches held to `shard_launches`;
    then the f32 cut and the CLI.  -> (paths, report)."""
    import torch
    from skypilot_tpu_torch.models import configs
    from skypilot_tpu_torch.models import train
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    t_phase = time.perf_counter()
    cfg = configs.get_config('llama3-8b', n_layers=SHARD_LAYERS)
    gen = torch.Generator().manual_seed(7)
    batch = {'tokens': torch.randint(0, cfg.vocab_size,
                                     (SHARD_BATCH, SHARD_SEQ + 1),
                                     generator=gen).to(dev)}
    paths, report = {}, {}
    runs = {'sharded training (unsharded)': (None, cfg.sequence_parallel)}
    runs.update(SHARD_MESHES)
    for label, (axes, mode) in runs.items():
        free_cuda()
        torch.cuda.reset_peak_memory_stats(dev)
        c = cfg.replace(sequence_parallel=mode)
        if axes is None:
            state, _ = train.create_train_state(c, device=dev, seed=0)
            want = shard_launches({}, 'ring', SHARD_LAYERS, SHARD_STEPS)
        else:
            mesh = mesh_lib.build_mesh(mesh_lib.MeshConfig(**axes),
                                       [dev] * 4)
            state, _ = train.create_train_state(c, mesh=mesh, seed=0)
            want = shard_launches(axes, mode, SHARD_LAYERS, SHARD_STEPS)
        zero_counts(counters)
        state, steps = run_steps(dev, c, None, batch, SHARD_STEPS, state)
        paths[label] = read_counts(counters)
        got = {k: paths[label][k] for k in want}
        if got != want:
            raise AssertionError(f'{label}: launches {got}, predicted {want}')
        losses = [x[0] for x in steps]
        if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f'{label}: losses {losses}')
        params, stored = state_bytes(state)
        report[label] = dict(
            losses=losses, grad_norms=[x[1] for x in steps],
            step_ms=[x[2] for x in steps],
            peak_gib=train.peak_memory_bytes(dev) / 2**30,
            state_gb=[3 * b / 1e9 for b in params],
            stored_gb=[3 * b / 1e9 for b in stored], launches=got)
        del state
    ref = report['sharded training (unsharded)']['losses'][0]
    for label in SHARD_MESHES:
        first = report[label]['losses'][0]
        if not abs(first - ref) <= 1e-2 * abs(ref):
            raise AssertionError(f'{label}: step-1 loss {first} vs '
                                 f'unsharded {ref}')
    free_cuda()
    n_cards = torch.cuda.device_count()
    if n_cards >= 4:
        paths[SHARD_FOUR], report['four cards'] = four_card_mesh_b(
            cfg, batch, counters, ref)
    else:
        report['four cards skipped'] = (
            f'{n_cards} card: mesh B over four distinct cards needs four')
    report['f32'] = sharded_f32_check(dev)
    paths['train_llama small mesh'], report['cli'] = sharded_cli(
        dev, counters)
    report['seconds'] = time.perf_counter() - t_phase
    return paths, report


def state_bytes(state):
    """(params a mesh position, params stored on each distinct device):
    `ShardedParams.position_bytes` and `device_bytes`, or the whole
    model's f32 bytes once for an unsharded state."""
    if state.shards is not None:
        return state.shards.position_bytes(), state.shards.device_bytes()
    whole = [sum(p.numel() * 4 for p in state.model.parameters())]
    return whole, whole


SHARD_FOUR = 'sharded training (ulysses, four cards)'


def four_card_mesh_b(cfg, batch, counters, ref):
    """Phase 7c on four cards: mesh B (data 2 x sequence 2, Ulysses) over
    cuda:0 ... cuda:3, SHARD_STEPS steps from seed 0 on the phase's
    batch.  Held: launches `shard_launches`, losses finite and falling,
    step 1 within 1e-2 of the unsharded step's `ref`, every copy
    bit-equal to its owner after the steps (`train.check_copies`), the
    same state bytes stored on each card.  -> (launches, report)."""
    import torch
    from skypilot_tpu_torch.models import train
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    axes, mode = SHARD_MESHES['sharded training (ulysses)']
    cards = [torch.device('cuda', i) for i in range(4)]
    for card_dev in cards:
        torch.cuda.reset_peak_memory_stats(card_dev)
    c = cfg.replace(sequence_parallel=mode)
    mesh = mesh_lib.build_mesh(mesh_lib.MeshConfig(**axes), cards)
    state, _ = train.create_train_state(c, mesh=mesh, seed=0)
    want = shard_launches(axes, mode, SHARD_LAYERS, SHARD_STEPS)
    zero_counts(counters)
    state, steps = run_steps(cards[0], c, None, batch, SHARD_STEPS, state,
                             cards=cards)
    launches = read_counts(counters)
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f'{SHARD_FOUR}: launches {got}, predicted '
                             f'{want}')
    losses = [x[0] for x in steps]
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f'{SHARD_FOUR}: losses {losses}')
    if not abs(losses[0] - ref) <= 1e-2 * abs(ref):
        raise AssertionError(f'{SHARD_FOUR}: step-1 loss {losses[0]} vs '
                             f'unsharded {ref}')
    copies = train.check_copies(state)
    stored = state.shards.device_bytes()
    if copies == 0 or len(set(stored)) != 1:
        raise AssertionError(f'{SHARD_FOUR}: {copies} copies, bytes a '
                             f'card {stored}')
    report = dict(
        losses=losses, grad_norms=[x[1] for x in steps],
        step_ms=[x[2] for x in steps], copies=copies,
        peak_gib=[torch.cuda.max_memory_allocated(d) / 2**30 for d in cards],
        state_gb=[3 * b / 1e9 for b in state.shards.position_bytes()],
        stored_gb=[3 * b / 1e9 for b in stored], launches=got)
    del state
    free_cuda()
    return launches, report


MOE_TRAIN_SEQ, MOE_TRAIN_STEPS = 2048, 3
MOE_TRAIN_MESH = dict(data=1, tensor=2)


def moe_sharded_training(dev, counters):
    """Phase 7d: mixtral-8x7b width at depth 1, bf16, remat, batch 1 x
    MOE_TRAIN_SEQ, MOE_TRAIN_STEPS steps from seed 0 on one batch: the
    unsharded step ("moe training (unsharded)"), then tensor 2 over two
    entries of the card ("moe sharded training (tensor)"), the first
    state freed before the second is built (~27 GB each: 1.71 G
    parameters in f32, their gradients and two moments).  Held: losses
    finite and falling, launches exactly `shard_launches` (B3 2 L tp a
    step with remat, B4 and B5 L tp), the mesh's step-1 loss within
    1e-2 of the unsharded one.  Printed: step ms, peak memory, params +
    moments a position holds.  -> (paths, report)."""
    import torch
    from skypilot_tpu_torch.models import configs
    from skypilot_tpu_torch.models import train
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    t0 = time.perf_counter()
    cfg = configs.get_config('mixtral-8x7b', n_layers=1)
    gen = torch.Generator().manual_seed(17)
    batch = {'tokens': torch.randint(0, cfg.vocab_size,
                                     (1, MOE_TRAIN_SEQ + 1),
                                     generator=gen).to(dev)}
    paths, report = {}, {}
    for label, axes in (('moe training (unsharded)', None),
                        ('moe sharded training (tensor)', MOE_TRAIN_MESH)):
        free_cuda()
        torch.cuda.reset_peak_memory_stats(dev)
        if axes is None:
            state, _ = train.create_train_state(cfg, device=dev, seed=0)
        else:
            mesh = mesh_lib.build_mesh(mesh_lib.MeshConfig(**axes),
                                       [dev] * 2)
            state, _ = train.create_train_state(cfg, mesh=mesh, seed=0)
        want = shard_launches(axes or {}, 'ring', cfg.n_layers,
                              MOE_TRAIN_STEPS)
        zero_counts(counters)
        state, steps = run_steps(dev, cfg, None, batch, MOE_TRAIN_STEPS,
                                 state)
        paths[label] = read_counts(counters)
        got = {k: paths[label][k] for k in want}
        if got != want:
            raise AssertionError(f'{label}: launches {got}, predicted {want}')
        losses = [x[0] for x in steps]
        if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f'{label}: losses {losses}')
        params, stored = state_bytes(state)
        report[label] = dict(
            losses=losses, step_ms=[x[2] for x in steps],
            peak_gib=train.peak_memory_bytes(dev) / 2**30,
            state_gb=[3 * b / 1e9 for b in params],
            stored_gb=[3 * b / 1e9 for b in stored], launches=got)
        del state
    free_cuda()
    ref = report['moe training (unsharded)']['losses'][0]
    first = report['moe sharded training (tensor)']['losses'][0]
    if not abs(first - ref) <= 1e-2 * abs(ref):
        raise AssertionError(f'moe sharded training (tensor): step-1 loss '
                             f'{first} vs unsharded {ref}')
    report['seconds'] = time.perf_counter() - t0
    return paths, report


def log_moe_training(r) -> None:
    log(f'MoE training ({card()}; mixtral-8x7b width, depth 1, bf16, '
        f'remat, batch 1 x {MOE_TRAIN_SEQ}, {MOE_TRAIN_STEPS} steps):')
    for label in ('moe training (unsharded)',
                  'moe sharded training (tensor)'):
        x = r[label]
        axes = json.dumps(MOE_TRAIN_MESH) if 'tensor' in label else '{}'
        log(f'  {label} {axes}: losses {" ".join(f"{v:.4f}" for v in x["losses"])}; step ms '
            f'{" ".join(f"{v:.1f}" for v in x["step_ms"])}; peak '
            f'{x["peak_gib"]:.2f} GiB; params + moments a position '
            f'{" ".join(f"{v:.2f}" for v in x["state_gb"])} GB, stored a '
            f'device {" ".join(f"{v:.2f}" for v in x["stored_gb"])} GB; '
            f'launches {json.dumps(x["launches"])}')
    log(f'MoE training phase: {r["seconds"]:.1f} s')


def log_sharded(r) -> None:
    log(f'sharded training ({card()}; llama3-8b width, {SHARD_LAYERS} '
        f'layers, bf16, remat, batch {SHARD_BATCH} x {SHARD_SEQ}, every '
        f'mesh position on the one card):')
    for label in ['sharded training (unsharded)'] + list(SHARD_MESHES):
        x = r[label]
        axes = SHARD_MESHES.get(label, ({}, ''))
        log(f'  {label} {json.dumps(axes[0])} {axes[1]}: losses '
            f'{" ".join(f"{v:.4f}" for v in x["losses"])}; grad_norms '
            f'{" ".join(f"{v:.3f}" for v in x["grad_norms"])}; step ms '
            f'{" ".join(f"{v:.1f}" for v in x["step_ms"])}; peak '
            f'{x["peak_gib"]:.2f} GiB; params + moments a position '
            f'{" ".join(f"{v:.2f}" for v in x["state_gb"])} GB, stored a '
            f'device {" ".join(f"{v:.2f}" for v in x["stored_gb"])} GB; '
            f'launches {json.dumps(x["launches"])}')
    if 'four cards' in r:
        x = r['four cards']
        log(f'  {SHARD_FOUR} (cuda:0-3): losses {fmt(x["losses"], 4)}; '
            f'grad_norms {fmt(x["grad_norms"], 3)}; step ms '
            f'{fmt(x["step_ms"], 1)}; peak a card {fmt(x["peak_gib"], 2)} '
            f'GiB; params + moments stored a card {fmt(x["stored_gb"], 2)} '
            f'GB; {x["copies"]} copies bit-equal to their owners; launches '
            f'{json.dumps(x["launches"])}')
    else:
        log(f'  four cards skipped: {r["four cards skipped"]}')
    for label, (loss, ref, (rel, name)) in r['f32'].items():
        log(f'  {label} f32 depth 1, batch {SHARD_BATCH} x '
            f'{SHARD_F32_SEQ}: loss {loss:.7f} vs unsharded {ref:.7f}; '
            f'largest gradient difference {rel:.3g} of max |unsharded| '
            f'({name})')
    cli = r['cli']
    log(f'  train_llama --model small over 4 entries (fsdp 2 x sequence '
        f'2): {" / ".join(cli["printed"])}; losses '
        f'{" ".join(f"{v:.4f}" for v in cli["losses"])}; step 0 restored '
        f'onto fsdp 4 ({cli["blocks"]} embedding blocks) in '
        f'{cli["restore_s"]:.2f} s, bit-equal to its files')
    log(f'sharded training phase: {r["seconds"]:.1f} s')


# ------------------------------------------------------------ phase 7e

PIPE_LAYERS, PIPE_BATCH, PIPE_SEQ, PIPE_STEPS = 4, 4, 2048, 3
PIPE_F32_LAYERS, PIPE_F32_BATCH, PIPE_F32_SEQ = 2, 2, 1024
# label -> (mesh axes over entries of the one card, SP mode,
# microbatches).
PIPE_RUNS = {
    'pipeline training (M=1)': (dict(data=1, pipeline=2), 'ring', 1),
    'pipeline training': (dict(data=1, pipeline=2), 'ring', 2),
    'pipeline training (M=4)': (dict(data=1, pipeline=2), 'ring', 4),
    'pipeline training (tensor)': (dict(data=1, pipeline=2, tensor=2),
                                   'ring', 2),
    'pipeline training (sequence)': (dict(data=1, pipeline=2, sequence=2),
                                     'ring', 2),
}


def pipeline_launches(axes, mode, n_layers, m, n_steps):
    """B3/B4/B5 launches of n_steps pipelined steps: each layer runs on
    its one stage once a microbatch, so `shard_launches` of the mesh's
    other axes times M (B3 2 L M a step, B4 and B5 L M, times tp and
    the ring's sp (sp + 1) / 2 hops)."""
    return {k: v * m for k, v in
            shard_launches(axes, mode, n_layers, n_steps).items()}


def pipeline_f32_check(dev):
    """Depth-2 f32 llama3-8b width (one layer a stage), batch
    PIPE_F32_BATCH x PIPE_F32_SEQ: pipeline 2 at M = 2 against the
    unsharded GPU step from the same seed, the loss within rtol 1e-5 and
    every gradient within 1e-3 of max |unsharded| per leaf.  -> (loss,
    unsharded loss, (worst, leaf))."""
    import torch
    from skypilot_tpu_torch.models import configs
    from skypilot_tpu_torch.models import train
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    cfg = configs.get_config('llama3-8b', n_layers=PIPE_F32_LAYERS,
                             dtype=torch.float32)
    gen = torch.Generator().manual_seed(23)
    batch = {'tokens': torch.randint(0, cfg.vocab_size,
                                     (PIPE_F32_BATCH, PIPE_F32_SEQ + 1),
                                     generator=gen).to(dev)}
    state, _ = train.create_train_state(cfg, device=dev, seed=1)
    ref_loss = float(train.value_and_grad(state, batch).detach())
    ref = full_grads(state)
    del state
    free_cuda()
    mesh = mesh_lib.build_mesh(mesh_lib.MeshConfig(data=1, pipeline=2),
                               [dev] * 2)
    state, _ = train.create_train_state(cfg, mesh=mesh, seed=1)
    loss = float(train.value_and_grad(
        state, batch, train.TrainConfig(accum_steps=2)).detach())
    if not abs(loss - ref_loss) <= 1e-5 * abs(ref_loss):
        raise AssertionError(f'pipeline f32: loss {loss} vs unsharded '
                             f'{ref_loss}')
    worst = (0.0, '')
    for name, g in full_grads(state).items():
        scale = max(float(ref[name].abs().max()), 1e-30)
        rel = float((g - ref[name]).abs().max()) / scale
        if rel > 1e-3:
            raise AssertionError(f'pipeline f32: {name} gradient {rel:.3g} '
                                 'of max |unsharded|')
        worst = max(worst, (rel, name))
    del state
    free_cuda()
    return loss, ref_loss, worst


def pipeline_training(dev, counters):
    """Phase 7e: llama3-8b width at PIPE_LAYERS layers, bf16, remat,
    batch PIPE_BATCH x PIPE_SEQ, PIPE_STEPS steps from seed 0 on one
    batch: the unsharded step, then `pipeline.pipeline_train_step` on
    PIPE_RUNS' meshes over entries of the card (two layers a stage), each
    state freed before the next is built.  Held: losses finite and
    falling, launches exactly `pipeline_launches`, step-1 loss within
    1e-2 of the unsharded step's; then the f32 cut.  Printed: step ms,
    peak memory, params + moments a mesh position.  -> (paths,
    report)."""
    import torch
    from skypilot_tpu_torch.models import configs
    from skypilot_tpu_torch.models import train
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    from skypilot_tpu_torch.parallel import pipeline
    t0 = time.perf_counter()
    cfg = configs.get_config('llama3-8b', n_layers=PIPE_LAYERS)
    gen = torch.Generator().manual_seed(19)
    batch = {'tokens': torch.randint(0, cfg.vocab_size,
                                     (PIPE_BATCH, PIPE_SEQ + 1),
                                     generator=gen).to(dev)}
    paths, report = {}, {}
    runs = {'pipeline training (unsharded)': (None, 'ring', 1)}
    runs.update(PIPE_RUNS)
    for label, (axes, mode, m) in runs.items():
        free_cuda()
        torch.cuda.reset_peak_memory_stats(dev)
        c = cfg.replace(sequence_parallel=mode)
        step = None
        if axes is None:
            state, _ = train.create_train_state(c, device=dev, seed=0)
        else:
            mesh = mesh_lib.build_mesh(mesh_lib.MeshConfig(**axes),
                                       [dev] * math.prod(axes.values()))
            state, _ = pipeline.create_pipeline_train_state(
                c, mesh=mesh, batch_size=PIPE_BATCH, seq_len=PIPE_SEQ,
                seed=0)
            step = pipeline.pipeline_train_step(c, mesh, m)
        want = pipeline_launches(axes or {}, mode, PIPE_LAYERS, m,
                                 PIPE_STEPS)
        zero_counts(counters)
        state, steps = run_steps(dev, c, None, batch, PIPE_STEPS, state,
                                 step)
        paths[label] = read_counts(counters)
        got = {k: paths[label][k] for k in want}
        if got != want:
            raise AssertionError(f'{label}: launches {got}, predicted {want}')
        losses = [x[0] for x in steps]
        if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f'{label}: losses {losses}')
        params, stored = state_bytes(state)
        report[label] = dict(
            losses=losses, step_ms=[x[2] for x in steps],
            peak_gib=train.peak_memory_bytes(dev) / 2**30,
            state_gb=[3 * b / 1e9 for b in params],
            stored_gb=[3 * b / 1e9 for b in stored], launches=got)
        del state, step
    free_cuda()
    ref = report['pipeline training (unsharded)']['losses'][0]
    for label in PIPE_RUNS:
        first = report[label]['losses'][0]
        if not abs(first - ref) <= 1e-2 * abs(ref):
            raise AssertionError(f'{label}: step-1 loss {first} vs '
                                 f'unsharded {ref}')
    report['f32'] = pipeline_f32_check(dev)
    report['seconds'] = time.perf_counter() - t0
    return paths, report


def log_pipeline(r) -> None:
    log(f'pipeline training ({card()}; llama3-8b width, {PIPE_LAYERS} '
        f'layers, bf16, remat, batch {PIPE_BATCH} x {PIPE_SEQ}, '
        f'{PIPE_STEPS} steps, every mesh position on the one card):')
    for label in ['pipeline training (unsharded)'] + list(PIPE_RUNS):
        x = r[label]
        axes, mode, m = PIPE_RUNS.get(label, ({}, '', 1))
        log(f'  {label} {json.dumps(axes)} {mode} M={m}: losses '
            f'{" ".join(f"{v:.4f}" for v in x["losses"])}; step ms '
            f'{" ".join(f"{v:.1f}" for v in x["step_ms"])}; peak '
            f'{x["peak_gib"]:.2f} GiB; params + moments a position '
            f'{" ".join(f"{v:.2f}" for v in x["state_gb"])} GB, stored a '
            f'device {" ".join(f"{v:.2f}" for v in x["stored_gb"])} GB; '
            f'launches {json.dumps(x["launches"])}')
    loss, ref, (rel, name) = r['f32']
    log(f'  pipeline 2 at M = 2, f32 depth {PIPE_F32_LAYERS}, batch '
        f'{PIPE_F32_BATCH} x {PIPE_F32_SEQ}: loss {loss:.7f} vs unsharded '
        f'{ref:.7f}; largest gradient difference {rel:.3g} of max '
        f'|unsharded| ({name})')
    log(f'pipeline training phase: {r["seconds"]:.1f} s')


# ------------------------------------------------------------ phase 7f

HOSTS = 2
HOST_MODEL = 'llama3-8b'
HOST_LAYERS, HOST_BATCH, HOST_SEQ, HOST_STEPS = 2, 2, 1024, 2
# Two rows a host: fsdp 2 splits the rows over its two batch ranks.
HOST_F32_BATCH, HOST_F32_SEQ = 2, 512
HOST_TIMEOUT_S = 300
# A host of the f32 cut (argv: batch rows and sequence a host, model,
# device): HOST_MODEL's width at depth 1, f32, global data 2 x fsdp 2,
# each host's fsdp 2 over two entries of the device; one step on its
# rows of a seeded global batch.  Host 0 then takes the same step on
# the same global mesh within its own process (no hosts: data 2 x fsdp
# 2 over four entries) and compares every parameter after the step.
# Each host prints one JSON line.
F32_HOST = '''
import json, sys, time
import torch
from skypilot_tpu_torch.models import configs, train
from skypilot_tpu_torch.parallel import distributed
from skypilot_tpu_torch.parallel import mesh as mesh_lib
B, SEQ, dev = int(sys.argv[1]), int(sys.argv[2]), torch.device(sys.argv[4])
distributed.initialize_from_env(backend='gloo', device=dev)
hosts, rank = distributed.gang()
cfg = configs.get_config(sys.argv[3], n_layers=1, dtype=torch.float32)
tokens = torch.randint(0, cfg.vocab_size, (B * hosts, SEQ + 1),
                       generator=torch.Generator().manual_seed(29))


def step(mesh, rows):
    state, _ = train.create_train_state(cfg, mesh=mesh, seed=1)
    state, m = train.train_step(state, {'tokens': rows})
    return state, float(m['loss'])


t0 = time.perf_counter()
state, loss = step(mesh_lib.build_mesh(mesh_lib.MeshConfig(data=-1, fsdp=2),
                                       [dev] * 2),
                   tokens[rank * B:(rank + 1) * B])
t1 = time.perf_counter()
out = dict(host=rank, loss=loss, digest=train.state_digest(state),
           step_s=t1 - t0, digest_s=time.perf_counter() - t1)
if rank == 0:
    ref, out['ref_loss'] = step(mesh_lib.build_mesh(
        mesh_lib.MeshConfig(data=hosts, fsdp=2), [dev] * 4, hosts=1,
        host_rank=0), tokens)
    worst = (0.0, '')
    for name, _ in state.model.named_parameters():
        got = state.shards.gather(name, dev).detach()
        want = ref.shards.gather(name, dev).detach()
        worst = max(worst, (float((got - want).abs().max()) /
                            max(float(want.abs().max()), 1e-30), name))
    out['worst'] = worst
print(json.dumps(out), flush=True)
distributed.shutdown()
'''


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def run_hosts(argvs, tmp, tag):
    """HOSTS processes, one a host of a gang on a free port (argvs[r]
    after the interpreter), each writing to <tmp>/<tag>.<rank>.log;
    -> the JSON line each printed last.  A host that fails or outlasts
    HOST_TIMEOUT_S fails the phase; every host is stopped before this
    returns."""
    import os
    repo = os.path.dirname(os.path.abspath(__file__))
    port = free_port()
    procs, logs = [], []
    try:
        for rank, argv in enumerate(argvs):
            env = {**os.environ, 'PYTHONPATH': repo,
                   'SKYTPU_NUM_HOSTS': str(len(argvs)),
                   'SKYTPU_HOST_RANK': str(rank),
                   'SKYTPU_COORDINATOR_ADDRESS': f'127.0.0.1:{port}',
                   'SKYTPU_BENCHMARK_LOG_DIR': f'{tmp}/{tag}.{rank}.bench'}
            env.pop('SKYTPU_CHECKPOINT_DIR', None)
            logs.append(f'{tmp}/{tag}.{rank}.log')
            with open(logs[-1], 'w', encoding='utf-8') as out:
                procs.append(subprocess.Popen(
                    [sys.executable] + argv, env=env, cwd=repo, stdout=out,
                    stderr=subprocess.STDOUT))
        deadline = time.monotonic() + HOST_TIMEOUT_S
        for proc in procs:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out = []
    for rank, (proc, path) in enumerate(zip(procs, logs)):
        with open(path, encoding='utf-8') as f:
            text = f.read()
        if proc.returncode != 0:
            raise AssertionError(f'{tag}: host {rank} exited '
                                 f'{proc.returncode}:\n{text[-3000:]}')
        lines = [l for l in text.splitlines() if l.startswith('{"host"')]
        if len(lines) != 1:
            raise AssertionError(f'{tag}: host {rank} printed no summary:'
                                 f'\n{text[-3000:]}')
        out.append(json.loads(lines[0]))
    return out


def host_argv(devices, backend):
    """A host's train_llama for the bf16 run."""
    return ['-m', 'skypilot_tpu_torch.train_llama', '--model', HOST_MODEL,
            '--layers', str(HOST_LAYERS), '--batch-size', str(HOST_BATCH),
            '--seq-len', str(HOST_SEQ), '--steps', str(HOST_STEPS),
            '--mesh-devices', ','.join(devices), '--dist-backend', backend]


def host_launches(n_steps, positions=1):
    """Each host's B3 / B4 / B5 launches: its local mesh's count, with
    remat and no sequence or tensor axis 2 L / L / L a step and a data
    position."""
    return {'flash_fwd': 2 * HOST_LAYERS * n_steps * positions,
            'flash_bwd_dq': HOST_LAYERS * n_steps * positions,
            'flash_bwd_dkv': HOST_LAYERS * n_steps * positions}


def one_process(devices, counters):
    """train_llama in this process over `devices` (data len(devices))
    with the hosts' global batch; -> {'losses', 'step_ms', 'peak_bytes',
    'launches'}."""
    from skypilot_tpu_torch.models import train
    zero_counts(counters)
    history, state, printed, _ = resume_run(
        ['--model', HOST_MODEL, '--layers', str(HOST_LAYERS),
         '--batch-size', str(HOST_BATCH * HOSTS), '--seq-len',
         str(HOST_SEQ), '--steps', str(HOST_STEPS), '--mesh-devices',
         ','.join(devices)])
    launched = read_counts(counters)
    step_ms = [float(v) for line in printed.splitlines()
               if line.startswith('step ms: ') for v in line.split()[2:]]
    out = dict(losses=[h['loss'] for h in history], step_ms=step_ms,
               peak_bytes=train.peak_memory_bytes(
                   state.shards.mesh if state.shards is not None
                   else state.model.device),
               launches=launched)
    del state
    free_cuda()
    return out


def hold_hosts(label, hosts, ref, want):
    """The hosts' runs against the one-process run `ref`: finite losses
    (falling over several steps), step 1 within rtol 1e-5 of it and
    later steps within 1e-2, equal digests, each host's launches exactly
    `want`."""
    ref_losses = ref['losses']
    for h in hosts:
        losses = h['losses']
        if not all(map(math.isfinite, losses)) or (
                len(losses) > 1 and not losses[-1] < losses[0]):
            raise AssertionError(f'{label}: host {h["host"]} losses {losses}')
        if not abs(losses[0] - ref_losses[0]) <= 1e-5 * abs(ref_losses[0]):
            raise AssertionError(f'{label}: host {h["host"]} step-1 loss '
                                 f'{losses[0]} vs one process '
                                 f'{ref_losses[0]}')
        for got, exp in zip(losses[1:], ref_losses[1:]):
            if not abs(got - exp) <= 1e-2 * abs(exp):
                raise AssertionError(f'{label}: host {h["host"]} losses '
                                     f'{losses} vs one process {ref_losses}')
        launched = {k: h['launches'][k] for k in want}
        if launched != want:
            raise AssertionError(f'{label}: host {h["host"]} launches '
                                 f'{launched}, predicted {want}')
    if len({h['digest'] for h in hosts}) != 1:
        raise AssertionError(f'{label}: the hosts\' digests differ: '
                             f'{[h["digest"] for h in hosts]}')


def multihost_f32_check(dev, tmp):
    """The f32 cut: F32_HOST on two hosts (gloo, both on `dev`), host 0
    holding its step against the same global mesh in one process.  ->
    (host loss, one process's, (worst parameter difference, leaf))."""
    t0 = time.perf_counter()
    hosts = run_hosts([['-c', F32_HOST, str(HOST_F32_BATCH),
                        str(HOST_F32_SEQ), HOST_MODEL, str(dev)]] * HOSTS,
                      tmp, 'f32')
    first = hosts[0]
    log(f'  f32 hosts: {time.perf_counter() - t0:.1f} s; host 0 step '
        f'{first["step_s"]:.1f} s, digest {first["digest_s"]:.1f} s')
    if len({h['digest'] for h in hosts}) != 1:
        raise AssertionError('multihost f32: the hosts\' digests differ')
    loss, ref_loss = first['loss'], first['ref_loss']
    if not abs(loss - ref_loss) <= 1e-5 * abs(ref_loss):
        raise AssertionError(f'multihost f32: loss {loss} vs one process '
                             f'{ref_loss}')
    rel, name = first['worst']
    if rel > 1e-3:
        raise AssertionError(f'multihost f32: {name} {rel:.3g} of max '
                             '|one process| after the step')
    return loss, ref_loss, (rel, name)


def multihost_training(dev, counters):
    """Phase 7f: two host processes of `train_llama` (a gang of
    SKYTPU_NUM_HOSTS=2 on a free port) at llama3-8b width, HOST_LAYERS
    layers, bf16, remat, batch HOST_BATCH x HOST_SEQ a host,
    HOST_STEPS steps from seed 0, both on cuda:0 over gloo (NCCL
    refuses two ranks on one card; gloo stages the gradients through
    host memory), against one process over a data-2 mesh of two
    entries of cuda:0 with the same global batch; with two or more
    cards also over NCCL, a card a host, and with four two hosts of
    two cards against one process over the four; then the f32 cut,
    then the "multihost pipeline" and "multihost moe" gangs
    (`pipeline_and_moe_hosts`).  -> (paths, report)."""
    import shutil
    import tempfile
    import torch
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix='skytpu_hosts_')
    paths, report = {}, {}
    laps = Laps()
    try:
        free_cuda()
        hosts = run_hosts([host_argv([str(dev)], 'gloo')] * HOSTS, tmp,
                          'gloo')
        laps('two hosts, gloo')
        free_cuda()
        ref = one_process([str(dev)] * HOSTS, counters)
        laps('one process')
        paths['multihost training (one process)'] = ref['launches']
        hold_hosts('multihost training', hosts, ref,
                   host_launches(HOST_STEPS))
        # Each host's count is its own run's; the path's is host 0's.
        paths['multihost training'] = dict(hosts[0]['launches'])
        report['gloo, one card'] = dict(hosts=hosts, ref=ref)
        n_cards = torch.cuda.device_count()
        if n_cards >= 2:
            hosts = run_hosts([host_argv([f'cuda:{r}'], 'nccl')
                               for r in range(HOSTS)], tmp, 'nccl')
            hold_hosts('multihost training (nccl)', hosts, ref,
                       host_launches(HOST_STEPS))
            report['nccl, a card a host'] = dict(hosts=hosts, ref=ref)
            laps('two hosts, nccl')
        else:
            report['nccl skipped'] = (f'{n_cards} card: NCCL takes one '
                                      'card a rank')
        if n_cards >= 4:
            hosts = run_hosts(
                [host_argv([f'cuda:{2 * r}', f'cuda:{2 * r + 1}'], 'nccl')
                 for r in range(HOSTS)], tmp, 'four')
            ref4 = one_process([f'cuda:{i}' for i in range(4)], counters)
            # Global data 4 (a card a row) both ways.
            hold_hosts('multihost training (four cards)', hosts, ref4,
                       host_launches(HOST_STEPS, 2))
            report['nccl, two hosts x two cards'] = dict(hosts=hosts,
                                                        ref=ref4)
            laps('four cards')
        report['f32'] = multihost_f32_check(dev, tmp)
        laps('f32 cut')
        more_paths, report['pipeline and moe'] = pipeline_and_moe_hosts(
            dev, counters, tmp, laps)
        paths.update(more_paths)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    report['seconds'] = time.perf_counter() - t0
    report['laps'] = laps.seconds
    return paths, report


# "multihost pipeline": profile_pipeline as a gang, one stage a host;
# the global batch of PIPE_HOST_BATCH rows (one a host) x HOST_SEQ,
# M = PIPE_HOST_M, 1 + PIPE_HOST_TIMED steps (profile_pipeline's warm-up
# and its timed steps) from seed 0.
PIPE_HOST_LAYERS, PIPE_HOST_BATCH, PIPE_HOST_M, PIPE_HOST_TIMED = 2, 2, 2, 1
# "multihost moe": the MoE width at depth 1, a row of HOST_SEQ tokens a
# host, one step, the capacity factor lowered so that about half of the
# assignments are dropped and the hosts' prefix decides which.
MOE_HOST_MODEL, MOE_HOST_CAPACITY = 'mixtral-8x7b', 0.5
# A host of the MoE run (argv: device, backend, model, seq, capacity):
# `train.create_train_state` and one `train.train_step` on its row of a
# seeded global batch (one row a host), data over the hosts, one entry
# a host.  Prints one JSON line.
MOE_HOST = '''
import json, sys, time
import torch
from skypilot_tpu_torch.models import configs, train
from skypilot_tpu_torch.ops import attention
from skypilot_tpu_torch.parallel import distributed
from skypilot_tpu_torch.parallel import mesh as mesh_lib
dev, backend = torch.device(sys.argv[1]), sys.argv[2]
seq, cap = int(sys.argv[4]), float(sys.argv[5])
distributed.initialize_from_env(backend=backend, device=dev)
hosts, rank = distributed.gang()
cfg = configs.get_config(sys.argv[3], n_layers=1, remat=True,
                         expert_capacity_factor=cap)
tokens = torch.randint(0, cfg.vocab_size, (hosts, seq + 1),
                       generator=torch.Generator().manual_seed(37))
cuda = dev.type == 'cuda'
state, _ = train.create_train_state(
    cfg, mesh=mesh_lib.build_mesh(mesh_lib.MeshConfig(data=-1), [dev]),
    seed=0)
if cuda:
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize(dev)
before = dict(attention.LAUNCHES)
t0 = time.perf_counter()
state, m = train.train_step(state, {'tokens': tokens[rank:rank + 1].to(dev)})
loss, norm = float(m['loss']), float(m['grad_norm'])
if cuda:
    torch.cuda.synchronize(dev)
step_ms = (time.perf_counter() - t0) * 1e3
reduce_s, reduce_bytes = state.host_reduce.take()
t1 = time.perf_counter()
digest = train.state_digest(state)
print(json.dumps(dict(
    host=rank, backend=distributed.group_backend(), losses=[loss],
    grad_norms=[norm], step_ms=[step_ms], reduce_ms=[reduce_s * 1e3],
    reduce_bytes=reduce_bytes,
    peak_bytes=train.peak_memory_bytes(dev) if cuda else None,
    launches={k: attention.LAUNCHES[k] - before[k] for k in before},
    digest=digest, digest_s=time.perf_counter() - t1)), flush=True)
distributed.shutdown()
'''


def pipeline_host_argv(devices, backend):
    """A host's profile_pipeline for the "multihost pipeline" run."""
    return ['-m', 'skypilot_tpu_torch.profile_pipeline', '--devices',
            ','.join(devices), '--model', HOST_MODEL, '--layers',
            str(PIPE_HOST_LAYERS), '--batch', str(PIPE_HOST_BATCH),
            '--seq', str(HOST_SEQ), '--microbatches', str(PIPE_HOST_M),
            '--steps', str(PIPE_HOST_TIMED), '--dist-backend', backend]


def pipeline_host_summary(h):
    """A profile_pipeline host's JSON line in `hold_hosts`' form."""
    run = h['pipeline'][str(PIPE_HOST_M)]
    return dict(host=h['host'], backend=h['backend'], losses=run['losses'],
                step_ms=run['step_ms'], reduce_ms=[run['reduce_ms']],
                reduce_bytes=run['reduce_bytes'],
                boundary_ms=run['boundary_ms'],
                boundary_bytes=run['boundary_bytes'],
                peak_bytes=max(run['peak_bytes'] or [0]),
                launches=run['launches'], digest=h['digest'],
                digest_s=h['digest_s'])


def pipeline_one_process(dev, counters):
    """The "multihost pipeline" run in this process: pipeline 2 over two
    entries of `dev` (phase 7e's path) on the same global batch and
    seed; -> {'losses', 'step_ms', 'peak_bytes', 'launches'}."""
    import torch
    from skypilot_tpu_torch import profile_pipeline
    from skypilot_tpu_torch.models import configs
    from skypilot_tpu_torch.models import train
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    from skypilot_tpu_torch.parallel import pipeline
    cfg = configs.get_config(HOST_MODEL, n_layers=PIPE_HOST_LAYERS,
                             remat=True)
    mesh = mesh_lib.build_mesh(mesh_lib.MeshConfig(data=1, pipeline=HOSTS),
                               [dev] * HOSTS)
    state, _ = pipeline.create_pipeline_train_state(
        cfg, mesh=mesh, batch_size=PIPE_HOST_BATCH, seq_len=HOST_SEQ,
        seed=0)
    batch = {'tokens': profile_pipeline.batch_tokens(
        cfg.vocab_size, PIPE_HOST_BATCH, HOST_SEQ).to(dev)}
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts(counters)
    state, steps = run_steps(dev, cfg, None, batch, 1 + PIPE_HOST_TIMED,
                             state, pipeline.pipeline_train_step(
                                 cfg, mesh, PIPE_HOST_M))
    out = dict(losses=[x[0] for x in steps], step_ms=[x[2] for x in steps],
               peak_bytes=train.peak_memory_bytes(dev),
               launches=read_counts(counters))
    del state
    free_cuda()
    return out


def moe_one_process(dev, counters):
    """The "multihost moe" run in this process: a data-2 mesh of two
    entries of `dev` on the hosts' global batch and seed; -> {'losses',
    'step_ms', 'peak_bytes', 'launches'}."""
    import torch
    from skypilot_tpu_torch.models import configs
    from skypilot_tpu_torch.models import train
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    cfg = configs.get_config(MOE_HOST_MODEL, n_layers=1, remat=True,
                             expert_capacity_factor=MOE_HOST_CAPACITY)
    tokens = torch.randint(0, cfg.vocab_size, (HOSTS, HOST_SEQ + 1),
                           generator=torch.Generator().manual_seed(37))
    mesh = mesh_lib.build_mesh(mesh_lib.MeshConfig(data=HOSTS),
                               [dev] * HOSTS, hosts=1, host_rank=0)
    state, _ = train.create_train_state(cfg, mesh=mesh, seed=0)
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts(counters)
    state, steps = run_steps(dev, cfg, None, {'tokens': tokens.to(dev)}, 1,
                             state)
    out = dict(losses=[x[0] for x in steps], grad_norms=[x[1] for x in steps],
               step_ms=[x[2] for x in steps],
               peak_bytes=train.peak_memory_bytes(dev),
               launches=read_counts(counters))
    del state
    free_cuda()
    return out


def pipeline_host_launches(n_steps):
    """Each pipeline host's B3 / B4 / B5 launches: its stage's share,
    2 L_h M / L_h M / L_h M a step (L_h its layers, remat)."""
    per = PIPE_HOST_LAYERS // HOSTS * PIPE_HOST_M * n_steps
    return {'flash_fwd': 2 * per, 'flash_bwd_dq': per, 'flash_bwd_dkv': per}


def compact_buffer_check(dev):
    """A host's compacted expert buffer against the full one: one MoE
    layer at MOE_HOST_MODEL width with random bf16 stacks on HOSTS x
    HOST_SEQ random rows, dispatched whole ([E, C, d]) and as HOSTS
    hosts' rows, each given the earlier hosts' counts as its prefix
    (`moe.dispatch(prefix=, n_global=)`: [E, W, d], its kept slots).
    Held: the hosts' combined outputs within 1e-4 of max |whole|; a
    zero prefix on the last host leaves that bound.  -> (widths, whole
    width, max abs difference, max |whole|, the fault's difference)."""
    import torch
    from skypilot_tpu_torch.models import configs
    from skypilot_tpu_torch.models import moe
    cfg = configs.get_config(MOE_HOST_MODEL, n_layers=1,
                             expert_capacity_factor=MOE_HOST_CAPACITY)
    gen = torch.Generator(device=dev).manual_seed(3)
    n, e = HOSTS * HOST_SEQ, cfg.n_experts
    tokens = torch.randn(n, cfg.d_model, generator=gen, device=dev,
                         dtype=cfg.dtype)
    logits = torch.randn(n, e, generator=gen, device=dev)
    stacks = [torch.randn(shape, generator=gen, device=dev,
                          dtype=cfg.dtype) * 0.02
              for shape in ((e, cfg.d_model, cfg.d_ff),
                            (e, cfg.d_model, cfg.d_ff),
                            (e, cfg.d_ff, cfg.d_model))]

    def products(rows, prefix):
        x, combine, _ = moe.dispatch(tokens[rows], logits[rows], cfg,
                                     prefix=prefix, n_global=n)
        return x.shape[1], moe.combine_outputs(
            combine, moe.expert_products(x, *stacks, cfg))
    whole_w, whole = products(slice(0, n), None)
    widths, parts, fault = [], [], None
    prefix = torch.zeros(e, dtype=torch.int64, device=dev)
    for h in range(HOSTS):
        rows = slice(h * HOST_SEQ, (h + 1) * HOST_SEQ)
        w, out = products(rows, prefix)
        widths.append(w)
        parts.append(out)
        if h == HOSTS - 1:
            fault = products(rows, torch.zeros_like(prefix))[1]
        _, _, gate_idx = moe.route(logits[rows], cfg.expert_top_k)
        prefix = prefix + moe.expert_counts(gate_idx, e)
    top = float(whole.abs().max())
    diff = float((torch.cat(parts) - whole).abs().max())
    planted = float((torch.cat(parts[:-1] + [fault]) - whole).abs().max())
    del stacks
    if not diff <= 1e-4 * top:
        raise AssertionError(f'multihost moe: the hosts\' compact buffers '
                             f'are {diff:.3e} off the whole buffer\'s '
                             f'outputs (max {top:.3e})')
    if not planted > 1e-4 * top:
        raise AssertionError(f'multihost moe: a zero prefix is only '
                             f'{planted:.3e} off (max {top:.3e})')
    return widths, whole_w, diff, top, planted


def moe_host_launches():
    """Each MoE host's B3 / B4 / B5 launches: depth 1, one step, remat,
    one position: 2 / 1 / 1."""
    return {'flash_fwd': 2, 'flash_bwd_dq': 1, 'flash_bwd_dkv': 1}


def pipeline_and_moe_hosts(dev, counters, tmp, laps):
    """Phase 7f's "multihost pipeline" and "multihost moe" runs (module
    docstring); -> (paths, report)."""
    import torch
    paths, report = {}, {}
    free_cuda()
    hosts = [pipeline_host_summary(h) for h in run_hosts(
        [pipeline_host_argv([str(dev)], 'gloo')] * HOSTS, tmp, 'pipe')]
    laps('pipeline hosts, gloo')
    free_cuda()
    ref = pipeline_one_process(dev, counters)
    laps('pipeline one process')
    paths['multihost pipeline (one process)'] = ref['launches']
    hold_hosts('multihost pipeline', hosts, ref,
                   pipeline_host_launches(1 + PIPE_HOST_TIMED))
    paths['multihost pipeline'] = {k: hosts[0]['launches'].get(k, 0)
                                   for k in counters}
    report['pipeline, gloo, one card'] = dict(hosts=hosts, ref=ref)
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        nccl = [pipeline_host_summary(h) for h in run_hosts(
            [pipeline_host_argv([f'cuda:{r}'], 'nccl')
             for r in range(HOSTS)], tmp, 'pipe-nccl')]
        hold_hosts('multihost pipeline (nccl)', nccl, ref,
                       pipeline_host_launches(1 + PIPE_HOST_TIMED))
        report['pipeline, nccl, a card a host'] = dict(hosts=nccl, ref=ref)
        laps('pipeline hosts, nccl')
    else:
        report['pipeline nccl skipped'] = (f'{n_cards} card: NCCL takes '
                                           'one card a rank')
    free_cuda()
    hosts = run_hosts([['-c', MOE_HOST, str(dev), 'gloo', MOE_HOST_MODEL,
                        str(HOST_SEQ), str(MOE_HOST_CAPACITY)]] * HOSTS,
                      tmp, 'moe')
    laps('moe hosts, gloo')
    free_cuda()
    ref = moe_one_process(dev, counters)
    laps('moe one process')
    paths['multihost moe (one process)'] = ref['launches']
    hold_hosts('multihost moe', hosts, ref, moe_host_launches())
    report['moe compact buffer'] = compact_buffer_check(dev)
    free_cuda()
    # After the backward: the clip's norm over every gradient.
    for h in hosts:
        if not abs(h['grad_norms'][0] - ref['grad_norms'][0]) <= (
                1e-2 * ref['grad_norms'][0]):
            raise AssertionError(f'multihost moe: host {h["host"]} grad '
                                 f'norm {h["grad_norms"]} vs one process '
                                 f'{ref["grad_norms"]}')
    paths['multihost moe'] = {k: hosts[0]['launches'].get(k, 0)
                              for k in counters}
    report['moe, gloo, one card'] = dict(hosts=hosts, ref=ref)
    return paths, report


def log_pipeline_and_moe_hosts(r) -> None:
    log(f'multihost pipeline ({card()}; {HOST_MODEL} width, '
        f'{PIPE_HOST_LAYERS} layers (one a stage, a stage a host), bf16, '
        f'remat, global batch {PIPE_HOST_BATCH} x {HOST_SEQ} (a row a '
        f'host), M = {PIPE_HOST_M}, {1 + PIPE_HOST_TIMED} steps; '
        'profile_pipeline hosts):')
    for label in ('pipeline, gloo, one card', 'pipeline, nccl, a card a host'):
        if label not in r:
            continue
        x = r[label]
        ref = x['ref']
        log(f'  {label}: one process (pipeline 2 over two entries) losses '
            f'{fmt(ref["losses"], 6)}; step ms {fmt(ref["step_ms"], 1)}; '
            f'peak {(ref["peak_bytes"] or 0) / 2**30:.2f} GiB; launches '
            f'{json.dumps(ref["launches"])}')
        for h in x['hosts']:
            log(f'  {label}: host {h["host"]} ({h["backend"]}) losses '
                f'{fmt(h["losses"], 6)}; timed step ms '
                f'{fmt(h["step_ms"], 1)}; boundary {h["boundary_bytes"]:.0f} '
                f'bytes and {h["boundary_ms"]:.1f} ms a timed step; '
                f'{h["reduce_bytes"]:.0f} bytes reduced a timed step in '
                f'{h["reduce_ms"][0]:.1f} ms; peak '
                f'{(h["peak_bytes"] or 0) / 2**30:.2f} GiB; launches '
                f'{json.dumps(h["launches"])}; digest {h["digest"][:16]} '
                f'({h["digest_s"]:.1f} s)')
    if 'pipeline nccl skipped' in r:
        log(f'  pipeline nccl skipped: {r["pipeline nccl skipped"]}')
    x = r['moe, gloo, one card']
    ref = x['ref']
    log(f'multihost moe ({card()}; {MOE_HOST_MODEL} width, 1 layer, bf16, '
        f'remat, capacity factor {MOE_HOST_CAPACITY}, 1 x {HOST_SEQ} a '
        f'host, one step): one process (data 2 over two entries) loss '
        f'{fmt(ref["losses"], 6)}; grad norm {fmt(ref["grad_norms"], 6)}; '
        f'step ms {fmt(ref["step_ms"], 1)}; peak '
        f'{(ref["peak_bytes"] or 0) / 2**30:.2f} GiB')
    widths, whole_w, diff, top, planted = r['moe compact buffer']
    log(f'  moe compact buffer: the hosts\' widths {widths} of C = '
        f'{whole_w}; their outputs {diff:.3e} off the whole buffer\'s '
        f'(max {top:.3e}, bound 1e-4 of it); a zero prefix on the last '
        f'host {planted:.3e} off')
    for h in x['hosts']:
        log(f'  moe: host {h["host"]} ({h["backend"]}) loss '
            f'{fmt(h["losses"], 6)}; grad norm {fmt(h["grad_norms"], 6)}; '
            f'step ms {fmt(h["step_ms"], 1)}; '
            f'{h["reduce_bytes"]} bytes reduced in {h["reduce_ms"][0]:.1f} '
            f'ms; peak {(h["peak_bytes"] or 0) / 2**30:.2f} GiB; launches '
            f'{json.dumps(h["launches"])}; digest {h["digest"][:16]} '
            f'({h["digest_s"]:.1f} s)')


def fmt(values, digits) -> str:
    return ' '.join(f'{v:.{digits}f}' for v in values)


def log_multihost(r) -> None:
    log(f'multihost training ({card()}; {HOST_MODEL} width, {HOST_LAYERS} '
        f'layers, bf16, remat, batch {HOST_BATCH} x {HOST_SEQ} a host, '
        f'{HOSTS} hosts, {HOST_STEPS} steps):')
    for label in ('gloo, one card', 'nccl, a card a host',
                  'nccl, two hosts x two cards'):
        if label not in r:
            continue
        x = r[label]
        for h in [dict(x['ref'], host='one process', backend='-',
                       reduce_ms=[], reduce_bytes=0, digest='-')] + x['hosts']:
            log(f'  {label}: host {h["host"]} ({h["backend"]}) losses '
                f'{fmt(h["losses"], 6)}; step ms {fmt(h["step_ms"], 1)}; '
                f'reduction ms a step {fmt(h["reduce_ms"], 1)}; '
                f'{h["reduce_bytes"]} bytes reduced a step; peak '
                f'{(h["peak_bytes"] or 0) / 2**30:.2f} GiB; launches '
                f'{json.dumps(h["launches"])}; digest {h["digest"][:16]} '
                f'({h.get("digest_s", 0):.1f} s)')
    if 'nccl skipped' in r:
        log(f'  nccl skipped: {r["nccl skipped"]}')
    loss, ref, (rel, name) = r['f32']
    log(f'  f32 depth 1, batch {HOST_F32_BATCH} x {HOST_F32_SEQ} a host, '
        f'fsdp 2 a host over two entries of one device (gloo): loss {loss:.7f} vs one process '
        f'{ref:.7f}; largest parameter difference {rel:.3g} of max |one '
        f'process| ({name}); digests equal')
    log_pipeline_and_moe_hosts(r['pipeline and moe'])
    log(f'multihost training phase: {r["seconds"]:.1f} s '
        f'({json.dumps(r["laps"])})')


# ------------------------------------------------------------ phase 7g

ELASTIC_LABEL = 'elastic training'
ELASTIC_BATCH, ELASTIC_SEQ, ELASTIC_SAVE_EVERY = 4, 2048, 2
# (mesh entries, steps) of each size: the first size runs one step past
# its newest save (step 2), so that the shrink computes step 3 again.
ELASTIC_SCHEDULE = ((4, 4), (2, 2), (4, 1))
ELASTIC_DISK_GB = 50.0           # three 15.2 GB steps (max_to_keep 3)


# Directories deleted on threads of their own (joined before `main`
# returns): deleting phase 7g's three 15.2 GB steps takes ~15 s of disk
# work that no later phase waits for.
REMOVALS = []


def remove_in_background(path: str) -> None:
    thread = threading.Thread(target=shutil.rmtree, args=(path, True),
                              name=f'remove {path}')
    thread.start()
    REMOVALS.append(thread)


def elastic_devices(dev, n):
    """n entries: cuda:0 ... cuda:n-1 with four cards, else n entries of
    the one card (one copy a block)."""
    import torch
    if torch.cuda.device_count() >= 4:
        return [torch.device('cuda', i) for i in range(n)]
    return [dev] * n


def elastic_steps(trainer, n, cards):
    """n train_steps, each timed on the host clock between synchronises
    of every card (a save step includes its snapshot) ->
    [(step, loss, ms)]."""
    import torch
    out = []
    for _ in range(n):
        for c in cards:
            torch.cuda.synchronize(c)
        t0 = time.perf_counter()
        [(step, loss)] = trainer.train_steps(1)
        for c in cards:
            torch.cuda.synchronize(c)
        out.append((step, loss, (time.perf_counter() - t0) * 1e3))
    return out


def elastic_expected_journal():
    """The journal's (event, step, from, to, restored, status) sequence
    ELASTIC_SCHEDULE must leave."""
    out, step = [], 0
    sizes = [n for n, _ in ELASTIC_SCHEDULE]
    for i, (n, steps) in enumerate(ELASTIC_SCHEDULE):
        if i:
            out.append(('gang_resize', None, sizes[i - 1], n, None, None))
            step = max(s for s in range(step) if
                       s % ELASTIC_SAVE_EVERY == 0) + 1
        out.append(('train_resume', step, None, None, bool(i), None))
        for s in range(step, step + steps):
            if s % ELASTIC_SAVE_EVERY == 0:
                out += [('checkpoint_save_start', s, None, None, None, None),
                        ('checkpoint_save_end', s, None, None, None, 'ok')]
        step += steps
    return out


def elastic_resize(trainer, devices, digests, reason):
    """Drain the saves, resize to `devices` and hold the restore: the
    step after the newest save, and its state digest equal to the one
    taken when that step was saved.  -> the numbers to print."""
    from skypilot_tpu_torch.models import train
    out = {}
    t0 = time.perf_counter()
    trainer.checkpointer.wait_until_finished()
    out['drain_s'] = time.perf_counter() - t0
    saved = max(s for s in digests if s < trainer.step)
    trainer.state = None   # freed before the new state is made
    free_cuda()
    t0 = time.perf_counter()
    trainer.resize(devices, reason=reason)
    out['resize_s'] = time.perf_counter() - t0
    if (trainer.step, trainer.resumed_from_checkpoint) != (saved + 1, True):
        raise AssertionError(f'resize to {len(devices)}: step {trainer.step}, '
                             f'restored {trainer.resumed_from_checkpoint}; '
                             f'want step {saved + 1}')
    t0 = time.perf_counter()
    if train.state_digest(trainer.state) != digests[saved]:
        raise AssertionError(f'resize to {len(devices)}: the restored state '
                             f'differs from step {saved}\'s')
    out['digest_s'] = time.perf_counter() - t0
    out['resumed'] = trainer.step
    return out


def elastic_training(dev, counters):
    """Phase 7g: an ElasticTrainer at llama3-8b width, depth 1, through
    ELASTIC_SCHEDULE (fsdp 4 -> 2 -> 4) under a SKYTPU_HOME of its own;
    launches held to `shard_launches` of each size; the restored states
    held to the saved ones by `train.state_digest`, the recomputed step
    to its first run, the journal to `elastic_expected_journal`.
    -> (launches, report)."""
    import torch
    from skypilot_tpu_torch.models import configs
    from skypilot_tpu_torch.models import train
    from skypilot_tpu_torch.models.elastic import ElasticTrainer
    from skypilot_tpu_torch.observability import events
    t_phase = time.perf_counter()
    cfg = configs.get_config('llama3-8b', n_layers=1)
    tcfg = train.TrainConfig(fused_ce=True)
    root = tempfile.mkdtemp(prefix='skytpu_elastic_')
    report = {'free_gb': shutil.disk_usage(root).free / 1e9, 'sizes': [],
              'four_cards': torch.cuda.device_count() >= 4}
    home = os.environ.get('SKYTPU_HOME')
    os.environ['SKYTPU_HOME'] = f'{root}/home'
    try:
        if report['free_gb'] < ELASTIC_DISK_GB:
            raise AssertionError(f'elastic training needs ~{ELASTIC_DISK_GB} '
                                 f'GB free under {root}: '
                                 f'{report["free_gb"]:.1f} GB')
        free_cuda()
        want = {k: 0 for k in TRAIN_KERNELS}
        for n, steps in ELASTIC_SCHEDULE:
            for k, v in shard_launches({'fsdp': n}, 'ring', 1, steps).items():
                want[k] += v
        zero_counts(counters)
        t0 = time.perf_counter()
        n0 = ELASTIC_SCHEDULE[0][0]
        trainer = ElasticTrainer(
            cfg, tcfg, checkpoint_dir=f'{root}/ckpt',
            batch_size=ELASTIC_BATCH, seq_len=ELASTIC_SEQ,
            devices=elastic_devices(dev, n0),
            save_interval_steps=ELASTIC_SAVE_EVERY)
        report['init_s'] = time.perf_counter() - t0
        digests, first, report['recomputed'] = {}, {}, {}
        try:
            for i, (n, steps) in enumerate(ELASTIC_SCHEDULE):
                devices = elastic_devices(dev, n)
                cards = list(dict.fromkeys(devices))
                size = {'n': n}
                if i:
                    size.update(elastic_resize(trainer, devices, digests,
                                               f'{ELASTIC_LABEL} {i}'))
                if trainer.mesh.shape['fsdp'] != n:
                    raise AssertionError(f'{n} entries: mesh '
                                         f'{trainer.mesh.shape}')
                size['stored_gb'] = [
                    3 * b / 1e9 for b in trainer.state.shards.device_bytes()]
                for c in cards:
                    torch.cuda.reset_peak_memory_stats(c)
                # The newest save before the next resize: its state is the
                # one the resize must restore.
                start = trainer.step
                last_save = max((s for s in range(start, start + steps)
                                 if s % ELASTIC_SAVE_EVERY == 0), default=None)
                size['steps'] = []
                for _ in range(steps):
                    size['steps'] += elastic_steps(trainer, 1, cards)
                    if (trainer.step - 1 == last_save and
                            i + 1 < len(ELASTIC_SCHEDULE)):
                        t0 = time.perf_counter()
                        digests[last_save] = train.state_digest(trainer.state)
                        size['saved_digest_s'] = time.perf_counter() - t0
                size['peak_gib'] = [train.peak_memory_bytes(c) / 2**30
                                    for c in cards]
                report['sizes'].append(size)
                for step, loss, _ in size['steps']:
                    if not math.isfinite(loss):
                        raise AssertionError(f'step {step}: loss {loss}')
                    if step not in first:
                        first[step] = loss
                        continue
                    report['recomputed'][step] = (first[step], loss)
                    if not abs(loss - first[step]) <= 1e-2 * abs(first[step]):
                        raise AssertionError(
                            f'recomputed step {step}: loss {loss} vs its '
                            f'first run {first[step]}')
        finally:
            trainer.close()
        launches = read_counts(counters)
        got = {k: launches[k] for k in want}
        if got != want:
            raise AssertionError(f'{ELASTIC_LABEL}: launches {got}, '
                                 f'predicted {want}')
        if sorted(report['recomputed']) != [3]:
            raise AssertionError(f'recomputed steps '
                                 f'{sorted(report["recomputed"])}')
        records = events.training_journal().read()
        seq = [(e['event'], e.get('step'), e.get('from'), e.get('to'),
                e.get('restored'), e.get('status')) for e in records]
        if seq != elastic_expected_journal():
            raise AssertionError(f'journal {seq}, expected '
                                 f'{elastic_expected_journal()}')
        report['saves_s'] = [e['duration_s'] for e in records
                             if e['event'] == 'checkpoint_save_end']
        report['journal'] = len(records)
        report['launches'] = got
        del trainer
    finally:
        t0 = time.perf_counter()
        if home is None:
            os.environ.pop('SKYTPU_HOME', None)
        else:
            os.environ['SKYTPU_HOME'] = home
        remove_in_background(root)
        free_cuda()
        report['cleanup_s'] = time.perf_counter() - t0
    report['seconds'] = time.perf_counter() - t_phase
    return {ELASTIC_LABEL: launches}, report


def log_elastic(r) -> None:
    where = ('cuda:0-3 / cuda:0-1' if r['four_cards'] else
             'entries of cuda:0')
    log(f'{ELASTIC_LABEL} ({card()}; llama3-8b width, depth 1, bf16, '
        f'remat, fused CE, batch {ELASTIC_BATCH} x {ELASTIC_SEQ}, saves '
        f'every {ELASTIC_SAVE_EVERY} steps, fsdp '
        f'{" -> ".join(str(n) for n, _ in ELASTIC_SCHEDULE)} over {where}): '
        f'init {r["init_s"]:.2f} s')
    for x in r['sizes']:
        resized = (f'; drained saves {x["drain_s"]:.2f} s, resize '
                   f'(restore + setup) {x["resize_s"]:.2f} s, resumed at '
                   f'step {x["resumed"]}, state digest equal to the saved '
                   f'step\'s ({x["digest_s"]:.2f} s)' if 'resize_s' in x
                   else '')
        saved = (f'; the saved step\'s digest {x["saved_digest_s"]:.2f} s'
                 if 'saved_digest_s' in x else '')
        log(f'  fsdp {x["n"]}{resized}; steps '
            f'{" ".join(f"{s}: {l:.6f} ({ms:.1f} ms)" for s, l, ms in x["steps"])}'
            f'{saved}; params + moments stored a card '
            f'{fmt(x["stored_gb"], 2)} GB; peak a card '
            f'{fmt(x["peak_gib"], 2)} GiB')
    for step, (a, b) in r['recomputed'].items():
        log(f'  recomputed step {step}: {b:.6f} vs its first run {a:.6f} '
            f'(relative {abs(b - a) / abs(a):.3g})')
    log(f'  journal: {r["journal"]} records as expected; saves '
        f'{fmt(r["saves_s"], 2)} s; launches {json.dumps(r["launches"])}; '
        f'free disk before {r["free_gb"]:.1f} GB; clean-up '
        f'{r["cleanup_s"]:.2f} s; the phase {r["seconds"]:.1f} s')


# ------------------------------------------------------------ phase 8


def train_reference_check(dev):
    """Depth-1 f32 llama3-8b: loss and gradients, GPU vs CPU."""
    import torch
    from skypilot_tpu_torch.models import configs
    from skypilot_tpu_torch.models import convert
    from skypilot_tpu_torch.models import train
    from skypilot_tpu_torch.models.transformer import init_params
    cfg = configs.get_config('llama3-8b', n_layers=1, dtype=torch.float32)
    gpu_model = init_params(cfg, seed=1, device=dev, trainable=True)
    cpu_model = convert.from_jax_params(
        cfg, convert.to_jax_params(gpu_model), device='cpu', trainable=True)
    tokens = torch.randint(0, cfg.vocab_size, (1, 257),
                           generator=torch.Generator().manual_seed(3))
    loss = {}
    for model in (gpu_model, cpu_model):
        t = tokens.to(model.device)
        out = train.loss_fn(model(t[:, :-1]), t[:, 1:])
        out.backward()
        loss[model.device.type] = float(out.detach())
    if not abs(loss['cuda'] - loss['cpu']) <= 1e-3 * abs(loss['cpu']):
        raise AssertionError(f'train reference: loss GPU {loss["cuda"]} vs '
                             f'CPU {loss["cpu"]}')
    worst = (0.0, '')
    for (name, pg), (_, pc) in zip(gpu_model.named_parameters(),
                                   cpu_model.named_parameters()):
        ref = pc.grad
        rel = (float((pg.grad.cpu() - ref).abs().max()) /
               max(float(ref.abs().max()), 1e-30))
        if rel > 1e-3:
            raise AssertionError(f'train reference: {name} gradient GPU vs '
                                 f'CPU {rel:.3g} of max |CPU|')
        worst = max(worst, (rel, name))
    return loss, worst


def expect_launches(path, counts, launched, idle=()):
    """Fail unless every kernel in `launched` ran on the path and none
    in `idle` did."""
    missing = [n for n in launched if counts[n] <= 0]
    stray = [n for n in idle if counts[n] > 0]
    if missing or stray:
        raise AssertionError(f'{path}: kernels not launched {missing}, '
                             f'launched but not on this path {stray}')


def more_serving(cfg, model, dev, counters, new_tokens):
    """The paths each zeroed just before and read just after, around
    the engine work alone (the reference paths and the holds run after
    the read): the replica front, 16-slot speculation, dense serving
    over HTTP, the legacy loop, the KV handoff.  Returns {path: launch
    counts}."""
    paths = {}
    paths['replica front'], front = replica_front(cfg, model, dev, counters,
                                                  new_tokens)
    expect_launches('replica front', paths['replica front'],
                    ('paged_attention', 'flash_fwd'),
                    ('paged_attention_int8',))
    hold = front['budget_hold']
    log(f'replica front ({card()}; host-clock times, printed, not held): '
        f'{front["wall_s"]:.1f} s for the phase with both servers and the '
        f'holds; async /generate {front["generate_s"] * 1e3:.1f} ms for '
        f'{new_tokens} tokens, TTFT {front["ttft_ms"]:.1f} ms; 5 '
        f'concurrent /generate_stream {front["streams_tokens_per_s"]:.1f} '
        f'tokens/s ({front["streams_s"]:.2f}s); greedy /generate, streams '
        f'and the stream /drain let finish equal to the threaded front; '
        f'batch class = the first {BATCH_BUDGET} unclamped tokens; decode '
        f'budget: {BUDGET_PROMPT - 1} one-token pieces, '
        f'{front["budget_s"] * 1e3:.1f} ms for the request, tokens '
        + ('equal to the unclamped run' if hold is None else
           f'held token by token ({hold_summary([hold])})')
        + f'; a client gone after two events: cancelled at '
        f'{front["gone_tokens"]} tokens, slots and pages back in '
        f'{front["freed_s"] * 1e3:.0f} ms; sentinel (calls, signatures, '
        f'steady) {json.dumps(front["sentinel"])} (the decode budget\'s '
        f'one-token chunk 0 and width-1 continuations are new signatures '
        f'by design, not recompiles); launches '
        f'{json.dumps(paths["replica front"])}')
    paths['spec beyond one bucket'], spec = spec_past_one_bucket(
        cfg, model, dev, new_tokens, counters)
    expect_launches('spec beyond one bucket',
                    paths['spec beyond one bucket'],
                    ('paged_attention_int8', 'flash_fwd'))
    blocked, one_call = verify_tick_cost(cfg, model, dev)
    log(f'int8 + spec(4) at 16 slots (80 rows): greedy equal to spec-off; '
        f'accept len {spec["spec_accept_len_mean"]}; verify tick in two '
        f'64-row blocks {blocked["ms"]:.3f} ms device by '
        f'{blocked["timed_by"]} ({blocked["ms_with_host"]:.3f} with host), '
        f'as one 128-row call {one_call["ms"]:.3f} by {one_call["timed_by"]} '
        f'({one_call["ms_with_host"]:.3f})')

    zero_counts(counters)
    dense = dense_serving(cfg, model, dev, new_tokens)
    paths['dense serving'] = read_counts(counters)
    expect_launches('dense serving', paths['dense serving'], ('flash_fwd',),
                    ('paged_attention', 'paged_attention_int8'))
    holds = hold_dense(cfg, model, dense, new_tokens)
    log(f'dense http: {dense["tokens_per_s"]:.1f} tokens/s over 6 '
        f'concurrent requests ({dense["wall"]:.2f}s); TTFT (100-token '
        f'prompt, idle engine) {dense["ttft_ms"]:.1f} ms; ticks '
        f'{dense["ticks"]}; /generate_stream == /generate, '
        f'/generate_text streamed == whole; vs decode.generate: '
        f'{hold_summary(holds)}')

    zero_counts(counters)
    legacy = legacy_serving(cfg, model, dev, new_tokens, dense)
    paths['legacy'] = read_counts(counters)
    expect_launches('legacy', paths['legacy'], ('flash_fwd',),
                    ('paged_attention', 'paged_attention_int8'))
    holds = [hold_tokens('legacy vs pipelined', cfg, model, p, g, ref)
             for p, g, ref in zip(dense['prompts'], legacy['tokens'],
                                  dense['tokens'])]
    log(f'legacy (pipelined=False): {legacy["tokens_per_s"]:.1f} tokens/s; '
        f'vs the dense pipelined engine: {hold_summary(holds)}')

    paths['handoff'], moved = handoff(cfg, model, dev, new_tokens, counters)
    expect_launches('handoff', paths['handoff'],
                    ('flash_fwd', 'paged_attention', 'paged_attention_int8'))
    kernel = {'bf16': 'paged_attention', 'int8': 'paged_attention_int8'}
    for pool, r in moved.items():
        expect_launches(f'handoff export ({pool})', r['export_launches'],
                        ('flash_fwd',),
                        ('paged_attention', 'paged_attention_int8'))
        expect_launches(f'handoff import ({pool} pool)',
                        r['import_launches'], (kernel[pool],))
        exported = r['export_launches']['flash_fwd']
        imported = r['import_launches'][kernel[pool]]
        log(f'handoff into a {pool} pool: {r["frame_bytes"]} frame bytes, '
            f'export {r["export_ms"]:.1f} ms ({exported} B3), import '
            f'{r["import_ms"]:.1f} ms, then {imported} {kernel[pool]} '
            f'launches;'
            f' beside a second engine on another stream the same tokens, '
            f'every ticket counter at 0; vs one engine: '
            f'{hold_summary([r["hold"]])}')
    log(f'launches: {json.dumps(paths)}')
    return paths


# ------------------------------------------------------------ phase 5d

SLICE_MAX_LEN = 8192       # llama3-8b's max_seq_len
SLICE_PROMPT = 7936        # prefill_sp's prompt: 1984 rows a rank at sp 4
SLICE_LENGTHS = (3000, 7900, 100)
SLICE_THRESHOLD = 1024
SLICE_ENGINE = dict(max_len=SLICE_MAX_LEN, slots=4, prefill_chunk=512,
                    kv_pages=2048, page_size=16)
PREFILL_CHUNK = 512


def chunked_prefill(cfg, model, ids):
    """The single engine's chunked prefill of `ids` into a fresh cache:
    its own chunk loop (`batching_engine.prefill_piece`), 512-token
    pieces, chunk 0 through B3, later ones masked."""
    from skypilot_tpu_torch.models import decode
    from skypilot_tpu_torch.serve import batching_engine
    cache, consumed = None, 0
    while consumed < len(ids):
        cache, consumed = batching_engine.prefill_piece(
            cfg, model, ids, cache, consumed, len(ids), PREFILL_CHUNK,
            max_len=SLICE_MAX_LEN, device=model.device,
            prefill=decode.prefill, prefill_chunk=decode.prefill_chunk)
    return cache


def first_token(cfg, model, cache, last):
    """The greedy token after a prompt whose cache holds its first n-1
    positions: the engine's first tick, one masked decode step of the
    prompt's last token."""
    import torch
    from skypilot_tpu_torch.models import decode
    # A copy: the step writes position n-1 of the cache it is given.
    cache = {'k': cache['k'].clone(), 'v': cache['v'].clone(),
             'index': int(cache['index']) - 1}
    logits, _ = decode.decode_step(cfg, model, torch.tensor(
        [[last]], device=model.device), cache)
    return int(logits[0].argmax())


def host_ms(fn, iters: int = 3) -> float:
    """Host-clock ms a call, the device drained before and after
    (`--bench-prefill`'s time where it runs on the host)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def slice_ops(dev):
    """ring_attention and ulysses_attention over sp ranks that all name
    `dev` (sp 2 and 4) at [1, 32, 8192, 128] / [1, 8, 8192, 128] bf16,
    held within 2e-2 of the plain causal attention of the whole
    sequence; B3's launches per call; device ms a call (5 calls after a
    warm-up) beside one B3 call over the whole sequence."""
    import torch
    from skypilot_tpu_torch.ops import attention
    from skypilot_tpu_torch.ops import ring_attention
    from skypilot_tpu_torch.ops import ulysses_attention
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    gen = torch.Generator(device=dev).manual_seed(SLICE_MAX_LEN)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(
        torch.bfloat16) for shape in ((1, 32, SLICE_MAX_LEN, 128),
                                      (1, 8, SLICE_MAX_LEN, 128),
                                      (1, 8, SLICE_MAX_LEN, 128)))
    ref = attention._blockwise_attention(  # pylint: disable=protected-access
        q, k, v, causal=True, sm_scale=128 ** -0.5)
    out = {'whole sequence (one B3)': dict(
        **device_time(lambda: attention.flash_attention(q, k, v), iters=5,
                      warmup=1), b3_launches=1)}
    for name, fn in (('ring', ring_attention.ring_attention),
                     ('ulysses', ulysses_attention.ulysses_attention)):
        for sp in (2, 4):
            mesh = mesh_lib.build_mesh(mesh_lib.MeshConfig(sequence=sp),
                                       [dev] * sp)
            before = attention.LAUNCHES['flash_fwd']
            got = fn(q, k, v, mesh=mesh)
            launched = attention.LAUNCHES['flash_fwd'] - before
            torch.cuda.synchronize()
            want = sp * (sp + 1) // 2 if name == 'ring' else sp
            if launched != want:
                raise AssertionError(f'{name} sp={sp}: B3 ran {launched} '
                                     f'times, expected {want}')
            err = check_close(f'{name} sp={sp}', got, ref, 2e-2)
            out[f'{name} sp={sp}'] = dict(
                max_abs_err=err, b3_launches=launched,
                **device_time(lambda: fn(q, k, v, mesh=mesh), iters=5,
                              warmup=1))
    return out


def slice_prefill(cfg, model, dev, counters):
    """prefill_sp at sp 1, 2 and 4 on a 7,936-token prompt: the caches
    against decode.prefill's (sp 1 bit for bit; sp 2 and 4 within 2e-2
    relative, Frobenius, per leaf), B3 launched L sp (sp + 1) / 2
    times, the first greedy token held at its own context; device ms (3
    calls after a warm-up) and host-clock ms per sp, beside the engine's
    chunked prefill of the same prompt."""
    import torch
    from skypilot_tpu_torch.models import decode
    from skypilot_tpu_torch.serve import slice_replica
    ids = prompt(8100, SLICE_PROMPT, cfg.vocab_size)
    tokens = torch.tensor([ids], dtype=torch.int32, device=dev)
    _, want = decode.prefill(cfg, model, tokens, max_len=SLICE_MAX_LEN)
    # The engine's tokens [0, n-1) go into the cache; decode.prefill's
    # positions are causal, so its first n-1 are that cache.
    ref_token = first_token(cfg, model, want, ids[-1])
    out = {}
    for sp in (1, 2, 4):
        mesh = slice_replica.build_slice_mesh(sp, cfg, sequence=sp,
                                              devices=[dev] * sp)

        def run(mesh=mesh):
            return decode.prefill_sp(cfg, model, tokens, mesh=mesh,
                                     max_len=SLICE_MAX_LEN)
        zero_counts(counters)
        got = run()
        launched = read_counts(counters)['flash_fwd']
        torch.cuda.synchronize()
        if launched != cfg.n_layers * sp * (sp + 1) // 2:
            raise AssertionError(f'prefill_sp sp={sp}: B3 ran {launched} '
                                 'times')
        errs = {}
        for leaf in ('k', 'v'):
            a, b = got[leaf].float(), want[leaf].float()
            if sp == 1 and not torch.equal(got[leaf], want[leaf]):
                raise AssertionError(f'prefill_sp sp=1 {leaf} differs '
                                     'from prefill')
            rel = float(torch.linalg.vector_norm(a - b) /
                        torch.linalg.vector_norm(b))
            if rel > 2e-2:
                raise AssertionError(f'prefill_sp sp={sp} {leaf}: relative '
                                     f'difference {rel:.3g} > 2e-2')
            errs[leaf] = (float((a - b).abs().max()), rel)
        token = first_token(cfg, model, got, ids[-1])
        hold = hold_tokens(f'prefill_sp sp={sp} first token', cfg, model,
                           ids, [token], [ref_token])
        del got
        out[sp] = dict(launches=launched, errs=errs, hold=hold,
                       **device_time(run, iters=3, warmup=1,
                                     host_gaps_ok=True),
                       host_ms=host_ms(run))
    chunked = lambda: chunked_prefill(cfg, model, ids[:-1])  # noqa: E731
    out['chunked'] = dict(**device_time(chunked, iters=3, warmup=1),
                          host_ms=host_ms(chunked))
    return out


def slice_window(cfg, model, dev, counters, prompts, new_tokens, *, sp,
                 quantize_kv):
    """SliceReplicaEngine(num_hosts=sp, sequence=sp) over sp ranks that
    name `dev`: the prompts submitted at once (under the queue's lock,
    so one admission takes them all), counts zeroed just before and
    read once the engine has read its last tick.  -> (launches, tokens,
    stats)."""
    from skypilot_tpu_torch.serve import plane_check
    from skypilot_tpu_torch.serve import slice_replica
    engine = slice_replica.SliceReplicaEngine(
        cfg, model, num_hosts=sp, sequence=sp,
        mesh=slice_replica.build_slice_mesh(sp, cfg, sequence=sp,
                                            devices=[dev] * sp),
        sp_threshold=SLICE_THRESHOLD, quantize_kv=quantize_kv, device=dev,
        **SLICE_ENGINE)
    try:
        zero_counts(counters)
        with engine._cond:  # pylint: disable=protected-access
            handles = [engine.submit(p, new_tokens) for p in prompts]
        tokens = [list(h.result(timeout=600)) for h in handles]
        plane_check.settle(engine)
        launches = read_counts(counters)
        stats = engine.stats()
    finally:
        engine.stop()
    return launches, tokens, stats


def single_tokens(cfg, model, dev, prompts, new_tokens, quantize_kv):
    """The single-process paged engine's greedy tokens on the same
    prompts (the reference path of the slice holds)."""
    from skypilot_tpu_torch.serve import batching_engine
    engine = batching_engine.ContinuousBatchingEngine(
        cfg, model, quantize_kv=quantize_kv, device=dev, **SLICE_ENGINE)
    try:
        with engine._cond:  # pylint: disable=protected-access
            handles = [engine.submit(p, new_tokens) for p in prompts]
        return [list(h.result(timeout=600)) for h in handles]
    finally:
        engine.stop()


def slice_launches_expected(cfg, prompts, sp, ticks, quantize_kv):
    """The counts PERF.md predicts: B3 L sp (sp + 1) / 2 per prompt at or
    over the threshold (its SP prefill) and L per shorter prompt (one
    chunk 0 of at most 512 tokens); B1 (B2 for an int8 pool) L per
    tick; the other paged kernel 0."""
    b3 = sum(cfg.n_layers * (sp * (sp + 1) // 2
                             if len(p) - 1 >= SLICE_THRESHOLD else 1)
             for p in prompts)
    paged = cfg.n_layers * ticks
    return {'flash_fwd': b3,
            'paged_attention': 0 if quantize_kv else paged,
            'paged_attention_int8': paged if quantize_kv else 0}


def slice_serving(cfg, model, dev, counters, new_tokens):
    """Phase 5d: the slice path on phase 4's llama3-8b weights.  ->
    ({path: launch counts}, report)."""
    from skypilot_tpu_torch.serve import async_server
    from skypilot_tpu_torch.serve import model_server
    from skypilot_tpu_torch.serve import plane_check
    lap = Laps()
    report = {'ops': slice_ops(dev), 'laps': lap.seconds}
    free_cuda()
    lap('ops')
    report['prefill'] = slice_prefill(cfg, model, dev, counters)
    free_cuda()
    lap('prefill_sp')
    prompts = [prompt(8200 + i, n, cfg.vocab_size)
               for i, n in enumerate(SLICE_LENGTHS)]
    paths = {}
    for path, sp, quantize_kv in (('slice', 4, False),
                                  ('slice (int8 pool)', 2, True)):
        launches, tokens, stats = slice_window(
            cfg, model, dev, counters, prompts, new_tokens, sp=sp,
            quantize_kv=quantize_kv)
        paths[path] = launches
        want = slice_launches_expected(cfg, prompts, sp, stats['ticks'],
                                       quantize_kv)
        got = {k: launches[k] for k in want}
        if got != want:
            raise AssertionError(f'{path}: launches {got}, predicted {want} '
                                 f'({stats["ticks"]} ticks)')
        lap(path)
        sl = stats['slice']
        if sl['sp_prefills'] != 2 or sl['sync_count'] <= 0:
            raise AssertionError(f'{path}: slice stats {sl}')
        if not all('slice_sync_ms' in s for s in stats['recent_spans']):
            raise AssertionError(f'{path}: a span without slice_sync_ms')
        free_cuda()
        ref = single_tokens(cfg, model, dev, prompts, new_tokens,
                            quantize_kv)
        holds = [hold_tokens(f'{path} prompt {len(p)}', cfg, model, p, g,
                             r, quantized=quantize_kv)
                 for p, g, r in zip(prompts, tokens, ref)]
        report[path] = dict(ticks=stats['ticks'], slice=sl, holds=holds,
                            tokens=tokens)
        free_cuda()
        lap(f'{path} holds')
    # One greedy /generate through ModelServer's slice engine behind the
    # asyncio front: the 3,000-token prompt alone (an SP prefill).
    server = model_server.ModelServer(
        'llama3-8b', params=model, continuous_batching=True,
        max_len=SLICE_MAX_LEN, max_batch=4, prefill_chunk=PREFILL_CHUNK,
        kv_pages=2048, page_size=16, num_hosts=4, slice_sequence=4,
        slice_devices=[dev] * 4, sp_threshold=SLICE_THRESHOLD, device=dev,
        overrides={'n_layers': cfg.n_layers})
    port, stop = async_server.start_background(server)
    try:
        zero_counts(counters)
        status, body = post(port, {'prompt_ids': [prompts[0]],
                                   'max_new_tokens': new_tokens})
        plane_check.settle(server.engine)
        paths['slice http'] = read_counts(counters)
        status_h, _, raw = http_call(port, '/health')
        health = json.loads(raw)
    finally:
        stop()
        server.close()
    if status != 200 or body['tokens'][0] != report['slice']['tokens'][0]:
        raise AssertionError(f'slice http: {status}, tokens differ from the '
                             'slice engine\'s')
    if status_h != 200 or health.get('slice', {}).get('sp_prefills') != 1:
        raise AssertionError(f'slice http /health: {status_h} '
                             f'{health.get("slice")}')
    want = slice_launches_expected(cfg, prompts[:1], 4,
                                   health['engine']['ticks'], False)
    got = {k: paths['slice http'][k] for k in want}
    if got != want:
        raise AssertionError(f'slice http: launches {got}, predicted {want}')
    lap('slice http')
    report['seconds'] = time.perf_counter() - lap.t0
    return paths, report


def log_slice(report) -> None:
    ops = report['ops']
    log(f'slice ops ({card()}; [1, 32, 8192, 128] / [1, 8, 8192, 128] '
        f'bf16, ranks on one card, held within 2e-2 of the plain causal '
        f'attention): ' + '; '.join(
            f'{name} {r["ms"]:.3f} ms device by {r["timed_by"]}, '
            f'{r["b3_launches"]} B3'
            + (f', max_abs_err {r["max_abs_err"]:.3g}'
               if 'max_abs_err' in r else '') for name, r in ops.items()))
    pre = report['prefill']
    log(f'prefill_sp ({SLICE_PROMPT} tokens, llama3-8b at depth '
        f'{SERVE_LAYERS}, ranks on one card): ' + '; '.join(
            f'sp {sp}: {r["ms"]:.2f} ms device by {r["timed_by"]}, '
            f'{r["host_ms"]:.2f} ms by the host clock, B3 {r["launches"]}, k/v max |diff| '
            f'{r["errs"]["k"][0]:.3g}/{r["errs"]["v"][0]:.3g} (relative '
            f'{r["errs"]["k"][1]:.3g}/{r["errs"]["v"][1]:.3g}), first token '
            f'{hold_summary([r["hold"]])}'
            for sp, r in pre.items() if sp != 'chunked')
        + f'; chunked prefill (512) {pre["chunked"]["ms"]:.2f} ms device '
        f'by {pre["chunked"]["timed_by"]}, '
        f'{pre["chunked"]["host_ms"]:.2f} ms by the host clock')
    for path in ('slice', 'slice (int8 pool)'):
        r = report[path]
        log(f'{path}: {r["ticks"]} ticks; slice {json.dumps(r["slice"])}; '
            f'vs the single paged engine: {hold_summary(r["holds"])}')
    log(f'slice phase: {report["seconds"]:.1f} s (s by step: '
        f'{json.dumps(report["laps"])})')


# ------------------------------------------------------------ phase 5e

TENSOR_LENGTHS = (5, 100, 300, 700)
# The tensor slices' prompts: two over the SP threshold, one under it
# (phase 5d's shapes at shorter lengths; prefill_sp runs SLICE_PROMPT).
TENSOR_SLICE_LENGTHS = (1100, 2000, 100)
TENSOR_ENGINE = dict(max_len=1024, slots=8, prefill_chunk=512,
                     kv_pages=1024, page_size=16)
TENSOR_SERVER = dict(max_len=1024, max_batch=8, prefill_chunk=512,
                     kv_pages=1024, page_size=16)
TENSOR_HANDOFF = 100       # tokens of the handoff prompt


def tensor_mesh(dev, tp, sequence=None):
    """A mesh over `dev` repeated: tensor tp (and a sequence axis)."""
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    axes = {'tensor': tp} if sequence is None else {'sequence': sequence,
                                                    'tensor': tp}
    return mesh_lib.Mesh([dev] * math.prod(axes.values()), axes)


def tensor_cut(cfg, model, mesh):
    """Phase 4's weights cut into the mesh's tensor ranks (printed: the
    cut's seconds and the ranks' GiB)."""
    import torch
    from skypilot_tpu_torch.models import convert
    t0 = time.perf_counter()
    tp = convert.to_tensor_parallel(cfg, model, mesh)
    torch.cuda.synchronize()
    gib = sum(p.numel() * p.element_size() for p in tp.parameters()) / 2**30
    log(f'tensor {tp.tp}: shards cut in {time.perf_counter() - t0:.1f} s, '
        f'{gib:.2f} GiB over {tp.tp} ranks on one card')
    return tp


def tensor_predicted(cfg, tp, n_prompts, ticks, *, kernel, b3_each=1):
    """PERF.md's prediction for a tensor window: B3 L tp per prompt
    (its chunk 0; `b3_each` hops of a ring instead), the window's paged
    kernel L tp per tick, the other paged kernel 0."""
    paged = cfg.n_layers * tp * ticks
    return {'flash_fwd': cfg.n_layers * tp * n_prompts * b3_each,
            'paged_attention': paged if kernel == 'paged_attention' else 0,
            'paged_attention_int8': (paged if kernel == 'paged_attention_int8'
                                     else 0)}


def hold_launches(path, launched, want):
    got = {k: launched[k] for k in want}
    if got != want:
        raise AssertionError(f'{path}: launches {got}, predicted {want}')


def engine_window(cfg, model, dev, counters, prompts, new_tokens, **kw):
    """A ContinuousBatchingEngine on `model`: the prompts submitted at
    once (under the queue's lock: one admission takes them all), counts
    zeroed just before and read once the worker has read its last
    tick.  -> (launches, tokens, stats)."""
    from skypilot_tpu_torch.serve import batching_engine
    from skypilot_tpu_torch.serve import plane_check
    engine = batching_engine.ContinuousBatchingEngine(
        cfg, model, device=dev, **dict(TENSOR_ENGINE, **kw))
    try:
        zero_counts(counters)
        with engine._cond:  # pylint: disable=protected-access
            handles = [engine.submit(p, new_tokens) for p in prompts]
        tokens = [list(h.result(timeout=900)) for h in handles]
        plane_check.settle(engine)
        launches = read_counts(counters)
        stats = engine.stats()
    finally:
        engine.stop()
    return launches, tokens, stats


def tensor_http(cfg, model, dev, counters, prompts, new_tokens,
                name='llama3-8b', **server_kw):
    """ModelServer(name) over `model` behind the asyncio front: the
    prompts as concurrent /generate requests, counts zeroed just before
    and read once the engine has read its last tick; /health after.  ->
    (launches, tokens, health, the server's weights)."""
    from skypilot_tpu_torch.serve import async_server
    from skypilot_tpu_torch.serve import model_server
    from skypilot_tpu_torch.serve import plane_check
    server = model_server.ModelServer(name, params=model,
                                      overrides={'n_layers': cfg.n_layers},
                                      continuous_batching=True, device=dev,
                                      **server_kw)
    port, stop = async_server.start_background(server)
    try:
        zero_counts(counters)
        results = [None] * len(prompts)

        def run(i):
            results[i] = post(port, {'prompt_ids': [prompts[i]],
                                     'max_new_tokens': new_tokens})
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        plane_check.settle(server.engine)
        launches = read_counts(counters)
        status, _, raw = http_call(port, '/health')
        health = json.loads(raw)
    finally:
        stop()
        server.close()
    for code, body in results:
        if code != 200:
            raise AssertionError(f'/generate: {code} {body}')
    if status != 200:
        raise AssertionError(f'/health: {status} {health}')
    return launches, [r[1]['tokens'][0] for r in results], health, \
        server.params


def tensor_holds(path, cfg, tp, one, prompts, got, ref, quantized=False):
    """Every token of `got` held at its own context under the tensor
    model's own forward (flash vs masked, `hold_tokens`), the tensor-1
    engine's tokens `ref` saying where they part, and the tensor
    model's logits held to the tensor-1 model `one`'s there."""
    return [hold_tokens(f'{path} prompt {len(p)}', cfg, tp, p, g, r,
                        quantized=quantized, one=one)
            for p, g, r in zip(prompts, got, ref)]


def planted_drift(cfg, tp, one, ids, got):
    """The drift / delta1 (`tensor_drift`) of `got` at its context with
    a fault planted in this process for the call: rank tp-1's partial
    left out of every row-parallel sum (`tensor_parallel.all_reduce`
    patched, then restored).  It must pass DRIFT_LIMIT, or the limit
    would not see a dropped partial."""
    from unittest import mock
    import torch
    from skypilot_tpu_torch.models import tensor_parallel
    real = tensor_parallel.all_reduce

    def dropped(parts, dtype):
        return real(list(parts[:-1]) + [torch.zeros_like(parts[-1])],
                    dtype)
    n = len(ids)
    ctx = list(ids) + list(got[:-1])
    with mock.patch.object(tensor_parallel, 'all_reduce', dropped):
        a = path_logits(cfg, tp, ctx, use_flash=True)[n - 1:]
    drift, delta1 = tensor_drift(cfg, one, ctx, n, a)
    if drift <= DRIFT_LIMIT * delta1:
        raise AssertionError(
            f'planted fault (a dropped partial): logits {drift:.4f} from '
            f'the tensor-1 model\'s, within {DRIFT_LIMIT:g} x delta '
            f'{delta1:.3g}: the limit does not see it')
    return drift / delta1


def tensor_f32_check(dev):
    """A depth-1 f32 cut of llama3-8b at tensor 2: the GPU engine (the
    kernels, ranks on the card) and the CPU engine (the plain versions,
    CPU ranks) give the same greedy tokens, paged and dense."""
    import torch
    from skypilot_tpu_torch.models import configs
    from skypilot_tpu_torch.models import convert
    from skypilot_tpu_torch.models.transformer import init_params
    from skypilot_tpu_torch.serve import batching_engine
    cfg = configs.get_config('llama3-8b', n_layers=1, dtype=torch.float32)
    gpu_model = init_params(cfg, seed=1, device=dev)
    cpu_model = convert.from_jax_params(
        cfg, convert.to_jax_params(gpu_model), device='cpu')
    models = {'gpu': convert.to_tensor_parallel(cfg, gpu_model,
                                                tensor_mesh(dev, 2)),
              'cpu': convert.to_tensor_parallel(
                  cfg, cpu_model, tensor_mesh(torch.device('cpu'), 2))}
    del gpu_model, cpu_model
    prompts = [prompt(210, 12, cfg.vocab_size),
               prompt(211, 40, cfg.vocab_size)]
    for mode, kv_pages in (('paged', 32), ('dense', None)):
        toks = {}
        for where, model in models.items():
            engine = batching_engine.ContinuousBatchingEngine(
                cfg, model, max_len=128, slots=2, kv_pages=kv_pages,
                page_size=16, device=model.device)
            try:
                toks[where] = [engine.generate(p, 12) for p in prompts]
            finally:
                engine.stop()
        if toks['gpu'] != toks['cpu']:
            raise AssertionError(f'tensor 2 {mode}: GPU vs CPU greedy '
                                 f'tokens differ:\n{toks["gpu"]}\n'
                                 f'{toks["cpu"]}')


# A tensor-2 prefill export against the tensor-1 export: each layer's
# k and v within this relative difference (Frobenius over the layer).
# PERF.md gives a sound run's largest layer and a planted fault's.
HANDOFF_LAYER_LIMIT = 5e-2


def layer_rel(one, two):
    """The largest relative difference of a layer's k or v between two
    decoded frames (Frobenius over the layer), and the whole leaves'
    ({'k': x, 'v': y})."""
    import numpy as np
    rel, by_layer = {}, []
    for name in ('k', 'v'):
        a, b = one[name].astype(np.float64), two[name].astype(np.float64)
        rel[name] = float(np.linalg.norm(a - b) / np.linalg.norm(a))
        by_layer += [float(np.linalg.norm(a[i] - b[i]) /
                           np.linalg.norm(a[i])) for i in range(a.shape[0])]
    return max(by_layer), rel


def tensor_handoff(cfg, tp, model, dev):
    """The wire across tensor degrees on the card: a tensor-2 prefill
    export of a 100-token prompt against the tensor-1 export (header and
    hashes equal; every layer's k and v within HANDOFF_LAYER_LIMIT
    relative; the whole leaves' relative difference printed), and again
    with the ranks' heads joined in reverse order on export (a planted
    fault, `decode._join_heads` patched for that call), which must pass
    the limit; the tensor-1 frame imported into a tensor-2 and a
    tensor-1 engine and exported again: byte-equal frames.  The
    tensor-2 engine then decodes the prompt from the imported pages
    (its tokens held, and held to the tensor-1 model's logits)."""
    from unittest import mock
    from skypilot_tpu_torch.models import decode
    from skypilot_tpu_torch.serve import batching_engine
    from skypilot_tpu_torch.serve import handoff as handoff_lib
    ids = prompt(220, TENSOR_HANDOFF, cfg.vocab_size)
    engines = {name: batching_engine.ContinuousBatchingEngine(
        cfg, m, device=dev, **TENSOR_ENGINE)
        for name, m in (('one', model), ('two', tp))}
    try:
        frames = {n: e.export_prefill(ids, binary=True)
                  for n, e in engines.items()}
        one = handoff_lib.decode_binary(frames['one'])
        two = handoff_lib.decode_binary(frames['two'])
        for key in ('hashes', 'page_size'):
            if one[key] != two[key]:
                raise AssertionError(f'tensor handoff: {key} differs')
        if one['k'].shape != two['k'].shape:
            raise AssertionError('tensor handoff: page shapes differ')
        worst, rel = layer_rel(one, two)
        if worst > HANDOFF_LAYER_LIMIT:
            raise AssertionError(f'tensor handoff: a layer\'s relative '
                                 f'difference {worst:.3g} > '
                                 f'{HANDOFF_LAYER_LIMIT:g}')
        real_join = decode._join_heads  # pylint: disable=protected-access
        with mock.patch.object(
                decode, '_join_heads',
                lambda leaves: real_join(leaves[::-1]
                                         if isinstance(leaves, list)
                                         else leaves)):
            swapped = handoff_lib.decode_binary(
                engines['two'].export_prefill(ids, binary=True))
        fault, _ = layer_rel(one, swapped)
        if fault <= HANDOFF_LAYER_LIMIT:
            raise AssertionError(
                f'planted fault (heads joined in reverse): a layer\'s '
                f'relative difference {fault:.3g} within '
                f'{HANDOFF_LAYER_LIMIT:g}: the limit does not see it')
        again = {}
        for n, e in engines.items():
            e.import_pages(one['hashes'], one['page_size'], one['k'],
                           one['v'])
            again[n] = e.export_prefix_pages(64, binary=True)
        if again['one'] != again['two'] or len(again['one']) < 1:
            raise AssertionError('tensor handoff: the re-exported frames '
                                 'differ across tensor degrees')
        got = engines['two'].generate(ids, 32, timeout=600)
        ref = engines['one'].generate(ids, 32, timeout=600)
    finally:
        for e in engines.values():
            e.stop()
    hold = hold_tokens('tensor 2 handoff', cfg, tp, ids, got, ref,
                       one=model)
    return dict(frame_bytes=len(frames['two']), rel=rel,
                layer_rel_max=worst, fault_layer_rel_max=fault,
                layer0_equal=bool(one['k'][0].tobytes() ==
                                  two['k'][0].tobytes()),
                round_trip_bytes=len(again['two']), hold=hold)


def tensor_ticks(cfg, model, dev, tps):
    """profile_decode's paged tick (8 slots at depths 5..700, 10 timed
    ticks, one under the profiler: the profiler's post-processing of a
    tensor tick's ~8,400 kernels is what costs) at each tensor degree:
    host ms, device ms, kernels (printed, not held)."""
    from skypilot_tpu_torch import profile_decode
    out = {}
    for tp, m in tps.items():
        r = profile_decode.profile_tick(cfg, m, dev, ticks=10, n_prof=1)
        out[tp] = {k: r[k] for k in ('tick_ms', 'device_ms_per_tick',
                                     'device_idle_share',
                                     'kernels_per_tick')}
    return out


def tensor_prefill_sp(cfg, model, tp_slice, mesh, dev, counters):
    """prefill_sp of SLICE_PROMPT tokens over sequence 2 x tensor 2 on
    the card: B3 L x 3 x 2 (each tensor rank's ring), the cache within
    2e-2 relative of decode.prefill's (tensor 1), the first greedy token
    held at its own context; device ms (one call after a warm-up)."""
    import torch
    from skypilot_tpu_torch.models import decode
    ids = prompt(8100, SLICE_PROMPT, cfg.vocab_size)
    tokens = torch.tensor([ids], dtype=torch.int32, device=dev)
    _, want = decode.prefill(cfg, model, tokens, max_len=SLICE_MAX_LEN)
    ref_token = first_token(cfg, model, want, ids[-1])

    def run():
        return decode.prefill_sp(cfg, tp_slice, tokens, mesh=mesh,
                                 max_len=SLICE_MAX_LEN)
    zero_counts(counters)
    got = run()
    launched = read_counts(counters)['flash_fwd']
    torch.cuda.synchronize()
    sp, tp = mesh.shape['sequence'], mesh.shape['tensor']
    if launched != cfg.n_layers * tp * sp * (sp + 1) // 2:
        raise AssertionError(f'tensor prefill_sp: B3 ran {launched} times')
    errs = {}
    for leaf in ('k', 'v'):
        a = torch.cat(got[leaf], dim=2).float()
        b = want[leaf].float()
        rel = float(torch.linalg.vector_norm(a - b) /
                    torch.linalg.vector_norm(b))
        if rel > 2e-2:
            raise AssertionError(f'tensor prefill_sp {leaf}: relative '
                                 f'difference {rel:.3g} > 2e-2')
        errs[leaf] = rel
    joined = {'k': torch.cat(got['k'], dim=2), 'v': torch.cat(got['v'], 2),
              'index': got['index']}
    del got
    token = first_token(cfg, model, joined, ids[-1])
    hold = hold_tokens('tensor prefill_sp first token', cfg, model, ids,
                       [token], [ref_token])
    del joined, want
    return dict(launches=launched, errs=errs, hold=hold,
                **device_time(run, iters=1, warmup=1, host_gaps_ok=True))


def tensor_serving(cfg, model, dev, counters, new_tokens):
    """Phase 5e: tensor-parallel serving on phase 4's llama3-8b weights,
    every rank on the one card.  -> ({path: launch counts}, report)."""
    import torch
    from skypilot_tpu_torch.models import tensor_parallel
    lap = Laps()
    L = cfg.n_layers
    report = {'ticks': {}, 'laps': lap.seconds}
    prompts = [prompt(8300 + i, n, cfg.vocab_size)
               for i, n in enumerate(TENSOR_LENGTHS)]
    paths = {}
    # The tensor-1 engine on the same prompts: the counts the tensor
    # paths multiply, and the tokens the holds compare with.
    base, ref_tokens, base_stats = engine_window(cfg, model, dev, counters,
                                                 prompts, new_tokens)
    hold_launches('tensor 1 base', base, tensor_predicted(
        cfg, 1, len(prompts), base_stats['ticks'], kernel='paged_attention'))
    free_cuda()
    lap('tensor 1 base')

    tp2 = tensor_cut(cfg, model, tensor_mesh(dev, 2))
    launches, tokens, health, _ = tensor_http(
        cfg, tp2, dev, counters, prompts, new_tokens, tensor=2,
        tensor_devices=[dev] * 2, **TENSOR_SERVER)
    paths['tensor 2'] = launches
    ticks = health['engine']['ticks']
    hold_launches('tensor 2', launches, tensor_predicted(
        cfg, 2, len(prompts), ticks, kernel='paged_attention'))
    if launches['flash_fwd'] != 2 * base['flash_fwd']:
        raise AssertionError('tensor 2: B3 is not twice tensor 1\'s')
    if health['engine']['tensor_degree'] != 2:
        raise AssertionError(f'tensor 2 /health: {health["engine"]}')
    lap('tensor 2')
    report['tensor 2'] = dict(ticks=ticks, holds=tensor_holds(
        'tensor 2', cfg, tp2, model, prompts, tokens, ref_tokens))
    report['planted drift'] = planted_drift(cfg, tp2, model, prompts[2],
                                            tokens[2])
    free_cuda()
    lap('tensor 2 holds')

    zero_counts(counters)
    dense, dense_tokens, dense_stats = engine_window(
        cfg, tp2, dev, counters, prompts, new_tokens, kv_pages=None)
    legacy, legacy_tokens, _ = engine_window(
        cfg, tp2, dev, counters, prompts, new_tokens, kv_pages=None,
        pipelined=False)
    lap('tensor 2 dense')
    paths['tensor 2 dense'] = {k: dense[k] + legacy[k] for k in dense}
    for name, got in (('tensor 2 dense', dense), ('tensor 2 legacy',
                                                  legacy)):
        hold_launches(name, got, tensor_predicted(cfg, 2, len(prompts), 0,
                                                  kernel=None))
    report['tensor 2 dense'] = dict(
        ticks=dense_stats['ticks'],
        holds=tensor_holds('tensor 2 dense', cfg, tp2, model, prompts,
                           dense_tokens, ref_tokens) +
        tensor_holds('tensor 2 legacy', cfg, tp2, model, prompts,
                     legacy_tokens, ref_tokens))
    free_cuda()
    lap('tensor 2 dense holds')
    report['handoff'] = tensor_handoff(cfg, tp2, model, dev)
    lap('handoff')
    tensor_f32_check(dev)
    free_cuda()
    lap('f32 cut')

    # sequence 2 x tensor 2: tensor 2's ranks over the slice's mesh (the
    # repeated card needs no copy).
    mesh = tensor_mesh(dev, 2, sequence=2)
    tp_slice = tensor_parallel.TensorParallel(cfg, list(tp2.ranks), mesh)
    report['prefill_sp'] = tensor_prefill_sp(cfg, model, tp_slice, mesh,
                                             dev, counters)
    free_cuda()
    lap('prefill_sp')
    slice_prompts = [prompt(8400 + i, n, cfg.vocab_size)
                     for i, n in enumerate(TENSOR_SLICE_LENGTHS)]
    from skypilot_tpu_torch.serve import slice_replica
    engine = slice_replica.SliceReplicaEngine(
        cfg, tp_slice, num_hosts=4, mesh=mesh,
        sp_threshold=SLICE_THRESHOLD, device=dev, **SLICE_ENGINE)
    from skypilot_tpu_torch.serve import plane_check
    try:
        zero_counts(counters)
        with engine._cond:  # pylint: disable=protected-access
            handles = [engine.submit(p, new_tokens) for p in slice_prompts]
        sl_tokens = [list(h.result(timeout=900)) for h in handles]
        plane_check.settle(engine)
        paths['tensor x sequence slice'] = read_counts(counters)
        sl_stats = engine.stats()
    finally:
        engine.stop()
    long_prompts = sum(1 for p in slice_prompts
                       if len(p) - 1 >= SLICE_THRESHOLD)
    want = tensor_predicted(cfg, 2, long_prompts, sl_stats['ticks'],
                            kernel='paged_attention', b3_each=3)
    want['flash_fwd'] += L * 2 * (len(slice_prompts) - long_prompts)
    hold_launches('tensor x sequence slice',
                  paths['tensor x sequence slice'], want)
    sl = sl_stats['slice']
    if (sl['tensor_degree'], sl['sp_degree'], sl['sp_prefills']) != (2, 2,
                                                                    2):
        raise AssertionError(f'tensor x sequence slice: {sl}')
    free_cuda()
    lap('tensor x sequence slice')
    sl_ref = single_tokens(cfg, model, dev, slice_prompts, new_tokens, False)
    report['tensor x sequence slice'] = dict(
        ticks=sl_stats['ticks'], slice=sl,
        holds=tensor_holds('tensor x sequence slice', cfg, tp_slice, model,
                           slice_prompts, sl_tokens, sl_ref))
    del tp_slice, engine
    free_cuda()
    lap('tensor x sequence slice holds')
    report['ticks'] = tensor_ticks(cfg, model, dev, {1: model, 2: tp2})
    del tp2
    free_cuda()
    lap('ticks 1, 2')

    tp4 = tensor_cut(cfg, model, tensor_mesh(dev, 4))
    launches, tokens, health, _ = tensor_http(
        cfg, tp4, dev, counters, prompts, new_tokens, tensor=4,
        tensor_devices=[dev] * 4, **TENSOR_SERVER)
    paths['tensor 4'] = launches
    ticks = health['engine']['ticks']
    hold_launches('tensor 4', launches, tensor_predicted(
        cfg, 4, len(prompts), ticks, kernel='paged_attention'))
    if launches['flash_fwd'] != 4 * base['flash_fwd']:
        raise AssertionError('tensor 4: B3 is not four times tensor 1\'s')
    lap('tensor 4')
    report['tensor 4'] = dict(ticks=ticks, holds=tensor_holds(
        'tensor 4', cfg, tp4, model, prompts, tokens, ref_tokens))
    free_cuda()
    lap('tensor 4 holds')

    launches, tokens, stats = engine_window(
        cfg, tp4, dev, counters, prompts, new_tokens, quantize_kv=True,
        spec_tokens=4)
    lap('tensor 4 (int8 pool)')
    paths['tensor 4 (int8 pool)'] = launches
    hold_launches('tensor 4 (int8 pool)', launches, tensor_predicted(
        cfg, 4, len(prompts), stats['ticks'],
        kernel='paged_attention_int8'))
    report['tensor 4 (int8 pool)'] = dict(
        ticks=stats['ticks'], accept=stats['spec_accept_len_mean'],
        holds=tensor_holds('tensor 4 (int8 pool)', cfg, tp4, model,
                           prompts, tokens, ref_tokens, quantized=True))
    free_cuda()
    lap('tensor 4 (int8 pool) holds')

    # --num-hosts 4 in the default layout: llama3-8b's is tensor 4.
    launches, tokens, health, _ = tensor_http(
        cfg, tp4, dev, counters, slice_prompts[:1], new_tokens,
        num_hosts=4, slice_devices=[dev] * 4, max_len=SLICE_MAX_LEN,
        max_batch=4, prefill_chunk=PREFILL_CHUNK, kv_pages=2048,
        page_size=16, sp_threshold=SLICE_THRESHOLD)
    lap('tensor slice')
    paths['tensor slice'] = launches
    sl = health['slice']
    if (sl['tensor_degree'], sl['sp_degree'], sl['sp_prefills']) != (4, 1,
                                                                    1):
        raise AssertionError(f'tensor slice /health: {sl}')
    hold_launches('tensor slice', launches, tensor_predicted(
        cfg, 4, 1, health['engine']['ticks'], kernel='paged_attention'))
    report['tensor slice'] = dict(
        ticks=health['engine']['ticks'], slice=sl,
        holds=tensor_holds('tensor slice', cfg, tp4, model,
                           slice_prompts[:1], tokens, sl_ref[:1]))
    free_cuda()
    lap('tensor slice holds')
    report['ticks'][4] = tensor_ticks(cfg, model, dev, {4: tp4})[4]
    del tp4
    free_cuda()
    lap('ticks 4')
    report['base'] = dict(launches=base, ticks=base_stats['ticks'])
    report['seconds'] = time.perf_counter() - lap.t0
    return paths, report


def log_tensor(report, paths) -> None:
    for path in ('tensor 2', 'tensor 2 dense', 'tensor x sequence slice',
                 'tensor 4', 'tensor 4 (int8 pool)', 'tensor slice'):
        r = report[path]
        extra = (f'; slice {json.dumps(r["slice"])}' if 'slice' in r else
                 f'; accept len {r["accept"]}' if 'accept' in r else '')
        log(f'{path}: {r["ticks"]} ticks{extra}; launches '
            f'{json.dumps(paths[path])}; tokens vs the tensor-1 engine: '
            f'{hold_summary(r["holds"])}')
    h = report['handoff']
    log(f'tensor 2 handoff ({TENSOR_HANDOFF}-token prompt): frame '
        f'{h["frame_bytes"]} bytes, header and hashes equal to tensor 1\'s, '
        f'the largest layer\'s k/v relative difference '
        f'{h["layer_rel_max"]:.3g} (limit {HANDOFF_LAYER_LIMIT:g}; with '
        f'the heads joined in reverse, a planted fault: '
        f'{h["fault_layer_rel_max"]:.3g}), whole leaves '
        f'{h["rel"]["k"]:.3g}/{h["rel"]["v"]:.3g}, layer 0 byte-equal: '
        f'{h["layer0_equal"]}; re-exported frames byte-equal across '
        f'degrees ({h["round_trip_bytes"]} bytes); decode after import: '
        f'{hold_summary([h["hold"]])}')
    sound = max(max_drift(report[p]['holds']) for p in (
        'tensor 2', 'tensor 2 dense', 'tensor x sequence slice', 'tensor 4',
        'tensor 4 (int8 pool)', 'tensor slice'))
    sound = max(sound, max_drift([report['handoff']['hold']]))
    log(f'tensor logits vs tensor 1\'s on the same contexts: at most '
        f'{sound:.3g} x tensor 1\'s flash-vs-masked delta over every path '
        f'(limit {DRIFT_LIMIT:g}); with rank 1\'s partial left out of every '
        f'row-parallel sum at tensor 2, a planted fault: '
        f'{report["planted drift"]:.3g} x')
    pre = report['prefill_sp']
    log(f'tensor prefill_sp (sequence 2 x tensor 2, {SLICE_PROMPT} tokens, '
        f'{card()}): {pre["ms"]:.2f} ms device by {pre["timed_by"]}, B3 '
        f'{pre["launches"]}, k/v relative to tensor 1 '
        f'{pre["errs"]["k"]:.3g}/{pre["errs"]["v"]:.3g}, first token '
        f'{hold_summary([pre["hold"]])}')
    for tp, t in sorted(report['ticks'].items()):
        log(f'tensor {tp} paged tick (8 slots, depths 5..700; {card()}; '
            f'printed, not held): {t["tick_ms"]:.2f} ms host, '
            f'{t["device_ms_per_tick"]:.2f} ms device, idle share '
            f'{t["device_idle_share"]:.3f}, {t["kernels_per_tick"]:.0f} '
            'kernels')
    log(f'tensor 1 base window: {report["base"]["ticks"]} ticks, launches '
        f'{json.dumps(report["base"]["launches"])}; tensor f32 cut (depth '
        f'1, tensor 2): GPU == CPU greedy tokens, paged and dense; tensor '
        f'phase {report["seconds"]:.1f} s (s by step: '
        f'{json.dumps(report["laps"])})')


def log_observability(obs) -> None:
    def spread(xs):
        return (f'{" / ".join(f"{x:.2f}" for x in xs)} '
                f'(range {max(xs) - min(xs):.2f})')
    log(f'observability (bf16 and int8 pools): /metrics deltas equal '
        f'engine.stats(), TTFT count +6; /spans one ordered engine segment '
        f'per id; /logs one access record per id; int8 pool '
        f'{obs["int8_ring"]} ticks in the ring; bf16 pool /profile '
        f'{obs["ring"]} ticks in the ring '
        f'(capacity {obs["ring_ticks"]}), tick ms p50 '
        f'{obs["tick_ms_p50"]:.2f} (min {obs["tick_ms_min"]:.2f}, max '
        f'{obs["tick_ms_max"]:.2f}), phase ms {json.dumps(obs["phases"])}, '
        f'memory watermark {obs["mem_watermark_gib"]:.2f} GiB')
    log(f'observability cost: modeled {obs["per_lap_us"]:.3f} us a lap, '
        f'{obs["laps_per_tick"]:.2f} laps a tick, {obs["overhead_ms"]:.3f} '
        f'ms over {obs["ticks"]} ticks; ring {obs["ring_bytes_per_tick"]:.0f}'
        f' JSON bytes a tick; host ms a tick (6 requests x 32 tokens, '
        f'off, on, on, off): plane on {spread(obs["host_ms_on"])}, off '
        f'{spread(obs["host_ms_off"])} (printed, not held)')
    log(f'observability device work: the wrapped step + prefill launch '
        f'the bare entries\' kernels on identical inputs '
        f'({obs["work"]["kernels_per_call"]} kernels a call, '
        f'{obs["work"]["distinct_kernels"]} distinct; B1/B2/B3 '
        f'{obs["work"]["launches"]} over 8 calls each; profiler windows '
        f'off the majority: {obs["work"]["windows_off_majority"]} of 16); '
        f'sentinel '
        f'(calls, signatures, steady): {json.dumps(obs["recompiles"])}')


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    # The flight recorder's journals (observability/events.py) go to a
    # SKYTPU_HOME of the run's own, deleted at its end.
    home = tempfile.mkdtemp(prefix='skytpu_home_')
    os.environ['SKYTPU_HOME'] = home
    try:
        return run()
    finally:
        for thread in REMOVALS:
            thread.join()
        shutil.rmtree(home, ignore_errors=True)


def run() -> int:
    """Every phase of the module docstring, in order."""
    import torch
    try:
        from skypilot_tpu_torch.ops import _build
        from skypilot_tpu_torch.ops import attention
        from skypilot_tpu_torch.ops import paged_attention
    except ImportError as e:
        print(f'chip_smoke: the port is not importable: {e}',
              file=sys.stderr)
        return 2
    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    log(card())
    log(f'torch {torch.__version__} cuda {torch.version.cuda} '
        f'devices {torch.cuda.device_count()}')

    clock = Laps()
    t0 = time.perf_counter()
    built = _build.build_all()
    log(f'build: {time.perf_counter() - t0:.1f}s '
        f'({", ".join(f"{k} {v:.1f}s" for k, v in built.items())})')
    compiled_report(_build)
    clock.done('build')

    log('kernel parity (8B shapes):')
    results = {
        'paged_attention': check_paged(dev, quantized=False),
        'paged_attention_int8': check_paged(dev, quantized=True),
        'flash_fwd': check_flash(dev),
    }
    results['flash_fwd'].update(check_ring_hops(dev))
    results.update(check_flash_bwd(dev))
    # B4/B5's entries are at the tensor mesh's non-causal ring hop
    # (phase 7c's newest path), the other shapes under their labels.
    sharded = check_sharded_shapes(dev)
    results['flash_fwd'].update(sharded['flash_fwd'])
    for name in ('flash_bwd_dq', 'flash_bwd_dkv'):
        results[name] = dict(
            sharded[name]['tensor_ring_hop_full'],
            training_shape=results[name],
            **{label: sharded[name][label] for label in SHARD_SHAPES
               if label != 'tensor_ring_hop_full'})
    for name, ranks in check_tensor_ranks(dev).items():
        results[name]['tensor_rank'] = ranks
        for tp, r in ranks.items():
            log(f'  {name} at a tensor rank ({tp}, heads '
                f'{TENSOR_HEADS[int(tp[2:])]}): {kernel_summary(r)}')
    for name, r in results.items():
        at = (f' at the slice tick (lengths {SLICE_TICK})'
              if name.startswith('paged') else
              ' at the tensor mesh\'s ring hop (b 1, 16/4, 2048 x 2048, '
              'non-causal)' if name.startswith('flash_bwd') else '')
        log(f'  {name}{at}: {kernel_summary(r)}')
    log(f'  flash_fwd at the 512-token serving chunk: '
        f'{kernel_summary(results["flash_fwd"]["serving_chunk"])}')
    for name in ('paged_attention', 'paged_attention_int8'):
        log(f'  {name} at the serving tick (lengths {PAGED_RAGGED}): '
            f'{kernel_summary(results[name]["serving_tick"])}')
        log(f'  {name} at the full batch (8 slots x 1000): '
            f'{kernel_summary(results[name]["full_batch"])}')
    clock.done('kernel parity')
    counters = {'paged_attention': paged_attention.LAUNCHES,
                'paged_attention_int8': paged_attention.LAUNCHES,
                'flash_fwd': attention.LAUNCHES,
                'flash_bwd_dq': attention.LAUNCHES,
                'flash_bwd_dkv': attention.LAUNCHES}

    from skypilot_tpu_torch.serve import model_server
    new_tokens = 32
    zero_counts(counters)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    # The serving engine's pool journals its pages (held below); the
    # engines of later phases are made without the variable.
    os.environ['SKYTPU_SERVE_PAGE_EVENTS'] = '1'
    try:
        server = model_server.ModelServer(
            'llama3-8b', continuous_batching=True, kv_pages=1024,
            page_size=16, max_len=1024, max_batch=8, seed=0, device=dev,
            overrides={'n_layers': SERVE_LAYERS})
    finally:
        del os.environ['SKYTPU_SERVE_PAGE_EVENTS']
    torch.cuda.synchronize()
    log(f'llama3-8b init (depth {SERVE_LAYERS}): '
        f'{time.perf_counter() - t0:.1f}s, '
        f'{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB')
    try:
        tps, wall = serve_over_http(server, server.cfg.vocab_size,
                                    new_tokens)
        req = server.engine.submit(prompt(9, 100, server.cfg.vocab_size),
                                   new_tokens)
        req.result(timeout=600)
        stats = server.engine.stats()
        log(f'http: {tps:.1f} tokens/s over 6 concurrent requests '
            f'({wall:.2f}s); TTFT (100-token prompt, idle engine) '
            f'{req.ttft_s * 1e3:.1f} ms; prefix hits '
            f'{stats["prefix_cache_hits"]} pages; ticks {stats["ticks"]}')
        allocs, frees, held = page_balance(server.engine)
        log(f'page journal (serve.jsonl): {allocs} kv_pages_alloc, {frees} '
            f'kv_pages_free; the {held} pages still held are the prefix '
            f'cache\'s')
        spec_stats = int8_spec_parity(server.cfg, server.params, dev,
                                      new_tokens)
        log(f'int8 + spec(4): greedy equal to spec-off; accept len '
            f'{spec_stats["spec_accept_len_mean"]}')
        paths = {'serving': read_counts(counters)}
        serving = ('paged_attention', 'paged_attention_int8', 'flash_fwd')
        launches = {name: paths['serving'][name] for name in serving}
        log(f'peak memory: '
            f'{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; '
            f'serving-path launches {launches}')
        missing = [name for name, n in launches.items() if n <= 0]
        if missing:
            raise AssertionError(f'kernels not launched on the serving '
                                 f'path: {missing}')
        obs = observability(server, dev, new_tokens, counters)
        paths.update(obs['launches'])
        expect_launches('observability', paths['observability'],
                        ('paged_attention', 'flash_fwd'),
                        ('paged_attention_int8',))
        expect_launches('observability (int8 pool)',
                        paths['observability (int8 pool)'],
                        ('paged_attention_int8', 'flash_fwd'),
                        ('paged_attention',))
        log_observability(obs)
    finally:
        server.close()
    cfg, model = server.cfg, server.params
    del server
    free_cuda()
    clock.done('serving + observability')
    paths.update(more_serving(cfg, model, dev, counters, new_tokens))
    free_cuda()
    clock.done('more serving')
    slice_paths, slice_report = slice_serving(cfg, model, dev, counters,
                                              new_tokens)
    paths.update(slice_paths)
    log_slice(slice_report)
    log(f'launches: {json.dumps(slice_paths)}')
    free_cuda()
    clock.done('slice')
    tensor_paths, tensor_report = tensor_serving(cfg, model, dev, counters,
                                                 new_tokens)
    paths.update(tensor_paths)
    log_tensor(tensor_report, tensor_paths)
    del model
    free_cuda()
    clock.done('tensor serving')
    paths.update(real_weights(dev, counters, new_tokens))
    free_cuda()
    clock.done('real weights')
    paths.update(moe_serving(dev, counters, new_tokens))
    free_cuda()
    clock.done('moe serving')
    err = reference_check(dev)
    log(f'reference: depth-2 f32 llama3-8b GPU == CPU greedy tokens '
        f'(paged and dense engines); prefill logits max_abs_err {err:.3g}')
    clock.done('serving reference')

    paths['training'] = train_main_path(dev, counters)
    paths['train_llama small'] = cli_check(counters)
    clock.done('training')
    paths['training resume'], resume = training_resume(dev, counters)
    launched = {name: paths['training resume'][name]
                for name in TRAIN_KERNELS}
    want = {'flash_fwd': 2 * 10, 'flash_bwd_dq': 10, 'flash_bwd_dkv': 10}
    if launched != want:
        raise AssertionError(f'training resume: launches {launched}, '
                             f'expected {want} (10 steps at depth 1)')
    log_training_resume(resume, launched)
    clock.done('training resume')
    shard_paths, shard_report = sharded_training(dev, counters)
    paths.update(shard_paths)
    log_sharded(shard_report)
    clock.done('sharded training')
    moe_paths, moe_report = moe_sharded_training(dev, counters)
    paths.update(moe_paths)
    log_moe_training(moe_report)
    clock.done('moe sharded training')
    pipe_paths, pipe_report = pipeline_training(dev, counters)
    paths.update(pipe_paths)
    log_pipeline(pipe_report)
    clock.done('pipeline training')
    host_paths, host_report = multihost_training(dev, counters)
    paths.update(host_paths)
    log_multihost(host_report)
    clock.done('multihost training')
    elastic_paths, elastic_report = elastic_training(dev, counters)
    paths.update(elastic_paths)
    log_elastic(elastic_report)
    clock.done(ELASTIC_LABEL)
    loss, (rel, name) = train_reference_check(dev)
    log(f'train reference: depth-1 f32 llama3-8b loss GPU '
        f'{loss["cuda"]:.6f} CPU {loss["cpu"]:.6f}; largest gradient '
        f'difference {rel:.3g} of max |CPU| ({name})')
    clock.done('train reference')
    log(f'phase seconds: {json.dumps(clock.seconds)}; '
        f'{clock.last - clock.t0:.1f} s in all')

    sources = {'paged_attention': 'skypilot_tpu_torch/csrc/paged_attention.cu',
               'paged_attention_int8':
                   'skypilot_tpu_torch/csrc/paged_attention.cu',
               'flash_fwd': 'skypilot_tpu_torch/csrc/flash_fwd.cu',
               'flash_bwd_dq': 'skypilot_tpu_torch/csrc/flash_bwd.cu',
               'flash_bwd_dkv': 'skypilot_tpu_torch/csrc/flash_bwd.cu'}
    replaces = {'paged_attention': 'skypilot_tpu/ops/paged_attention.py:104',
                'paged_attention_int8':
                    'skypilot_tpu/ops/paged_attention.py:138',
                'flash_fwd': 'skypilot_tpu/ops/attention.py:138',
                'flash_bwd_dq': 'skypilot_tpu/ops/attention.py:257',
                'flash_bwd_dkv': 'skypilot_tpu/ops/attention.py:306'}
    # `launches` counts the run of the path named by `path`: "moe
    # tensor 2" (this port's newest serving path: Mixtral-width MoE over
    # two tensor ranks, bf16 pool) for B1, "moe tensor 2 (int8 pool)"
    # for B2, "elastic training" (phase 7g, the newest training path:
    # fsdp 4 -> 2 -> 4 through two resizes) for B3-B5.
    # `launches_by_path` gives each driven path's own count; no two runs
    # are added.
    main_path = {'paged_attention': 'moe tensor 2',
                 'paged_attention_int8': 'moe tensor 2 (int8 pool)',
                 'flash_fwd': ELASTIC_LABEL,
                 'flash_bwd_dq': ELASTIC_LABEL,
                 'flash_bwd_dkv': ELASTIC_LABEL}
    kernels = [dict(name=name, route='cuda', source=sources[name],
                    replaces=replaces[name],
                    launches=paths[main_path[name]][name],
                    path=main_path[name],
                    launches_by_path={p: c[name] for p, c in paths.items()},
                    **results[name]) for name in results]
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
