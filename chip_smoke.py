#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`deeplearning4j_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py                 # every default phase
    python3 chip_smoke.py --phases kernels   # a subset; `profile` is extra
    python3 chip_smoke.py --phases paged,serve,int8,profile --package-root DIR
        # the same phases over the port in another checkout DIR (a parent
        # commit unpacked with `git archive`): two trees in one call

Always first:

1. identity — card name and power limit (nvidia-smi), torch and CUDA
   versions.  Exits non-zero, printing no result, without a CUDA device.
2. build — compiles every ``csrc/*.cu`` of the checkout (one nvcc per
   source, in parallel) and prints ptxas' register / spill report, then
   counts the tensor-core MMAs (HGMMA, HMMA), TMA loads (UTMALDG) and bulk
   copies (UBLKCP) of each flash, dequant-matmul and paged-attention
   kernel in ``cuobjdump -sass``: fails if a bf16 backward kernel has no
   MMA, a forward kernel (bf16 or f32), an f32 backward kernel or the
   large-M dequant-matmul kernel no HGMMA or no UTMALDG, an f32-FMA flash
   backward kernel is still in the library, a paged-attention kernel no
   UTMALDG (whole pages) or no UBLKCP (partial pages, int8 scales), or
   ptxas reports that it serialised a kernel's wgmma pipeline.

Then the phases:

3. kernels — each hand-written kernel against its plain PyTorch version
   at the shapes of the training and serving paths, bf16 and f32: max
   |kernel - plain| against a stated tolerance, kernel / plain / library
   times (CUDA events, cold L2, median of 10) and the kernel's lower
   bound.  The flash forward (B1) at BH 8, T 2048, 2000 (the serve
   prefill) and 144, and at BH 32, T 2048 (the training step), causal:
   out and lse each against their own tolerance (bf16 out both against
   the largest element and row by row), and a second launch must give
   the same bits, and a copy of the bf16 kernel with a planted fault in
   P V (its consumers read V from the next ring stage) must fail the
   row-by-row out check at the training and serve shapes; then
   `flash_attention` on the (B, T, H, D)
   training layout against the kernel alone (its layout copies).  The
   flash backward (dQ and dK/dV kernels) at the training
   shape (BH 32, T 2048 and 2000, D 128, causal), and in bf16 also
   non-causal at T 2048, at T 144 (a serve bucket) and at D 64, against
   `flash_bwd_plain` and the backward of `scaled_dot_product_attention`;
   a second launch of each must give the same bits.  An f32 row's time
   includes the split pre-pass its call runs; the kernel alone on split
   parts and the pair as a backward runs it (one split, both kernels) are
   timed beside it.  The paged attention
   (B4), f32 and int8 pages, against `paged_attention_plain` within 1e-4:
   the serve mix (8 slots of lengths 2017 ... 0 over 160-wide tables),
   timed; the full pool (8 slots x 1008 positions, 504 of the 511 usable
   pages), timed; head dims 16 ... 256 on the serve mix, checked.  Each
   must give the same bits on a second launch, and the idle slot exact
   zeros.  B4 at the speculative verify's shape (`paged_attention_chunk`:
   8 slots x 5 rows of the serve mix, row j attending seq_len + j + 1
   positions, i.e. 40 pseudo-slots over the same pages), f32 and int8
   pages, within 1e-4, timed, its bound counting each slot's pages once.
   The Timer's own floor (the event pair alone, and around one
   empty kernel launch) is timed beside them.
4. train — the full-width flagship (below) trained with Adam (lr 3e-4)
   through the chunked vocab loss on one fixed batch of 4 x 2048 token
   ids (numpy seed 3, int64): 2 warm-up and 6 measured `fit_batch`
   steps, each a replay of the captured step (one CUDA graph: forward,
   backward, updater; the first warm-up step runs eagerly and is
   captured), then 3 eager steps of the same program timed beside them,
   with the graph dropped first; the device memory of each run (peak
   reserved and allocated from an emptied cache, and what stays
   reserved after: a graph holds its pool) is printed beside it.
   Prints step ms, tokens/s and every loss; gates on finite, falling
   loss, one step graph, and on exactly 8 launches a step of each of
   flash_fwd, flash_bwd_dq and flash_bwd_dkdv across the replays
   (counters zeroed just before the measured steps and read just
   after).  train_f32 — the same with the
   flagship built with ``bf16_compute=False``: f32 compute, the JAX
   package's CPU arithmetic, through B1 f32 (`flash_fwd_split`) and the
   f32 backward (`flash_bwd_dq_split`, `flash_bwd_dkdv_split`), with the
   same gates.  In the bf16 train phase, then, `observe.cost` analyses
   the step program (one counted run: torch ops by FlopCounterMode's
   formulas, B1-B3 by the port's ``*_work`` functions, the same ones the
   kernel rows' bounds use): its FLOPs must be within 1% of the count by
   hand (`_train_flops_by_hand`); achieved FLOP/s and MFU at the median
   step against the H100 row, and the roofline class, are printed.
4b. lenet — the LeNet slice (ROADMAP A3), at bench.py's bench_lenet
   configuration (`deeplearning4j_tpu_torch/bench_lenet.py`): `entry()`
   on the card ((8, 10), finite); LeNet trained at batch 512 on
   `MnistDataSetIterator(train=True, num_examples=30000)` (its first 40
   batches cycled) with `fit(steps_per_execution=50)`, 100 warm-up and
   1,000 measured steps, in bf16 and in f32: samples/s, ms a step, the
   step's FLOPs (`observe.cost`, within 1% of the count by hand),
   achieved FLOP/s and MFU; finite losses whose last 50 average below
   the first 50; `evaluate` on 5,000 test images at or above
   `LENET_ACC_FLOOR`.  From one snapshot, 3 captured and 3 eager steps
   must agree bit for bit (losses, parameters, Adam state, layer
   state) with no capture during the replays, for LeNet in both
   computes and for SimpleCNN.  A 304-row batch (the iterator's last)
   then captures a second step graph into the first one's pool (gate:
   2 graphs), and 100 eager steps run with no graph held: ms a step and
   device memory of the captured run, the second signature and the
   eager run are printed.  SimpleCNN at 32 x 32 x 3 on
   `CifarDataSetIterator`, batch 128, 20 steps: finite falling losses,
   BatchNorm running stats that moved and are finite; saved, restored
   on the card and bit-identical (state and `output()`).  `quantize`
   of the trained bf16 LeNet: `output()` of the 5 evaluation batches of
   1,000 images with exactly 2 B5 launches a call (Dense and the head;
   the convs dequantize their kernels), argmax agreement >= 0.99 with the
   f32 model of the dequantized weights, its accuracy; B5 at (1000,
   2450, 500), (1000, 500, 10) and the entry's (8, 2450, 500) against
   `dequant_matmul_plain` and cuBLAS f32, with their bounds.
5. serve — the full-width flagship `TransformerEncoder` (vocab 32000,
   d 1024, 8 heads, 8 layers, chunked head, seed 123, bf16 compute) in a
   `GenerationEngine` (8 slots, 16-row pages, 512 pages, 160-wide
   tables): 8 concurrent streams of 32 tokens, one with a 2000-token
   prompt and one sampled.  The decode step is one CUDA graph replay
   (captured in the first pass).  Launch counters are zeroed just before
   and read just after: both kernels must have run, B4 exactly 248 times
   (31 steps x 8 layers, counted across replays).  Then the host time to
   sample one token from a (1, 32000) row, top-k 50 and top-k 0, with
   the port's sampler and with two yardsticks it does not call.
   With the serving plane in the tree, then 4 alternating passes with
   span tracing off and on: decode ms a step of each, and the
   difference.
5b. server — the serving plane on the same flagship: an
   `InferenceServer` (batches of up to 8) with the engine attached
   (``server=``, the serve engine's configuration) behind its HTTP front
   on 127.0.0.1.  Generate: the serve mix through ``POST /v1/generate``
   (8 concurrent requests, one of them streamed NDJSON, the last
   sampled), queued before the loop starts as in-process reference
   streams are: every greedy stream must equal in-process `generate`'s,
   in exactly 31 decode steps and 248 B4 launches; the per-stream
   breakdown means (decode_compute against sampling) are printed.
   Infer: 16 requests of 256 ids in-process (2 batches of 8, after
   `warm_start`) and 8 through ``/v1/infer``: rows within B1 bf16's
   tolerance of ``output()`` of the same rows, exactly 8 B1 launches a
   batch dispatch.  Infer at load, while the batcher runs: 16
   closed-loop in-process clients for 3 s and 8 HTTP clients for 4 s,
   each after a 0.5 s warm-up: requests/s, p50 / p99 latency (p99 from
   100 requests up), rows a batch, the server's seconds by segment,
   exactly 8 B1 launches a batch.  Hot-swap:
   `push_weights` of a perturbed copy while 8 streams decode: no stream
   dropped, the weights generation up by 1, one graph re-capture; a torn
   push (``serving.hotswap:truncate``) and ``/v1/reload`` of a corrupted
   zip roll back (409) with ``output()`` unchanged.  Wedge: with the
   engine's watchdog floor at 0.3 s, ``serving.decode:delay`` holds a
   step 2 s: every in-flight stream fails ``wedged``, no page leaks, the
   abort stage is counted, a flight dump is written, the breaker
   (threshold 1) opens, sheds, admits a half-open probe and closes, and
   the serve mix after gives the same greedy tokens as before.  Scrape:
   the generation, KV, serving, breaker, watchdog, flight, fault and
   checkpoint families hold non-zero counts; ``/v1/status`` carries the
   generation block and ``/healthz`` answers 200.
5c. fleet — the serving fleet (`serving/fleet.py`, `serving/router.py`):
   two flagship replicas (seed 123 each) in one process on the card,
   batches of 8, the serve engine's configuration.  Generate: roles
   prefill (r0) and decode (r1); the serve mix through
   `ServingFleet.generate`, 8 streams started together: each equal to
   r1's in-process stream of the same prompt (the sampled one also to
   the serve phase's sampled stream, when that phase ran), exactly 8 B1
   launches a prompt with no prefill on r1, exactly 8 B4 launches a
   decode step of r1, no other kernel, no decode loop on r0; tokens/s,
   mean TTFT (submit to the first token's callback), the 2000-token
   prompt's TTFT and the handoff's seconds and share of TTFT are
   printed.  Infer: two ``both`` replicas; 16 requests of 256 ids routed
   before the batchers start (one batch of 8 on each): rows bit-identical
   to ``output()`` of the row in a batch of 8, exactly 8 B1 launches a
   batch, ``dl4jtpu_router_requests_total`` 8 on each replica.  Chaos:
   32 closed-loop clients for 2 s, r1 killed once it holds queued
   requests: every request completes, at least one retry, exactly one
   ``dead`` ejection; after `revive_replica` (re-sync included) one
   probe re-admits r1.  Deploy: a perturbed tree rolled out on the
   prefill/decode fleet while 4 infer clients run, golden-input canaries
   at tolerance 1e-4: installed on both, weights generation +1 on each,
   and exactly one graph re-capture after it (r1; r0 never captures);
   then with ``serving.canary:corrupt:every=1`` armed the deploy rolls
   the fleet back, one canary failure is counted, and both replicas'
   outputs are bit-identical to before.  Compile stats of the phase: no
   ``nvcc`` run, every kernel library found up to date.
6. spec — speculative decoding on the flagship: the serve engine with
   ``spec_k`` 4 and the n-gram drafter against a plain engine, the serve
   prompts with 100 new tokens a stream (the last sampled), one warm-up
   pass each, then 3 interleaved rounds: tokens/s of each, acceptance,
   tokens a verify dispatch, verify and plain dispatches, and the
   launches of the spec engine's first measured pass, which must be
   exactly 8 a dispatch of the verify's B4 (`paged_attention_chunk`) and
   of the plain step's.  Then with f32 compute: the spec engine's streams
   against the plain engine's (agreement >= 0.95, first tokens
   identical: the parity rule; the byte-identical streams counted, the
   first divergence's position and top-2 logit gap printed), the same
   with every draft corrupted (``serving.draft:corrupt:every=1``), a
   spec engine over int8 pages (>= 0.9 against the f32 pages, first
   tokens identical: the int8 rule; exactly 8 int8 B4 launches a
   dispatch), and no page left in use; and the captured plain and verify
   steps against the eager ones on the same state (8 admitted streams, 3
   dispatches each): the same logits, bit for bit.
7. parity — an f32-compute engine against the port's dense `generate`
   on 4 greedy streams: token agreement >= 0.95, first token identical.
8. int8 — the same streams through an int8-KV engine, gated against
   the same reference as the JAX package gates int8 pages (>= 0.9).
   serve, parity and int8 make seven measured passes of their streams
   and print each pass's tokens/s and the medians; their engines' steps
   are captured graphs too.
9. quant — int8 post-training quantization and quantized inference.
   Kernel rows first: the dequant-matmul kernel (B5) against
   `dequant_matmul_plain` at the six product shapes (M, K, N) =
   (4096, 1024, 1024), (4096, 1024, 4096), (4096, 4096, 1024),
   (4096, 1024, 32000), (8, 1024, 4096) and (1, 4096, 4096), and at the
   quantized engine's decode (M 8) and verify (M 40) shapes (8, 1024,
   1024), (8, 4096, 1024), (8, 1024, 32000), (40, 1024, 1024), (40, 1024,
   4096), (40, 4096, 1024) and (40, 1024, 32000), within
   1e-5 (K 1024) or 2e-5 (K 4096) of max |plain|, plus the ragged
   (5, 100, 72) and (200, 100, 48) for correctness, each on the route
   the wrapper picks by shape (the tensor cores above 64 rows, f32 FMAs
   split over K below) and then on the other route where TMA can read
   the weights; a second launch must give the same bits; the library
   yardstick is cuBLAS f32 on the dequantized weight (and
   ``torch._weight_int8pack_mm`` where this PyTorch has it for CUDA);
   and B1's f32 row at BH 16, T 2048.  Then
   the path: the flagship with its default `RnnOutputLayer` softmax head
   (vocab 32000, d 1024, 8 heads, 8 layers, seed 123), `quantize`d
   (its tree must shrink, by `quantized_bytes`), runs 1 warm-up and 3
   measured `output()` calls on 2 x 2048 ids (numpy seed 3), launch
   counters zeroed just before the measured calls and read just after:
   exactly 49 dequant_matmul launches (8 layers x 6 products + the
   head) and 8 f32 flash_fwd launches a call.  Its probabilities are
   held against an f32 model built from `dequantize_tree` of the same
   tree (cuBLAS f32 products, the same f32 B1): argmax agreement >= 0.99
   and max |dp| <= 1e-4 of max p.  The unquantized model's bf16
   ``output()`` time and the int8-vs-f32-weights argmax agreement are
   printed as information.
9b. qserve — int8 serving (ROADMAP A7): the serve phase's flagship
   (chunked head, seed 123) `quantize`d, in a `GenerationEngine` with the
   serve engine's configuration, on the serve mix, the decode step a
   captured graph.  B1 f32 at the long prompt's prefill (BH 8, T 2000)
   is a kernel row first.  Launch counters zeroed just before the
   measured pass: exactly 49 B5 launches a decode step and a prefill (8
   layers x 6 products and the head), 8 f32 B1 a prompt, 8 B4 a step and
   no other kernel.  Tokens/s, mean TTFT, the 2000-token prompt's TTFT
   and decode ms a step over 3 passes are printed beside the serve
   phase's bf16 engine in the same call, with B5's device time in one
   profiled pass and the int8 tree's bytes against the f32 tree's.
   Greedy agreement with dense `generate` over the same quantized model:
   >= 0.95 on f32 pages, >= 0.9 on int8 pages, first tokens identical
   (the parity phase's prompts); the captured plain and verify steps
   against the eager ones, bit for bit, with 49 B5 a replay.  Spec
   (``spec_k`` 4, n-gram) against the plain quantized engine: >= 0.95,
   first tokens identical, exactly 49 B5 a dispatch (verify or plain)
   and a prefill, 8 B4 of each route a dispatch.  Then an
   `InferenceServer` (engine attached) behind HTTP: it advertises
   ``quantized``; ``/v1/generate`` streams equal in-process ones; 8
   ``/v1/infer`` rows within B5's 2e-5 of ``output()`` of the same rows
   with 8 B1 and 48 B5 a batch; a NaN-scale push (``nonfinite``) and an
   f32 push (``structure``) roll back with the outputs unchanged; a push
   of a quantized tree installs with one re-capture; ``/v1/reload`` of
   the model's quantized zip installs (generation +1, the same
   outputs).  Then two quantized ``both`` replicas in a `ServingFleet`:
   a rolling deploy of a quantized tree installs on both with
   generation +1, and a deploy under ``serving.canary:corrupt:nth=1``
   rolls back with outputs bit-identical.  The script refuses to start
   when ``DL4JTPU_QUANT_KERNEL`` is set to anything but auto: on the
   card the quantized products run B5, and a plain name there raises.
10. ckpt — the checkpoint zip (`train/checkpoint.py`) on the card.  The
   flagship's widths at 1 of its 8 blocks (``CKPT_LAYERS``; the depth
   cut for the script's time) with its softmax head trains 3 steps (bf16, Adam)
   on the train batch; `ModelSerializer.write_model` (with the updater),
   `verify` and `restore` (built on the card) are timed and the zip's
   bytes printed.  Held bit for bit: every parameter, the Adam state
   (counts, mu, nu), iteration and epoch of the restored model against
   the live one; ``output()`` of 2 x 2048 ids; the 4 greedy streams of
   the parity phase's prompts from an engine over each.  Then 3 more
   steps of the live model, twice from one state (their largest loss
   difference is the spread), and of the restored model, whose losses
   must stay within that spread of the live run's, with exactly 2
   launches a step of each of B1, B2 and B3.  Then the live model is
   `quantize`d, saved, verified and restored (through
   `requantize_structure`): its int8 and scale leaves and the quantized
   ``output()`` of the quant phase's 2 x 2048 ids bit for bit, with
   exactly 13 B5 and 2 B1 launches in the restored model's call.  The
   zips go to ``build/ckpt/`` and are removed after.
11. paged (only when asked for, and part of kernels) — B4's timed rows
   and the Timer's floor alone.  stages (only when asked for) — B4 built
   with time stamps at each stage of a block's work, on the same inputs:
   where its time goes (`stages_case`).
12. profile (only when asked for) — two training steps, the serve pass,
   the int8-KV engine's streams and two quantized ``output()`` calls
   under torch.profiler: device busy share, device time by kernel, and
   the paged-attention kernel's own device time in the serve and int8
   passes.
13. attn — the attention slice (ROADMAP A5).  (a) The MoE flagship: the
   train phase's flagship with ``moe_experts`` 8, ``moe_top_k`` 2 (a
   `MoELayer` after each block, f32 router and experts), trained on the
   train batch, 2 warm-up and 6 measured captured steps: one graph,
   exactly 8 launches a step of B1, B2 and B3; finite losses that fall
   below the first within 40 more untimed steps (this stack's residual
   stream grows with depth, and Adam at 3e-4 first raises its loss); 3
   captured and 3 eager steps bit-identical from one snapshot; an eager
   step's loss equal to data + penalty + aux (computed apart from the same
   state; no aux entry left in the layer state); the step's FLOPs
   (`observe.cost`) within 1% of `_moe_flops_by_hand`; one profiled eager
   step (device time by kind: flash, f32 GEMM, bf16 GEMM, the rest);
   ``output()`` of 2 x 2048 ids with exactly 8 B1 launches; the share of
   choices each MoE layer drops.  (b) A masked classifier at BERT-base
   widths (12 non-causal blocks of 768, 12 heads, FFN 3072, learned
   positions to 512, `GlobalPooling` AVG, a 2-way softmax head) trained
   in bf16 with Adam 5e-5 on procedural padded batches (32 x 128, row
   lengths 8-64, a class marker id in ~30% of a row's tokens): 2
   + 20 captured steps, finite falling losses, no flash launch, one
   capture across batches whose masks differ; 3 captured and 3 eager
   steps bit-identical; padding invariance (every padded id rewritten:
   masked ``output()`` bit-identical, bf16 and f32); f32 rows alone at
   their own length (B1 f32) within 2e-4 of their padded masked rows;
   exactly 12 B1 launches in an unmasked full-length ``output()`` and
   none in a masked one; accuracy on 1,024 held-out masked rows; the
   quantized classifier's masked ``output()`` with the B5 launches its
   int8 tree implies and argmax agreement >= 0.99 with its dequantized
   f32 twin; B1 and B5 rows at the classifier's shapes.  (d) Its
   ``/v1/infer``: 12 padded requests with their masks (one with a hole)
   within 2^-7 of ``output(x, mask)``, no B1 launch.  (c) A small f32
   stack of `SelfAttentionLayer` (both ``project_input`` modes) and
   `LearnedSelfAttentionLayer`: masked ``output()`` and 3 masked steps
   within 1e-5 of the port's CPU run from the same weights.
14. resnet — the ResNet-50 slice (ROADMAP A4).  (a) The zoo's
   `ResNet50()` (`GraphModel`, seed 123, Adam 1e-3, bf16) trained as
   bench.py's bench_resnet50 runs it: batch 256 of 224 x 224 x 3 images
   (numpy seed 0, normal(0, 1)) and one-hot labels, 4 batches staged on
   the card and cycled, ``fit(steps_per_execution=16)``; first 2 groups
   run eagerly (``capture_steps = False``, 1 timed), then `observe.cost`
   analyses the step (FLOPs within 1% of `_resnet_flops_by_hand`), then
   1 warm-up and 2 timed groups replay the captured step: samples/s, ms
   a step captured and eager, MFU against 989 TFLOP/s, peak memory of
   each run; gates on finite losses and the last group's mean below the
   first's; one profiled group (device busy share, top kernels); 2
   captured steps against the same 2 eager, bit for bit.  (b) The same
   training fed by `PrefetchIterator` over a generator of the host
   batches (pinned memory, a side stream): the staged batches equal the
   source in order and bytes, samples/s beside (a)'s, the producer
   seconds hidden behind the steps above 0.  (c) `write_model` /
   `restore` on the card: parameters, optimizer and BatchNorm state bit
   for bit and the next step's loss equal; `quantize`: ``output()`` of
   the first batch with exactly one B5 launch (the head; the convs
   dequantize), `parity_check` against the trained model on it, and B5
   at (256, 2048, 1000) against its plain version and cuBLAS f32.  (d) A
   graph of one unmasked `AttentionVertex` (12 heads of 64, T 128, batch
   32) in bf16 and f32: one B1 launch an ``output()`` call, one each of
   B1, B2 and B3 in a captured step, the f32 output within 1e-4 of the
   same graph on the CPU; B1 at (384, 128, 64) non-causal, both types,
   against its plain version.
14b. etl — the data pipeline slice (ROADMAP A12): DataVec, the native
   IO runtime (`runtime/native.py`, required: built with g++ into
   ``build/native/``; whether it has JPEG is printed), the batch cache,
   and the decode chain inside the captured step.  (a) BASELINE config
   2 fed from files as bench.py's bench_resnet50_etl feeds it: 1,024
   images of 4 classes written from numpy seed 0 by bench.py's
   ``_etl_corpus`` rule (500 x 375 JPEG q85 where PIL writes and the
   native library decodes JPEG, else 256 x 256 x 3 uint8 ``.npy``; the
   corpus used and why on its own line) under ``build/etl/``, removed
   after; `ImageRecordReader(256, 256, 3, shuffle_seed=0,
   dtype="uint8")` -> `RecordReaderDataSetIterator` (batch 256) ->
   `DeviceTransformIterator` (`RandomCrop(224, 224)`, `RandomFlip(0.5)`,
   `Scale(1 / 127.5, -1.0)`) -> the zoo's `ResNet50(num_classes=4)`
   (bf16, Adam 1e-3, ``steps_per_execution`` 1).  ETL images/s with no
   card in the loop; then (1) a live-decode fused epoch (the first epoch
   captures, the second is timed), (2) the same batches host-decoded
   (`DeviceDecode.host`) through `PrefetchIterator`, unfused, and (3)
   `CachedDataSetIterator`: a populate epoch, then a replayed fused
   epoch: samples/s and ms a step of each, host-to-device MB a step raw
   against decoded, the decode's calibrated ms.  Gates: every step of a
   fused run counted on ``dl4jtpu_device_decode_batches_total``, no
   fallback, one fused step graph whose staged features are uint8, the
   raw bytes equal to the batches'; `DeviceDecode.fn` on the card
   against `DeviceDecode.host` at four step indices (crop windows and
   flip coins identical, values within 1e-6); 4 fused steps replaying
   the captured step (augmentation indices 1-4) against the same steps
   eagerly, bit for bit; 3 fused steps against 3 host-decoded ones from
   one state within twice the floor that the host-decoded steps with
   each batch's halves of rows swapped set (loss and parameter change);
   the cached epoch's batches byte-identical to the populated ones, one
   decode epoch, replay pull time on ``source="cache"``.  (b) LeNet (the
   lenet phase's model, f32 and bf16) fed from MNIST-format IDX files of
   10,000 images written from numpy seed 0 and read by the native
   ``idx_read_u8``, through `NormalizingIterator(ImagePreProcessingScaler)`
   (its chain fuses) at batch 512: single steps and
   ``steps_per_execution=16``, ms a step and samples/s, every step fused
   with uint8 inputs and the raw bytes; in f32 3 fused steps against 3
   host-decoded ones within 1e-5 relative, and captured against eager
   bit for bit, single (4 steps) and grouped (2 groups of 3).
15. tools — the training tooling slice (ROADMAP A9).  (a) The flagship
   trained 4 steps (numpy seed 0 ids, 4 x 2048; the last 3 timed: the
   full step), then `TransferLearning.Builder` with Adam 1e-4 and
   ``set_feature_extractor(7)`` (the embedding and blocks 0-5 frozen,
   blocks 6-7 and the chunked head trained): 4 fine-tune steps without
   listeners and the same 4 from the same snapshot with
   `ScoreIterationListener`, `PerformanceListener`,
   `CollectScoresListener` and `HealthListener(frequency=1)`: ms a step
   of each, bit-identical losses and state; then `EarlyStoppingTrainer`
   over 8 training batches with `DataSetLossCalculator` on 2 held-out
   ones, `MaxEpochsTerminationCondition(3)`,
   `ScoreImprovementEpochTerminationCondition(1)` and
   `InMemoryModelSaver`, counters zeroed just before: exactly 8 B1 and 2
   each of B2 and B3 a training step (the held-out scoring's launches
   kept apart), frozen leaves keep their bits and trained ones move, no
   health event, the best model scores its recorded score again, and 2
   captured steps equal 2 eager ones bit for bit.  (b) `ResNet50()`
   through `TransferLearning.GraphBuilder`, frozen through ``s2b5_out``
   with a 10-way head: 2 warm-up and 8 timed captured steps at batch
   256 beside the resnet phase's full step; frozen weights keep their
   bits, frozen BatchNorm statistics move (the JAX package's training
   mode), the loss falls, captured == eager.  (c1) The chaos drill:
   `CheckpointStore(keep_last=2)` with one save at iteration 4, 16 more
   warm-up steps, then the watchdog's floor 0.3 s and k 2 and 14 batches
   under ``device.sync:delay:nth=3,secs=2;data.decode:raise:nth=6;
   data.decode:corrupt:nth=9`` with `RecoveryPolicy(store,
   skip_window=1)` and a raising `HealthListener`: the recovery ledger
   (bench.py ``--chaos``'s fields), save / verify / restore seconds and
   the rollback's; gates on one rollback at lr_scale 0.5, one
   quarantined batch with its bytes on disk, a watchdog warn, a finite
   final loss, the live state equal to the checkpoint's bit for bit
   right after the rollback, no graph captured in the run, and the three
   metric families moved.  (c2) `fit` of one batch of 1024 images under
   `RecoveryPolicy(None, max_split=8)`: a real device OOM split 2x or
   4x, finite losses, allocated memory back (but for a new piece
   graph's static inputs), and a batch of 256 replaying its graph.
   (c3) `PreemptionHandler(store)`: a listener sends SIGTERM at a step;
   the checkpoint lands and `PreemptionError` stops the fit; the model
   `restore_latest` gives takes the next batch with the interrupted
   model's loss, bit for bit.
16. rnn — the recurrent slice (ROADMAP A8).  (a) The zoo's
   `TextGenerationLSTM()` (vocab 77, two GravesLSTM layers of 200, TBPTT
   50, Adam 1e-2, seed 123, bf16) as bench.py's bench_lstm trains it:
   batches of 1024 x 200 one-hot characters of ``SURVEY.md`` (its 76 most
   frequent characters as ids 0-75, the rest 76; windows drawn with
   numpy seed 0, made on the card), ``fit(steps_per_execution=8)``: 2
   warm-up and 3 timed groups of 8 x 4 window steps, each a replay of
   the captured window step: ms a window step and a batch, samples/s,
   characters/s, MFU from the hand count of `bench.py:127-135`, peak
   memory, and one profiled group (device busy share, top kernels); one
   more group runs with any host synchronisation an error.  Gates: the
   last group's mean loss below the first's, 4 optimizer steps a batch,
   no capture and no ``nvcc`` run in the timed groups, one step graph,
   and a batch captured against the same batch eagerly from one
   snapshot, bit for bit (window losses, parameters, Adam state).  (b)
   The same model in f32 at batch 64 (BASELINE round 3's) against the
   port on the CPU from the same seed: 2 batches, then a variable-length
   batch with features and labels masks of random lengths (numpy seed
   1): every window loss within 1e-5, the parameters within the CPU
   tests' Adam rule, the masked ``output()`` within 1e-5 of max p, the
   recurrent layers' outputs zero at masked steps (and ``output()``
   there softmax of the head's bias).  (c) Greedy generation of 200
   characters for 8 prompts by `rnn_time_step`, one step a call (a graph
   replay a call): ms a character; 200 streamed steps against
   ``output()`` of the whole sequence within 1e-5 in f32 (bf16 printed).
   (d) `quantize`: ``output()`` of 64 x 200 and 200 `rnn_time_step`
   calls, exactly one B5 launch a call or a step (the head; the gates
   stay f32), within B5's 1e-5 of the f32 model of the dequantized
   weights; B5 at (12800, 200, 77) and (8, 200, 77) against its plain
   version and cuBLAS f32.  (e) `write_model` / `restore` on the card:
   the state bit for bit, and one more batch on both, bit for bit.  (f)
   `LSTM`, `GRU`, `SimpleRnn`, `Bidirectional(concat)` + `LastTimeStep`
   (the last two masked), `TimeDistributed(Dense)` and `ConvLSTM2D` at
   small widths in f32: ``output()`` within 1e-5 of max p of the CPU's,
   and a captured step against the eager one, bit for bit.  Writes under
   ``build/rnn/`` and removes it.
17. dp — data parallelism (ROADMAP A11, first part), each world a set of
   rank processes the phase spawns (`runtime/distributed.py` `spawn`; a
   rank that fails fails the phase).  (a) One NCCL rank a visible card:
   BASELINE config 5's model as bench.py's bench_scaling runs it (the
   zoo's `ResNet50()`, 1000 classes, bf16, Adam 1e-3, 128 rows a card
   of 224 x 224 x 3, numpy seed = the rank), through
   `ParallelWrapper(model).fit(..., steps_per_execution=16)`: 2 captured
   steps against the undistributed model's from the same seed (a world
   of one: within 1e-6 of each leaf's largest element and of each
   loss: every weight of the world of one is an exact 1.0; in a world of
   more, every rank's parameters and BatchNorm state bit for bit after
   the timed groups, each rank fed its own rows); then ms a
   step and samples/s a rank, captured (1 warm-up + 2 timed groups, with
   any host synchronisation an error) and eager (1 group), beside the
   undistributed model's in the same call, peak memory of each, the
   timed groups' compile taxes (no capture, no ``nvcc``), the loss
   falling; 2 captured steps against 2 eager ones bit for bit; one
   profiled group (the NCCL kernels' share of device time).  (c) The
   flagship through `ParallelWrapper`: 2 warm-up and 6 measured steps,
   exactly 8 launches each of B1, B2 and B3 a step, captured == eager,
   tokens/s beside the undistributed step's.  (b) Two gloo ranks sharing
   the card (eager steps: gloo collectives cannot be captured):
   ResNet-50 in f32 with Nesterovs 1e-6 at 64 rows a rank, 2 steps,
   against one undistributed model fed the 128-row concatenation (losses,
   parameters and BatchNorm statistics within rtol 2e-4 / atol 2e-5,
   every element; the first summed gradient within twice its own floor)
   and the two ranks' replicas bit for bit; then at Nesterovs 1e-2 a
   replicated run, ZeRO-1 and ZeRO-2 bit for bit against it, ZeRO-2
   (grad_accum 2) and int8 compression within 0.05 of its last loss (the
   JAX compression rule; BatchNorm statistics of microbatches and of a
   rank's rows differ; their parameters' change against its change is
   reported), the ZeRO runs holding less optimizer state a rank;
   `write_model_distributed` of the ZeRO-1 model, restored on the card
   equal to rank 1's parameters, layer state and gathered optimizer
   state.  Writes under ``build/dp/`` and removes it.
18. mp — model parallelism inside the step (ROADMAP A11 items 1, 3 and
   4) in one world the phase spawns: two gloo ranks sharing the card
   when one is visible (eager steps), else one NCCL rank a card, 4 when
   4 or more are visible and 2 otherwise (captured steps).  The
   flagship runs 4 of its 8 blocks here (``MP_LAYERS``; the depth cut
   for the script's time).  (a) TP: the
   flagship with ``model=n`` (the embedding split by columns, the
   chunked head by vocabulary); (b) SP: the flagship with ``seq=n`` at
   the training batch's 4 x 2048 ids, Ulysses (B1-B3 on B x H / n
   heads of the whole sequence) and ring attention (no flash kernel);
   (c) EP: the attn phase's MoE flagship (8 experts, top-2; 4 of its 8
   blocks, ``MP_EP_LAYERS``) with ``expert=n``.  Each: 2 f32 steps with Sgd (``MP_LR``; the MoE
   flagship's ``MP_MOE_LR``) from the
   undistributed model's weights against that model (rank 0): every
   loss within rtol 2e-4, the parameters' change within ``MP_STEP_REL``
   relative L2 of its change; the replicated leaves bit-identical
   across ranks; ``output()`` of 2 x 2048 ids within ``MP_OUT_REL`` of
   max |undistributed|; then the bf16 model (Adam) timed, 1 warm-up and
   2 steps: ms a step, tokens/s and peak reserved memory a rank beside
   the undistributed step's (printed, not gated; on NCCL the timed
   steps run with any host synchronisation an error, and no capture or
   ``nvcc`` run among them), and exactly 8 launches a step of B1, B2
   and B3 (TP, Ulysses; 4 for EP) or none (ring).  (a) also writes the TP
   model (`write_model`, every rank) and restores it undistributed on
   the card: equal to the gathered parameters.  B1-B3 at Ulysses' shape
   (BH 4 x 8 / n, T 2048, D 128, causal) against their plain versions.
   (d) ResNet-50 with ``model=n`` (every convolution's output channels
   split, BatchNorm whole), f32, Nesterovs 1e-6, 8 rows of 224 x 224 x 3,
   2 steps against the undistributed model: losses within rtol 2e-4,
   replicas bit-identical, the change within ``MP_FLOOR_X`` times the
   larger of the undistributed model's own floors (its rows' halves
   swapped; native convolutions) or ``MP_STEP_REL``.  (e) C27: the MoE
   flagship with ``data=n``, each rank its rows, against the
   undistributed model on the concatenated rows (f32, Sgd
   ``MP_MOE_LR``, one step: ``MP_C27_STEPS`` says why): the loss as in
   (a); the change within ``MP_C27_BOUND`` and within ``MP_FLOOR_X``
   times the larger of its own floors (cuBLASLt at the same chunking;
   chunks of 4096) or ``MP_STEP_REL``; before the step, the forward of
   the step's scopes (each rank its rows, routed in the global batch)
   within ``MP_STEP_REL`` relative L2 of the undistributed one's, at most
   ``MP_C27_ROUTES`` of each MoE layer's (token, choice) pairs routed
   otherwise, and every MoE layer's dropped share equal.  (f) PP: the
   flagship's ``MP_LAYERS`` blocks over ``pipe=n`` in ``MP_PP_MICRO`` microbatches,
   GPipe and 1F1B, each held as (a) (reusing (a)'s undistributed run)
   and timed as (a), with exactly 2 m M launches of B1 and m M of B2 and
   B3 a step a rank (m = 4 / n blocks a stage, M microbatches: each
   stage's forward, its recompute in the backward, and the backward);
   1F1B against GPipe (losses within rtol 2e-4, change within
   ``MP_STEP_REL``); B1-B3 at the microbatch's shape (BH 8, T 2048, D
   128) against their plain versions.  (g) `plan()` of the bf16
   flagship over the world at 4 x 2048 ids on every rank: no kernel
   launched, no library requested, no capture, the model unchanged; its
   summary, pick and each candidate's predicted step beside the measured
   one (pipe=n, the undistributed step), and the per-hop seconds the
   pipe=n step implies; then ``distribute(auto=True)`` in the world,
   which installs a pick as wide as the world or raises C28's
   `PlanError`.  Writes under ``build/mp/`` and removes it.
19. samediff — SameDiff and the TF importer (ROADMAP A13, first part).
   (a) BASELINE config 4: bench.py bench_bert's frozen BERT-base
   classifier (vocab 30522, d 768, 12 heads, 12 layers, 32 x 128, seed 4)
   written by the port's writer, parsed by its wire codec and imported
   with ``trainable=True`` on the card (MB and seconds of each); f32
   rows 0-1 of its logits (TF32 off) against the port's CPU output() of
   the batch-2 graph of the same seed (1e-4 of max |logit|; their loss
   1e-4 relative); then Adam 2e-5 with ``bf16_compute`` on
   BertIterator batches of bench_bert's word list: 2 captured steps
   equal 2 eager steps from one state bit for bit (losses, trainables,
   Adam state) and send no q, k, v to B1-B3, 6 captured steps timed
   and 2 eager: ms a step,
   samples/s, FLOPs a step (3 x bench.py's forward count x the batch),
   MFU against the bf16 peak, peak memory; finite losses; exactly no
   B1-B5 launch (the imported graph has no attention op).  (b) A BERT
   built in code at the same widths, each of 12 blocks
   `multi_head_dot_product_attention` over (32, 128, 12, 64), trained on
   whether the first token's id is even, bf16 then f32: output() launches
   exactly 12 B1; 2 captured steps equal 2 eager, and in the eager
   ones B1 and B2/B3 take q, k, v 12 times a step each, all bf16 in the
   bf16 run (the wgmma kernels) and all f32 in the f32 run (the split
   kernels); 8 captured steps launch exactly 12 B1, 12 B2 and 12 B3 a
   step; the loss falls; B1-B3
   at BH 384, T 128, D 64, non-causal, bf16 and f32, against their
   plain versions.  (c) Zips: the imported graph with 2 layers at
   BERT-base widths and the code-built BERT cut to 2 blocks, both with
   no control flow and so plain zips (ops and values): the step after
   load equals the never-saved run's bit for bit (Adam state and RNG
   position restored); bytes and seconds of each; the two saves run
   side by side in two threads; written under ``build/samediff/`` and
   removed.  (d) examples/finetune_imported.py's V1 loop graph imported
   with ``trainable=True``: the loop's ``max_trip`` 4 and
   ``exact_trip``, 6 captured Adam steps whose losses match the port's
   CPU run within 1e-5 relative, the in-loop weight moved; its control
   flow makes its zip source-backed (the graph's bytes, re-imported on
   load), and the step after load equals the never-saved run's bit for
   bit.
20. report — one ``{"kernels": [...]}`` JSON line, then the last line
   ``{"ok": true, "device": {...}}``.

Every phase that fails raises; nothing is caught on the way to exit 0.
Details also go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

PHASES = ("kernels", "train", "train_f32", "lenet", "serve", "server", "fleet", "spec",
          "parity", "int8", "quant", "qserve", "ckpt", "attn", "resnet", "etl", "tools", "rnn",
          "dp", "mp", "samediff")
EXTRA_PHASES = ("profile", "paged", "stages")

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "f32": 67e12}

VOCAB, D_MODEL, HEADS, LAYERS = 32000, 1024, 8, 8
ENGINE = dict(slots=8, page_size=16, num_pages=512, max_pages_per_seq=160)
# bench.py bench_longctx's training batch: 4 sequences of 2048 tokens
TRAIN_BATCH, TRAIN_SEQ, TRAIN_WARMUP, TRAIN_STEPS = 4, 2048, 2, 6
# eager steps after the captured ones, timed beside them (not gated)
TRAIN_EAGER = 3

TOL = {  # max |kernel - plain| allowed, with the reason
    # flash forward out, f32: f32 both sides, different summation order;
    # the kernel also drops each operand's bits past two bf16 parts and
    # the lo x lo part product (~2^-16 of a product)
    "flash_fwd/f32": 2e-4,
    # flash forward out, bf16, relative to max |plain|: the plain version
    # rounds Q * scale and P to bf16 where the kernel does, but the kernel
    # rounds P against the running max of its 128-key tiles and the plain
    # version against the row's max, so a stored element can land one bf16
    # rounding away: at most 2^-7 of the largest
    "flash_fwd/bf16": 2**-7,
    # the same, row by row: max |kernel - plain| of each query row relative
    # to that row's max |plain|, so rows whose outputs are small (a row that
    # averages n keys is ~sqrt(e/n)) are held to their own scale; one bf16
    # ulp of the row's largest element from the stored rounding (read up
    # to 2^-7 on the CPU against the Pallas kernel, and on the card) plus
    # the f32 sums' order: 2^-6.  V read from the wrong ring stage reads
    # 2.6 (`flash_fwd_fault_case`)
    "flash_fwd_row/bf16": 2**-6,
    # flash forward lse, absolute: f32 sums of up to T exponentials in
    # another order (and exp2 with log2(e) folded into the scores in bf16:
    # measured up to 1.9e-6 on the card); in bf16 an unrounded Q * scale
    # would move it by ~2e-3
    "flash_fwd_lse/f32": 2e-4,
    "flash_fwd_lse/bf16": 1e-5,
    "paged_attention_fwd": 1e-4,       # f32 both sides, order of the sums
    # flash backward, relative to max |plain| of each gradient: f32 sums
    # of up to T products in another order; in bf16 the plain version
    # rounds Q * scale, P and dS where the kernels do, so the f32 sums'
    # order can still move a stored gradient by one bf16 ulp, at most
    # 2^-7 (7.8e-3) of the largest
    "flash_bwd/f32": 1e-4,
    "flash_bwd/bf16": 8e-3,
    "paged_attention_fwd_int8": 1e-4,  # same int8 values dequantised both sides
    # dequant-matmul, relative to max |plain|: f32 sums of K products in
    # another order (and the scale once after the sum, not in each
    # weight); the error grows as sqrt(K).  The tensor-core route also
    # drops x's bits past its two bf16 parts (~2^-17 of each product):
    # the CPU emulation (tests/test_torch_split_precision.py) reads
    # 2.0e-6 to 2.4e-6 of max |plain| at K 1024 and 4096
    "dequant_matmul/K1024": 1e-5,
    "dequant_matmul/K4096": 2e-5,
}
# the quant path: 2 x 2048 ids through the flagship with its softmax head
QUANT_BATCH, QUANT_SEQ, QUANT_WARMUP, QUANT_CALLS = 2, 2048, 1, 3
DM_SHAPES = [(4096, 1024, 1024), (4096, 1024, 4096), (4096, 4096, 1024),
             (4096, 1024, VOCAB), (8, 1024, 4096), (1, 4096, 4096)]
DM_RAGGED = (5, 100, 72)
# B5 at the quantized engine's decode (8 rows a step) and verify (8 slots x
# 5 rows) shapes besides (8, 1024, 4096): the block's products and the head
DM_SERVE_SHAPES = [(8, 1024, 1024), (8, 4096, 1024), (8, 1024, VOCAB),
                   (40, 1024, 1024), (40, 1024, 4096), (40, 4096, 1024),
                   (40, 1024, VOCAB)]
# B4's head dims besides the flagship's 128: 32 lanes hold Dh / 32 values
# each where 32 divides Dh, else strided lanes
PAGED_CHECK_DIMS = (16, 48, 80, 96, 192, 256)
PAGED_DIMS = tuple(range(16, 257, 16))       # every instantiated head dim
# B4's timed mixes: the serve phase's (one long stream, short ones, one
# idle slot), and the full pool (504 of the 511 usable pages, 8 x 1008
# positions: ~66 MB of f32 K/V, past the 50 MB L2)
PAGED_MIXES = {"serve": [2017, 20, 150, 300, 5, 64, 0, 90], "full_pool": [1008] * 8}
# the speculative verify: k drafts a stream, so C = k + 1 rows a slot
SPEC_K = 4
# /v1/infer: 16 requests of 256 token ids, coalesced into batches of 8
INFER_REQUESTS, INFER_SEQ, INFER_BATCH = 16, 256, 8
# /v1/infer at load: closed-loop clients sending back to back while the
# batcher runs (in-process: two full batches in flight, one forming while
# the other dispatches; HTTP: one batch), a warm-up, then the measured
# window; requests/s counts completions inside the window, latencies the
# requests started inside it
INFER_LOAD = {"in_process": (16, 0.5, 3.0), "http": (8, 0.5, 4.0)}
# the wedge: the engine's watchdog floor for the phase (steps take ~3 ms),
# and the delayed step's sleep, well past the abort at twice the floor
WEDGE_FLOOR_S, WEDGE_DELAY_S = 0.3, 2.0
# the hot-swap's streams: long enough (~0.6 s of decode) that the push
# lands while every one of them is decoding
SWAP_NEW = 200
# ragged in M, K and N for the tensor-core route, whose TMA loads need N a
# multiple of 16 (72 is not: that shape takes the rows route alone)
DM_RAGGED_TMA = (200, 100, 48)
# the quantized model against the f32 model of the same dequantized
# weights: argmax agreement, and max |dp| relative to max p (f32 both
# sides, the products summed in another order: a few 1e-6 of each logit)
QUANT_AGREEMENT, QUANT_DP_REL = 0.99, 1e-4


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Kernel time with CUDA events, cold L2: before each launch the GPU
    sleeps while the host enqueues an L2 flush and the launch, so host
    overhead never lands between the events.  The flush writes 64 MB, so
    the L2 the kernel finds is full of dirty lines that its own reads must
    write back; ``clean=True`` flushes by reading 64 MB instead (the L2 then
    holds clean lines), for bandwidth-bound kernels whose bound counts
    their reads alone."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 * 2**20, dtype=torch.int8, device="cuda")

    def __call__(self, fn, iters: int = 10, clean: bool = False) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        for a, b in ev:
            torch.cuda._sleep(20_000_000)
            if clean:
                self.flush.sum()
            else:
                self.flush.zero_()
            a.record()
            fn()
            b.record()
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in ev)


def bound_ms(n_bytes: float, n_ops: float, kind: str):
    """The least time the card could take: the larger of ``n_bytes`` over
    HBM's rate and ``n_ops`` (the function's own operations) over the
    ``kind`` peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


SASS_OPS = ("HGMMA", "HMMA", "UTMALDG", "UBLKCP")


def sass_mma_counts(lib_path) -> dict:
    """Tensor-core MMA instructions (HGMMA: wgmma; HMMA: mma.sync), TMA
    loads (UTMALDG) and bulk copies (UBLKCP) in each kernel of a built
    library, from ``cuobjdump -sass``."""
    from deeplearning4j_tpu_torch.runtime.kernels import nvcc_path

    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = dict.fromkeys(SASS_OPS, 0)
        elif fn is not None:
            for op in SASS_OPS:
                if f" {op}." in line or f" {op} " in line:
                    counts[fn][op] += 1
    return counts


def check_sass(paths):
    """The bf16 flash-backward kernels must issue tensor-core MMAs; the
    flash-forward kernels (bf16 and f32), the f32 flash-backward kernels
    and the large-M dequant-matmul kernel wgmma (HGMMA) and TMA loads
    (UTMALDG), and no f32-FMA flash-backward kernel may be left; every
    paged-attention kernel TMA loads (whole pages) and bulk copies (a
    slot's partial last page, int8 scales)."""
    out = {}
    for stem in ("flash_fwd", "flash_bwd", "dequant_matmul", "paged_attention"):
        out[stem] = counts = sass_mma_counts(paths[stem])
        for fn, c in counts.items():
            log(f"[sass] {stem} {fn}: " + ", ".join(f"{op} {c[op]}" for op in SASS_OPS))
    bwd = [c for fn, c in out["flash_bwd"].items() if "wgmma" in fn]
    if not bwd or any(c["HGMMA"] + c["HMMA"] == 0 for c in bwd):
        raise AssertionError(f"bf16 flash-backward kernels without tensor-core "
                             f"MMAs in their SASS: {out['flash_bwd']}")
    if any("_fma" in fn for fn in out["flash_bwd"]):
        raise AssertionError(f"an f32-FMA flash-backward kernel is still built: "
                             f"{list(out['flash_bwd'])}")
    for stem, names in (("flash_fwd", ("flash_fwd_wgmma", "flash_fwd_split")),
                        ("flash_bwd", ("flash_bwd_dq_split", "flash_bwd_dkdv_split")),
                        ("dequant_matmul", ("dequant_matmul_wgmma",))):
        for name in names:
            found = [c for fn, c in out[stem].items() if name in fn]
            if not found or any(c["HGMMA"] == 0 or c["UTMALDG"] == 0 for c in found):
                raise AssertionError(f"{name} missing, or without HGMMA or TMA loads "
                                     f"in its SASS: {out[stem]}")
    paged = [c for fn, c in out["paged_attention"].items() if "paged_split_kernel" in fn]
    if len(paged) != 2 * len(PAGED_DIMS) or any(
            c["UTMALDG"] == 0 or c["UBLKCP"] == 0 for c in paged):
        raise AssertionError(f"paged-attention kernels missing, or without TMA loads or "
                             f"bulk copies in their SASS: {out['paged_attention']}")
    return out


# -- kernel phase -------------------------------------------------------------

def out_errors(out, ref) -> dict:
    """max |out - ref|; the same relative to max |ref|; and the largest of
    each row's max |out - ref| relative to that row's max |ref| (rows
    along every axis but the last)."""
    diff = (out.float() - ref.float()).abs()
    mag = ref.float().abs()
    return {"max_abs_err": diff.max().item(),
            "rel_err": (diff.max() / mag.max()).item(),
            "row_err": (diff.amax(-1) / mag.amax(-1).clamp_min(1e-30)).max().item()}


def flash_case(torch, timer, t, dtype, causal=True, bh=HEADS, d=D_MODEL // HEADS):
    """Kernel B1 against `flash_fwd_plain` at (BH, T, D): out and lse
    each against its tolerance (bf16 out relative to max |plain| and row
    by row), a second launch bit for bit."""
    from deeplearning4j_tpu_torch.ops.flash_attention import (
        flash_fwd,
        flash_fwd_plain,
        flash_fwd_work,
    )
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(t)
    q, k, v = (torch.randn((bh, t, d), generator=g, device="cuda").to(dtype)
               for _ in range(3))
    out, lse = flash_fwd(q, k, v, causal=causal)
    again = flash_fwd(q, k, v, causal=causal)
    ref, ref_lse = flash_fwd_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])):
        raise AssertionError(f"flash forward at {[bh, t, d]}: a second launch "
                             "gave other bits")
    del again
    kind = "bf16" if dtype == torch.bfloat16 else "f32"
    errs = out_errors(out, ref)
    # the function's FLOPs (the port's own count of B1's work) on the bf16
    # peak, in f32 too: the card reaches f32 accuracy on bf16 tensor cores
    # (by split parts)
    (_, n_ops, n_bytes), = flash_fwd_work(bh, t, d, causal, q.element_size())
    b_ms, b_by = bound_ms(n_bytes, n_ops, "bf16")
    qs, ks, vs = (x[None] for x in (q, k, v))        # (1, BH, T, D) for sdpa
    row = {
        "name": "flash_fwd",
        "kernel": "flash_fwd_wgmma" if kind == "bf16" else "flash_fwd_split",
        "dtype": kind, "shape": [bh, t, d], "causal": causal,
        "max_abs_err": errs["max_abs_err"], "tol": TOL[f"flash_fwd/{kind}"],
        "lse_err": (lse - ref_lse).abs().max().item(),
        "lse_tol": TOL[f"flash_fwd_lse/{kind}"],
        "second_launch_identical": True,
        "ms": timer(lambda: flash_fwd(q, k, v, causal=causal)),
        "plain_ms": timer(lambda: flash_fwd_plain(q, k, v, causal=causal)),
        "library_ms": timer(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=causal)),
        "bound_ms": b_ms, "bound_by": b_by,
    }
    if kind == "bf16":
        row.update(rel_err=errs["rel_err"], row_err=errs["row_err"],
                   row_tol=TOL["flash_fwd_row/bf16"])
    else:
        # log only: the split design's own floor, three bf16 part products
        # (hi hi, hi lo, lo hi) for each product, and the f32-FMA bound of
        # the CUDA-core kernel it replaced
        row["part_floor_ms"] = bound_ms(n_bytes, 3 * n_ops, "bf16")[0]
        row["f32_fma_bound_ms"] = bound_ms(n_bytes, n_ops, "f32")[0]
    return row


def layout_case(torch, timer):
    """`flash_attention` on the training step's (B, T, H, D) bf16 layout
    against kernel B1 alone on the same values: the difference is the
    (B, T, H, D) <-> (BH, T, D) copies around the kernel."""
    from deeplearning4j_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_fwd,
    )

    b, t, h, d = TRAIN_BATCH, TRAIN_SEQ, HEADS, D_MODEL // HEADS
    g = torch.Generator(device="cuda").manual_seed(11)
    q, k, v = (torch.randn((b, t, h, d), generator=g, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    bhtd = [x.permute(0, 2, 1, 3).reshape(b * h, t, d).contiguous() for x in (q, k, v)]
    res = {
        "shape_bthd": [b, t, h, d],
        "flash_attention_ms": timer(lambda: flash_attention(q, k, v, causal=True)
                                    .reshape(b, t, h * d)),
        "kernel_ms": timer(lambda: flash_fwd(*bhtd, causal=True)),
    }
    res["layout_copies_ms"] = res["flash_attention_ms"] - res["kernel_ms"]
    log(f"[kernels] flash_attention (B, T, H, D) = {[b, t, h, d]} bf16, with its "
        f"layout copies: {res['flash_attention_ms']:.4f} ms; B1 alone "
        f"{res['kernel_ms']:.4f} ms; copies {res['layout_copies_ms']:.4f} ms")
    return res


def split_backward(fa) -> bool:
    """Whether the port under test runs the f32 backward on split parts
    (its launchers take the split scratch), or the f32-FMA kernels of an
    older tree (``--package-root``)."""
    import inspect

    return "parts" in inspect.signature(fa.launch_bwd_dq).parameters


def flash_bwd_cases(torch, timer, t, dtype, causal=True, d=D_MODEL // HEADS,
                    bh=TRAIN_BATCH * HEADS):
    """Rows for kernels B2 (dQ) and B3 (dK/dV) at BH 32 (the training
    batch's heads) by default: each against `flash_bwd_plain` on the same inputs,
    and a second launch of each against the first, bit for bit; plain
    and library times cover both kernels together (the plain version and
    the sdpa backward compute dq, dk and dv in one call).  In f32 a
    launcher's call also splits the inputs and computes delta from them;
    the kernel alone on split parts (``kernel_ms``) and the backward as
    `flash_bwd` runs it, one split for both kernels (``pair_ms``), are
    timed beside it."""
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops.flash_attention import (
        flash_bwd_plain,
        flash_bwd_work,
        flash_fwd,
        launch_bwd_dkdv,
        launch_bwd_dq,
    )
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(t + d + 1)
    q, k, v, g = (torch.randn((bh, t, d), generator=gen, device="cuda").to(dtype)
                  for _ in range(4))
    out, lse = flash_fwd(q, k, v, causal=causal)
    delta = (g.float() * out.float()).sum(-1)
    kind = "bf16" if dtype == torch.bfloat16 else "f32"
    split = kind == "f32" and split_backward(fa)
    if split:   # each call splits the inputs and writes its own delta
        def dq_call():
            return launch_bwd_dq(q, k, v, g, lse, torch.empty_like(delta), causal, out=out)

        def dkdv_call():
            return launch_bwd_dkdv(q, k, v, g, lse, torch.empty_like(delta), causal, out=out)
    else:
        def dq_call():
            return launch_bwd_dq(q, k, v, g, lse, delta, causal)

        def dkdv_call():
            return launch_bwd_dkdv(q, k, v, g, lse, delta, causal)
    dq = dq_call()
    dk, dv = dkdv_call()
    rq, rk, rv = flash_bwd_plain(q, k, v, out, lse, g, causal=causal)
    again = (dq_call(), *dkdv_call())
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again)):
        raise AssertionError(f"flash backward at {[bh, t, d]} causal={causal}: "
                             "a second launch gave other bits")
    del again

    def rel_err(a, b):
        diff = (a.float() - b.float()).abs().max().item()
        return diff, diff / b.float().abs().max().item()

    plain_ms = timer(lambda: flash_bwd_plain(q, k, v, out, lse, g, causal=causal))
    qs, ks, vs = (x.detach()[None].requires_grad_(True) for x in (q, k, v))
    gs = g[None]

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)

    def sdpa_fwd_bwd():
        return torch.autograd.grad(sdpa_fwd(), (qs, ks, vs), gs)

    # the backward alone: forward + backward minus the forward
    library_ms = timer(sdpa_fwd_bwd) - timer(sdpa_fwd)
    # the port's own count of B2's and B3's work: name -> (FLOPs, bytes)
    work = {n: (f, b) for n, f, b in flash_bwd_work(bh, t, d, causal, q.element_size())}
    kernel = {"bf16": "wgmma", "f32": "split" if split else "fma"}[kind]
    extra = {}
    if split:
        parts, d_split = fa.bwd_parts(q), torch.empty_like(delta)
        launch_bwd_dq(q, k, v, g, lse, d_split, causal, parts, out=out)
        extra = {
            "flash_bwd_dq": {"kernel_ms": timer(lambda: launch_bwd_dq(
                q, k, v, g, lse, d_split, causal, parts))},
            "flash_bwd_dkdv": {"kernel_ms": timer(lambda: launch_bwd_dkdv(
                q, k, v, g, lse, d_split, causal, parts))},
        }
        pair_ms = timer(lambda: fa.flash_bwd(q, k, v, out, lse, g, causal=causal))
        for e in extra.values():
            e["pair_ms"] = pair_ms
    rows = []
    for name, fn, errs in (
            ("flash_bwd_dq", dq_call, [rel_err(dq, rq)]),
            ("flash_bwd_dkdv", dkdv_call, [rel_err(dk, rk), rel_err(dv, rv)])):
        n_ops, n_bytes = work[name]
        # the function's FLOPs on the bf16 peak, in f32 too: the card
        # reaches f32 accuracy on bf16 tensor cores (by split parts)
        b_ms, b_by = bound_ms(n_bytes, n_ops, "bf16")
        row = {
            "name": name, "kernel": f"{name}_{kernel}", "dtype": kind,
            "shape": [bh, t, d], "causal": causal,
            "max_abs_err": max(e[0] for e in errs),
            "rel_err": max(e[1] for e in errs), "tol": TOL[f"flash_bwd/{kind}"],
            "second_launch_identical": True,
            "ms": timer(fn), "plain_ms": plain_ms, "library_ms": library_ms,
            "plain_and_library_cover": "dq, dk and dv together",
            "bound_ms": b_ms, "bound_by": b_by, **extra.get(name, {}),
        }
        if kind == "f32":
            # log only: the split design's floor, three bf16 part products a
            # product, and the f32-FMA bound of the CUDA-core kernels it
            # replaced
            row["part_floor_ms"] = bound_ms(n_bytes, 3 * n_ops, "bf16")[0]
            row["f32_fma_bound_ms"] = bound_ms(n_bytes, n_ops, "f32")[0]
        rows.append(row)
    del qs, ks, vs
    return rows


def paged_inputs(torch, quant: bool, dh, mix):
    """q, pools, table, lengths and (int8) scales over the engine's pool
    for one of `PAGED_MIXES`: each live slot its own pages, seed 7."""
    from deeplearning4j_tpu_torch.serving.kv_cache import quantize_page_rows

    s, h = ENGINE["slots"], HEADS
    ps, mp, n_pages = ENGINE["page_size"], ENGINE["max_pages_per_seq"], ENGINE["num_pages"]
    g = torch.Generator(device="cuda").manual_seed(7)
    perm = (torch.randperm(n_pages - 1, generator=g, device="cuda") + 1).int()
    tbl = torch.zeros((s, mp), dtype=torch.int32, device="cuda")
    used = 0
    for i, n in enumerate(PAGED_MIXES[mix]):
        k_n = -(-n // ps)
        tbl[i, :k_n] = perm[used:used + k_n]
        used += k_n
    seq = torch.tensor(PAGED_MIXES[mix], dtype=torch.int32, device="cuda")
    q = torch.randn((s, h, dh), generator=g, device="cuda")
    kp = torch.randn((n_pages, ps, h, dh), generator=g, device="cuda")
    vp = torch.randn((n_pages, ps, h, dh), generator=g, device="cuda")
    ksc = vsc = None
    if quant:
        kp, ksc = quantize_page_rows(kp)
        vp, vsc = quantize_page_rows(vp)
    return q, kp, vp, tbl, seq, ksc, vsc


def paged_case(torch, timer, quant: bool, dh=D_MODEL // HEADS, mix="serve"):
    """Kernel B4 against `paged_attention_plain` over the engine's pool and
    160-wide page tables, at head dim ``dh`` and one of `PAGED_MIXES`; a
    second launch must give the same bits, an idle slot exact zeros.  Timed
    only at the flagship's head dim."""
    from deeplearning4j_tpu_torch.ops.paged_attention import (
        paged_attention_fwd,
        paged_attention_plain,
        paged_attention_work,
    )

    s, h = ENGINE["slots"], HEADS
    ps, mp = ENGINE["page_size"], ENGINE["max_pages_per_seq"]
    lens = PAGED_MIXES[mix]
    q, kp, vp, tbl, seq, ksc, vsc = paged_inputs(torch, quant, dh, mix)
    out = paged_attention_fwd(q, kp, vp, tbl, seq, ksc, vsc)
    again = paged_attention_fwd(q, kp, vp, tbl, seq, ksc, vsc)
    ref = paged_attention_plain(q, kp, vp, tbl, seq, ksc, vsc)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    name = "paged_attention_fwd_int8" if quant else "paged_attention_fwd"
    if not torch.equal(out, again):
        raise AssertionError(f"{name} {mix} at head dim {dh}: a second launch gave "
                             "other bits")
    if any(out[i].abs().max().item() != 0.0 for i, n in enumerate(lens) if n == 0):
        raise AssertionError(f"{name} {mix}: idle slot output is not exact zero")
    row = {
        "name": name, "dtype": "int8" if quant else "f32", "mix": mix,
        "shape": [s, h, dh, ps, mp], "seq_lens": lens,
        "max_abs_err": err, "tol": TOL[name], "second_launch_identical": True,
    }
    if dh != D_MODEL // HEADS:
        return row
    # the port's own count of B4's work at these lengths
    (_, n_ops, n_bytes), = paged_attention_work(lens, h, dh, ps, kp.element_size(),
                                                quant)
    b_ms, b_by = bound_ms(n_bytes, n_ops, "f32")

    def fn():
        return paged_attention_fwd(q, kp, vp, tbl, seq, ksc, vsc)

    row.update({
        "ms": timer(fn),
        "plain_ms": timer(lambda: paged_attention_plain(q, kp, vp, tbl, seq, ksc, vsc)),
        "library_ms": None,     # no single PyTorch call attends over a page table
        "bound_ms": b_ms, "bound_by": b_by,
        # log only: the same launch after an L2 flush that leaves no dirty
        # lines, and the host's time to enqueue one call (a decode step
        # makes one a layer and waits on the host)
        "clean_l2_ms": timer(fn, clean=True),
        "host_ms": host_ms(torch, fn),
    })
    return row


def chunk_case(torch, timer, quant: bool):
    """B4 at the verify's shape through `paged_attention_chunk` (S x C
    pseudo-slots, each slot's table row repeated C times) against
    `paged_attention_chunk_plain`, over the serve mix with each slot's
    pages holding C more rows; a second launch must give the same bits,
    the idle slot exact zeros.  The bound counts each slot's K/V rows
    once, though the pseudo-slots read them C times."""
    from deeplearning4j_tpu_torch.ops.paged_attention import (
        paged_attention_chunk,
        paged_attention_chunk_plain,
        paged_attention_chunk_work,
    )

    s, h, dh, c = ENGINE["slots"], HEADS, D_MODEL // HEADS, SPEC_K + 1
    ps, mp = ENGINE["page_size"], ENGINE["max_pages_per_seq"]
    lens = PAGED_MIXES["serve"]
    _, kp, vp, tbl, seq, ksc, vsc = paged_inputs(torch, quant, dh, "serve")
    g = torch.Generator(device="cuda").manual_seed(8)
    q = torch.randn((s, c, h, dh), generator=g, device="cuda")
    attend = torch.where(seq[:, None] > 0,
                         seq[:, None] + torch.arange(1, c + 1, device="cuda"), 0).int()

    def fn():
        return paged_attention_chunk(q, kp, vp, tbl, attend, k_scale=ksc, v_scale=vsc)

    out, again = fn(), fn()
    ref = paged_attention_chunk_plain(q, kp, vp, tbl, attend, ksc, vsc)
    torch.cuda.synchronize()
    name = "paged_attention_chunk_int8" if quant else "paged_attention_chunk"
    if not torch.equal(out, again):
        raise AssertionError(f"{name}: a second launch gave other bits")
    if any(out[i].abs().max().item() != 0.0 for i, n in enumerate(lens) if n == 0):
        raise AssertionError(f"{name}: idle slot output is not exact zero")
    # the port's own count: each slot's rows once, what every row attends
    (_, n_ops, n_bytes), = paged_attention_chunk_work(
        attend.tolist(), h, dh, ps, kp.element_size(), quant)
    b_ms, b_by = bound_ms(n_bytes, n_ops, "f32")
    return {
        "name": name, "kernel": "paged_attention_chunk", "dtype": "int8" if quant else "f32",
        "mix": "verify", "shape": [s, c, h, dh, ps, mp], "seq_lens": lens,
        "max_abs_err": (out - ref).abs().max().item(), "tol": TOL["paged_attention_fwd"],
        "second_launch_identical": True,
        "ms": timer(fn),
        "plain_ms": timer(lambda: paged_attention_chunk_plain(q, kp, vp, tbl, attend,
                                                              ksc, vsc)),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "clean_l2_ms": timer(fn, clean=True), "host_ms": host_ms(torch, fn),
    }


def host_ms(torch, fn, calls: int = 200) -> float:
    """Host milliseconds a call spends enqueueing ``fn`` (no sync between
    calls; the card runs behind)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return t


def timer_floor(torch, timer) -> dict:
    """What the Timer reads around nothing (its event pair) and around one
    empty kernel launch: the part of a short kernel's row that is not the
    kernel's work."""
    res = {"events_only_ms": timer(lambda: None),
           "empty_launch_ms": timer(lambda: torch.cuda._sleep(0))}
    log(f"[kernels] Timer floor: event pair alone {res['events_only_ms']:.4f} ms, "
        f"around one empty launch {res['empty_launch_ms']:.4f} ms")
    return res


def phase_kernels(torch, timer):
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for t in (2048, 2000, 144):
            rows.append(flash_case(torch, timer, t, dtype))
        rows.append(flash_case(torch, timer, TRAIN_SEQ, dtype,
                               bh=TRAIN_BATCH * HEADS))
        for t in (TRAIN_SEQ, 2000):
            rows.extend(flash_bwd_cases(torch, timer, t, dtype))
    # B1 at the server's /v1/infer batch: 8 requests of 256 ids
    rows.append(flash_case(torch, timer, INFER_SEQ, torch.bfloat16,
                           bh=INFER_BATCH * HEADS))
    # the tensor-core (bf16) backward off the training shape: non-causal,
    # a serve bucket, and a head dim of 64
    rows.extend(flash_bwd_cases(torch, timer, TRAIN_SEQ, torch.bfloat16, causal=False))
    rows.extend(flash_bwd_cases(torch, timer, 144, torch.bfloat16))
    rows.extend(flash_bwd_cases(torch, timer, TRAIN_SEQ, torch.bfloat16, d=64))
    # B4 at head dims the flagship does not serve, every multiple of 16 on
    # one lane mapping or the other: checked, not timed
    check_rows("kernels", [paged_case(torch, timer, quant, dh)
                           for dh in PAGED_CHECK_DIMS for quant in (False, True)])
    rows = check_rows("kernels", rows)
    paged, floor = phase_paged(torch, timer)
    return rows + paged, layout_case(torch, timer), floor


def phase_paged(torch, timer):
    """B4's timed rows (both page types, every mix of `PAGED_MIXES`) and the
    Timer's floor: part of the kernels phase, and alone a phase of its own
    for comparing two trees."""
    rows = [paged_case(torch, timer, quant, mix=mix)
            for mix in PAGED_MIXES for quant in (False, True)]
    from deeplearning4j_tpu_torch.ops import paged_attention as pa

    if hasattr(pa, "paged_attention_chunk"):
        rows += [chunk_case(torch, timer, quant) for quant in (False, True)]
    else:           # a --package-root tree from before the verify
        log("[paged] no paged_attention_chunk in this tree: verify rows skipped")
    return check_rows("paged", rows), timer_floor(torch, timer)


B4_DESIGN = ("flash-decoding: (slot, chunk of 2 f32 or 4 int8 pages, 2-head group) "
             "items, walked by twice as many blocks as the card holds, with no host "
             "read of seq_lens; whole pages by TMA box, a slot's partial last page by "
             "cp.async.bulk rows, into shared memory, one mbarrier a page; f32 online "
             "softmax per warp; the last block of a (slot, group), by ticket, merges "
             "the chunks' partials in chunk order through shared memory")


# the planted fault of `flash_fwd_fault_case`: P_j V_j reads V from the
# ring stage after tile j's
FLASH_FWD_FAULT = ("const uint32_t vs = sm_s + OS + (j % NSTAGE) * STAGE + KB;",
                   "const uint32_t vs = sm_s + OS + ((j + 1) % NSTAGE) * STAGE + KB;")


def flash_fwd_fault_case(torch):
    """Build `flash_fwd_wgmma` with the planted P V fault into
    ``build/fault/``, run it in place of the kernel (causal, bf16) at the
    training and serve-prefill shapes on `flash_case`'s inputs, and fail
    unless the row-by-row out tolerance rejects what it gives."""
    import ctypes

    from deeplearning4j_tpu_torch.ops.flash_attention import flash_fwd, flash_fwd_plain
    from deeplearning4j_tpu_torch.runtime import kernels

    src = (kernels.CSRC / "flash_fwd.cu").read_text()
    if src.count(FLASH_FWD_FAULT[0]) != 1:
        raise AssertionError("fault: the line to break is not once in csrc/flash_fwd.cu")
    work = kernels.build_dir().parent / "fault"
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(kernels.CSRC, work)
    (work / "flash_fwd.cu").write_text(src.replace(*FLASH_FWD_FAULT))
    lib_path = work / "flash_fwd_fault.so"
    subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", str(lib_path),
                    str(work / "flash_fwd.cu")], check=True, capture_output=True, timeout=600)
    broken = ctypes.CDLL(str(lib_path))
    broken.dl4j_flash_fwd.argtypes = kernels.SIGNATURES["flash_fwd"]["dl4j_flash_fwd"]
    broken.dl4j_flash_fwd.restype = ctypes.c_int
    sound = kernels.library("flash_fwd")
    d, rows = D_MODEL // HEADS, []
    for bh, t in ((TRAIN_BATCH * HEADS, TRAIN_SEQ), (HEADS, SERVE_LENGTHS[0])):
        g = torch.Generator(device="cuda").manual_seed(t)
        q, k, v = (torch.randn((bh, t, d), generator=g, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        ref, ref_lse = flash_fwd_plain(q, k, v, causal=True)
        kernels._LIBS["flash_fwd"] = broken
        try:
            out, lse = flash_fwd(q, k, v, causal=True)
            torch.cuda.synchronize()
        finally:
            kernels._LIBS["flash_fwd"] = sound
        r = {"shape": [bh, t, d], **out_errors(out, ref),
             "lse_err": (lse - ref_lse).abs().max().item()}
        r["caught_by_max"] = not r["rel_err"] <= TOL["flash_fwd/bf16"]
        r["caught_by_rows"] = not r["row_err"] <= TOL["flash_fwd_row/bf16"]
        log(f"[fault] V from the next stage, shape={r['shape']}: rel_err={r['rel_err']:.3e} "
            f"(tol {TOL['flash_fwd/bf16']:.1e}, caught {r['caught_by_max']}) "
            f"row_err={r['row_err']:.3e} (tol {TOL['flash_fwd_row/bf16']:.1e}, caught "
            f"{r['caught_by_rows']}) lse_err={r['lse_err']:.3e}")
        rows.append(r)
    if not all(r["caught_by_rows"] for r in rows):
        raise AssertionError(f"the row-by-row out tolerance let a P V fault through: {rows}")
    return rows


# `stages_case`: where kernel B4's time goes.  Each insertion goes right
# after its anchor line of csrc/paged_attention.cu (each anchor must be there
# once): block b stamps %globaltimer into stamp[b][0..6] at its start, when
# the slots' lengths are counted, and for its first item when every copy is
# issued, the last page has landed, the pages are computed, its ticket is
# taken (chunked slots) and the item is done (merged, where it merged).
STAGE_MARKS = (
    ("namespace {\n",
     "__device__ unsigned long long stamp[8192][8];\n"
     "__device__ __forceinline__ unsigned long long now_ns() {\n"
     "  unsigned long long t; asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n}\n"),
    ("paged_split_kernel(const __grid_constant__ Args a) {\n",
     "  const unsigned long long t_start = now_ns();\n"
     "  const bool rec = threadIdx.x == 0 && blockIdx.x < 8192;\n  bool first = true;\n"),
    ("  const int n_items = carry;\n",
     "  if (rec) { stamp[blockIdx.x][0] = t_start; stamp[blockIdx.x][1] = now_ns(); }\n"),
    ("    // this warp's head, and its turn among the head's team\n",
     "    if (rec && first) stamp[blockIdx.x][2] = now_ns();\n"),
    ("      mbar_wait(smem_addr(&bars[j]), (phase >> j) & 1);\n",
     "      if (rec && first && j == np - 1) stamp[blockIdx.x][3] = now_ns();\n"),
    ("    phase ^= (1u << np) - 1;\n",
     "    if (rec && first) stamp[blockIdx.x][4] = now_ns();\n"),
    ("        const int t = atomicAdd(ticket, 1);\n",
     "        if (rec && first) stamp[blockIdx.x][5] = now_ns();\n"),
    ("    __syncthreads();   // the next item's copies reuse the page buffers\n",
     "    if (rec && first) stamp[blockIdx.x][6] = now_ns();\n    first = false;\n"),
)
STAGE_READ = """
extern "C" int dl4j_stamps(void* dst, int clear) {
  static unsigned long long zero[8192][8];
  return (int)(clear ? cudaMemcpyToSymbol(stamp, zero, sizeof(zero))
                     : cudaMemcpyFromSymbol(dst, stamp, sizeof(zero)));
}
"""


def stages_case(torch, timer):
    """Build kernel B4 with `STAGE_MARKS` into ``build/stages/``, launch it
    in place of the kernel on `paged_case`'s inputs after the Timer's L2
    flush, and print, in us from the first block's start: when the blocks
    start and finish counting lengths, and for the items (medians, and the
    last) when copies are issued, pages land, pages are computed, tickets
    are taken and items are done.  A diagnostic: its times include the
    stamps' own stores."""
    import ctypes

    import numpy as np

    from deeplearning4j_tpu_torch.ops.paged_attention import paged_attention_fwd
    from deeplearning4j_tpu_torch.runtime import kernels

    src = (kernels.CSRC / "paged_attention.cu").read_text()
    for anchor, text in STAGE_MARKS:
        if src.count(anchor) != 1:
            raise AssertionError(f"stages: anchor not once in paged_attention.cu: {anchor!r}")
        src = src.replace(anchor, anchor + text)
    work = kernels.build_dir().parent / "stages"
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(kernels.CSRC, work)
    (work / "paged_attention.cu").write_text(src + STAGE_READ)
    lib_path = work / "paged_attention_stages.so"
    subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", str(lib_path),
                    str(work / "paged_attention.cu")], check=True, capture_output=True,
                   timeout=600)
    lib = ctypes.CDLL(str(lib_path))
    lib.dl4j_paged_attention.argtypes = \
        kernels.SIGNATURES["paged_attention"]["dl4j_paged_attention"]
    lib.dl4j_paged_attention.restype = ctypes.c_int
    sound = kernels.library("paged_attention")
    buf = np.zeros((8192, 8), np.uint64)
    out = {}
    for mix in PAGED_MIXES:
        for quant in (False, True):
            q, kp, vp, tbl, seq, ksc, vsc = paged_inputs(torch, quant, D_MODEL // HEADS, mix)
            kernels._LIBS["paged_attention"] = lib
            try:
                paged_attention_fwd(q, kp, vp, tbl, seq, ksc, vsc)
                torch.cuda.synchronize()
                lib.dl4j_stamps(None, 1)
                torch.cuda._sleep(20_000_000)
                timer.flush.zero_()
                paged_attention_fwd(q, kp, vp, tbl, seq, ksc, vsc)
                torch.cuda.synchronize()
                lib.dl4j_stamps(buf.ctypes.data, 0)
            finally:
                kernels._LIBS["paged_attention"] = sound
            blocks = buf[buf[:, 0] > 0].astype(np.int64)
            t = (blocks - blocks[:, 0].min()) / 1e3
            items = t[blocks[:, 2] > 0]
            ticketed = items[items[:, 5] > 0]

            def at(col, rows=items):
                return [float(np.median(rows[:, col])), float(rows[:, col].max())]

            r = {"blocks": len(blocks), "items_timed": len(items),
                 "block_start": at(0, t), "lengths_counted": at(1, t),
                 "copies_issued": at(2), "last_page_landed": at(3), "computed": at(4),
                 "ticket": at(5, ticketed) if len(ticketed) else None,
                 "item_done": at(6)}
            name = f"{mix}/{'int8' if quant else 'f32'}"
            out[name] = r
            log(f"[stages] {name}: {r['blocks']} blocks; us from the first block's start "
                f"(median, last): " + "; ".join(
                    f"{k} {v[0]:.2f}, {v[1]:.2f}" for k, v in r.items()
                    if isinstance(v, list)))
    return out


def check_rows(tag, rows):
    """Print each kernel row and fail if any disagrees with its plain
    version beyond its tolerance."""
    bad = []
    for r in rows:
        err = r.get("rel_err", r["max_abs_err"])
        extra = ""
        if "lse_err" in r:
            extra += f" lse_err={r['lse_err']:.3e} (tol {r['lse_tol']:.1e})"
        if "row_err" in r:
            extra += f" row_err={r['row_err']:.3e} (tol {r['row_tol']:.1e})"
        for key in ("kernel_ms", "pair_ms", "part_floor_ms", "f32_fma_bound_ms",
                    "clean_l2_ms", "host_ms"):
            if key in r:
                extra += f" {key}={r[key]:.5f}"
        timed = (f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
                 f"library_ms={r['library_ms']} bound_ms={r['bound_ms']:.5f} "
                 f"({r['bound_by']})" if "ms" in r else "checked, not timed")
        mix = f" {r['mix']}" if "mix" in r else ""
        log(f"[{tag}] {r.get('kernel', r['name']):26s} {r['dtype']:4s}{mix} shape={r['shape']} "
            f"err={err:.3e} ({'relative, ' if 'rel_err' in r else ''}tol "
            f"{r['tol']:.1e}) {timed}{extra}")
        if (not err <= r["tol"] or not r.get("lse_err", 0.0) <= r.get("lse_tol", 0.0)
                or not r.get("row_err", 0.0) <= r.get("row_tol", 0.0)):
            bad.append(r)
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")
    return rows


# -- serving phases -------------------------------------------------------------

def _prompts(np, seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, n).astype(np.int32) for n in lengths]


def _check_streams(np, prompts, outs, max_new):
    for p, o in zip(prompts, outs):
        o = np.asarray(o)
        if o.shape != (len(p) + max_new,) or not np.array_equal(o[:len(p)], p):
            raise AssertionError(f"stream shape {o.shape} for a {len(p)}-token prompt")
        gen = o[len(p):]
        if gen.min() < 0 or gen.max() >= VOCAB:
            raise AssertionError(f"out-of-vocab token in {gen}")


def _flagship(torch, bf16=None, chunked=True, layers=LAYERS):
    from deeplearning4j_tpu_torch.zoo.transformer import TransformerEncoder

    model = TransformerEncoder(
        vocab_size=VOCAB, d_model=D_MODEL, n_heads=HEADS, n_layers=layers,
        causal=True, chunked_vocab_loss=chunked, vocab_chunk=8192, seed=123,
        bf16_compute=bf16,
    ).init_model(device="cuda")
    torch.cuda.synchronize()
    return model


def _profiled(torch, name, fn):
    """Run ``fn`` under torch.profiler: its wall time, the device busy
    share and the kernels that take the device time; the full tables go
    to ``chiprun_out/profile_<name>.txt``.  Busy time sums the device
    events only: a CPU op's row also carries its kernels' device time,
    and summing both counts each kernel twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        extra = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = prof.key_averages()
    dev = [(e.self_device_time_total, e.key, e.count) for e in rows
           if e.device_type == DeviceType.CUDA]
    busy_us = sum(t for t, _, _ in dev)
    top = sorted(dev, reverse=True)[:15]
    paged = [(t, n) for t, k, n in dev if "paged" in k]
    dequant = [(t, n) for t, k, n in dev if "dequant" in k]
    res = {"wall_s": wall, "device_busy_s": busy_us / 1e6,
           "device_busy_share": busy_us / 1e6 / wall,
           "top_device_kernels_ms": [[k, t / 1e3, n] for t, k, n in top],
           "all_device_kernels_ms": [[k, t / 1e3, n] for t, k, n in dev],
           # kernel B4's own device time and launches
           "paged_attention_device_ms": sum(t for t, _ in paged) / 1e3,
           "paged_attention_launches": sum(n for _, n in paged),
           # kernel B5's (dequant_matmul_rows / _reduce / _wgmma; not split_x)
           "dequant_matmul_device_ms": sum(t for t, _ in dequant) / 1e3,
           "dequant_matmul_launches": sum(n for _, n in dequant)}
    res.update(extra or {})
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", f"profile_{name}.txt"), "w") as f:
        f.write(rows.table(sort_by="self_device_time_total", row_limit=40))
        f.write("\n\n")
        f.write(rows.table(sort_by="self_cpu_time_total", row_limit=40))
    log(f"[profile] {name}: wall {wall:.3f}s (profiled), device busy "
        f"{res['device_busy_s']:.3f}s = {res['device_busy_share']:.3f}; paged attention "
        f"{res['paged_attention_device_ms']:.3f} ms in {res['paged_attention_launches']} "
        f"launches")
    for k, ms, n in res["top_device_kernels_ms"]:
        log(f"[profile]   {ms:10.3f} ms  {n:6d}x  {k[:100]}")
    return res


def phase_profile(torch, np):
    """Two training steps, the serve phase's streams again, the int8-KV
    engine's streams again and two quantized ``output()`` calls, under
    torch.profiler.  Not part of the default run (the profiler slows the
    host)."""
    from deeplearning4j_tpu_torch.serving.generation import (
        GenerationConfig,
        GenerationEngine,
    )

    out = {}
    model = _flagship(torch)
    batch = _train_batch(np)
    for _ in range(TRAIN_WARMUP):
        model.fit_batch(batch)

    def train():
        for _ in range(2):
            model.fit_batch(batch)
        return {"steps": 2}

    out["train"] = _profiled(torch, "train", train)
    del model, batch
    torch.cuda.empty_cache()

    model = _flagship(torch)
    eng = GenerationEngine(model, GenerationConfig(**ENGINE)).start()
    try:
        _serve_pass(torch, np, eng, seed=2)                 # meet every shape

        def serve():
            st = _serve_pass(torch, np, eng, seed=4)[2]
            return {k: st[k] for k in ("prefill_seconds", "prefills",
                                       "decode_seconds", "decode_steps")}

        out["serve"] = _profiled(torch, "serve", serve)
    finally:
        eng.stop()
    del model
    torch.cuda.empty_cache()

    model = _flagship(torch, bf16=False)
    prompts = _prompts(np, 3, PARITY_LENGTHS)
    eng = GenerationEngine(model, GenerationConfig(**ENGINE, kv_dtype="int8")).start()
    try:
        _parity_streams(eng, prompts, 32)                  # meet every shape

        def int8():
            base = eng.stats()
            _parity_streams(eng, prompts, 32)
            st = eng.stats()
            return {k: st[k] - base[k] for k in ("prefill_seconds", "prefills",
                                                 "decode_seconds", "decode_steps")}

        out["int8"] = _profiled(torch, "int8", int8)
    finally:
        eng.stop()
    del model
    torch.cuda.empty_cache()

    from deeplearning4j_tpu_torch.quant import quantize
    from deeplearning4j_tpu_torch.zoo.transformer import TransformerEncoder

    qmodel = quantize(TransformerEncoder(
        vocab_size=VOCAB, d_model=D_MODEL, n_heads=HEADS, n_layers=LAYERS,
        causal=True, seed=123).init_model(device="cuda"))
    ids = np.random.default_rng(3).integers(
        0, VOCAB, (QUANT_BATCH, QUANT_SEQ)).astype(np.int64)
    qmodel.output(ids)                                      # warm-up

    def quant():
        for _ in range(2):
            qmodel.output(ids)
        return {"calls": 2}

    out["quant"] = _profiled(torch, "quant", quant)
    del qmodel
    torch.cuda.empty_cache()
    return out


def _train_batch(np):
    """bench_longctx's ids (numpy seed 3), fed as int64: the next-token
    labels of a causal LM."""
    from deeplearning4j_tpu_torch.data.dataset import DataSet

    ids = np.random.default_rng(3).integers(0, VOCAB, (TRAIN_BATCH, TRAIN_SEQ))
    return DataSet(ids.astype(np.int64), np.roll(ids, -1, axis=1).astype(np.int64))


def phase_train(torch, np, kernels, f32=False):
    """`fit_batch` of the full-width flagship on one fixed batch: warm-up
    steps, then the measured steps with the launch counters zeroed just
    before and read just after.  ``f32``: the flagship built with
    ``bf16_compute=False`` (the train_f32 phase)."""
    tag = "train_f32" if f32 else "train"
    t0 = time.perf_counter()
    model = _flagship(torch, bf16=False if f32 else None)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[{tag}] model: {n_params} params (f32 masters), compute "
        f"{model.compute_dtype}, Adam lr {model.conf.updater.learning_rate}, "
        f"built in {time.perf_counter() - t0:.1f}s")
    if f32 and model.compute_dtype != torch.float32:
        raise AssertionError(f"bf16_compute=False built a {model.compute_dtype} model")
    batch = _train_batch(np)
    losses = []
    mem0 = _memory_window(torch)
    for i in range(TRAIN_WARMUP):
        t1 = time.perf_counter()
        model.fit_batch(batch)
        losses.append(model.score_value)
        log(f"[{tag}] warm-up step {i}: loss {losses[-1]:.5f}, "
            f"{(time.perf_counter() - t1) * 1e3:.1f} ms")
    torch.cuda.synchronize()
    kernels.reset_launches()
    step_ms = []
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        t1 = time.perf_counter()
        model.fit_batch(batch)
        losses.append(model.score_value)           # synchronises
        step_ms.append((time.perf_counter() - t1) * 1e3)
        log(f"[{tag}] step {i}: loss {losses[-1]:.5f}, {step_ms[-1]:.1f} ms")
    wall = time.perf_counter() - t0
    counts = kernels.launches()
    graphs = model.compile_stats()["step_programs"]
    memory = {"captured": _memory_window(torch, mem0)}
    # the same step program run eagerly (no graph), in the same call
    model.capture_steps = False
    model._drop_graphs()
    mem0 = _memory_window(torch)
    eager_ms = []
    for i in range(TRAIN_EAGER):
        t1 = time.perf_counter()
        model.fit_batch(batch)
        losses.append(model.score_value)
        eager_ms.append((time.perf_counter() - t1) * 1e3)
    memory["eager"] = _memory_window(torch, mem0)
    model.capture_steps = True
    log(f"[{tag}] captured step (graph replay) {statistics.median(step_ms):.2f} ms "
        f"against the eager step {statistics.median(eager_ms):.2f} ms "
        f"({['%.2f' % t for t in eager_ms]}); {graphs} step graph(s); memory "
        f"(GiB) {_memory_text(memory)}")
    tokens = TRAIN_STEPS * TRAIN_BATCH * TRAIN_SEQ
    res = {
        "compute": str(model.compute_dtype), "params": n_params,
        "batch": [TRAIN_BATCH, TRAIN_SEQ],
        "warmup_steps": TRAIN_WARMUP, "steps": TRAIN_STEPS, "losses": losses,
        "step_ms": step_ms, "median_step_ms": statistics.median(step_ms),
        "eager_step_ms": eager_ms, "step_graphs": graphs,
        "wall_s": wall, "tokens_per_s": tokens / wall,
        "peak_memory_gib": {k: v["peak_gib"] for k, v in memory.items()},
        "memory": memory, "launches": counts,
    }
    log(f"[{tag}] {TRAIN_STEPS} steps of {TRAIN_BATCH}x{TRAIN_SEQ} tokens in "
        f"{wall:.3f}s = {res['tokens_per_s']:.1f} tokens/s; median step "
        f"{res['median_step_ms']:.1f} ms; peak memory captured "
        f"{memory['captured']['peak_gib']:.3f} GiB, eager "
        f"{memory['eager']['peak_gib']:.3f} GiB; launches {counts}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not losses[TRAIN_WARMUP + TRAIN_STEPS - 1] < losses[0]:
        raise AssertionError(f"training loss did not fall: {losses}")
    if graphs != 1:
        raise AssertionError(f"{graphs} step graphs for one batch signature")
    want = LAYERS * TRAIN_STEPS
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv"):
        if counts.get(name, 0) != want:
            raise AssertionError(f"{name} launched {counts.get(name, 0)} times "
                                 f"in {TRAIN_STEPS} steps, want {want}: {counts}")
    if not f32:
        res["cost"] = _step_cost(torch, model, res["median_step_ms"])
    del model, batch
    torch.cuda.empty_cache()
    return res


def _memory_window(torch, start=None):
    """Device memory of a run of steps.  Called with no ``start``, it
    empties the allocator's cache and zeroes its peaks, and returns what
    stays reserved (the live tensors, and any graph's pool); called with
    that ``start`` after the steps, it returns (GiB) the peak reserved and
    allocated since, and what stays reserved once the cache is emptied
    again (a captured step's pool stays: the graph holds it)."""
    torch.cuda.synchronize()
    if start is None:
        gc.collect()                # an earlier phase's model may sit in a cycle
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        return torch.cuda.memory_reserved() / 2**30
    peak = torch.cuda.max_memory_reserved() / 2**30
    peak_alloc = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.empty_cache()
    return {"start_gib": start, "peak_gib": peak, "peak_allocated_gib": peak_alloc,
            "held_gib": torch.cuda.memory_reserved() / 2**30}


def _memory_text(memory: dict) -> str:
    return "; ".join(f"{k}: start {v['start_gib']:.3f}, peak {v['peak_gib']:.3f} "
                     f"(allocated {v['peak_allocated_gib']:.3f}), held after "
                     f"{v['held_gib']:.3f}" for k, v in memory.items())


def _train_flops_by_hand() -> float:
    """FLOPs of one flagship training step (forward and backward), counted
    here from the shapes: each dense product 2 M N K forward and 4 M N K
    backward (dX and dW); the chunked head's products over the vocab
    padded to whole 8192-wide chunks, one forward and three backward
    (recomputed logits, dh, dW); B1 (2 products a scored pair), B2 (3) and
    B3 (4), 2 D FLOPs a pair each."""
    m, d = TRAIN_BATCH * TRAIN_SEQ, D_MODEL
    dense = LAYERS * (4 * d * d + 2 * d * 4 * d)          # sum of K x N a layer
    vpad = -(-VOCAB // 8192) * 8192
    pairs = TRAIN_BATCH * HEADS * TRAIN_SEQ * (TRAIN_SEQ + 1) // 2
    attn = LAYERS * 2 * (d // HEADS) * pairs * (2 + 3 + 4)
    return 6 * m * dense + 8 * m * d * vpad + attn


def _step_cost(torch, model, step_ms, hand=None, tag="train"):
    """`observe.cost` analysis of the training step program: its FLOPs
    against ``hand`` (`_train_flops_by_hand` by default; within 1%),
    achieved FLOP/s and MFU at the measured median step, the roofline
    class."""
    from deeplearning4j_tpu_torch.observe import cost

    t0 = time.perf_counter()
    recs = cost.analyze_model(model, memory=True)
    if len(recs) != 1 or recs[0].flops is None:
        raise AssertionError(f"cost analysis of the step: {[r.as_dict() for r in recs]}")
    rec = recs[0]
    hand = _train_flops_by_hand() if hand is None else hand
    achieved = rec.flops / (step_ms / 1e3)
    peak_f, peak_b = cost.peaks()
    out = {"flops": rec.flops, "flops_by_hand": hand, "bytes": rec.bytes_accessed,
           "kernel_work": rec.kernel_work, "achieved_flops_per_s": achieved,
           "mfu": achieved / peak_f, "peak_flops": peak_f, "peak_bytes_per_s": peak_b,
           "roofline": rec.roofline(), "arithmetic_intensity": rec.arithmetic_intensity(),
           "peak_bytes": rec.peak_bytes, "analysis_s": time.perf_counter() - t0,
           "record": rec.as_dict()}
    log(f"[{tag}] cost: {rec.flops:.6e} FLOPs a step (by hand {hand:.6e}, "
        f"{rec.flops / hand - 1:+.2e}); {rec.bytes_accessed:.4e} bytes; at the median "
        f"step {step_ms:.1f} ms: {achieved / 1e12:.2f} TFLOP/s, MFU {out['mfu']:.4f} "
        f"against {peak_f / 1e12:.0f} TFLOP/s ({torch.cuda.get_device_name(0)}); "
        f"{out['roofline']}; kernels {rec.kernel_work}; analysis "
        f"{out['analysis_s']:.2f}s")
    if abs(rec.flops / hand - 1) > 0.01:
        raise AssertionError(f"the step's counted FLOPs {rec.flops:.6e} are not within "
                             f"1% of the hand count {hand:.6e}")
    return out


SERVE_LENGTHS = [2000, 5, 40, 97, 150, 233, 300, 64]   # the last one samples


def _serve_pass(torch, np, eng, seed, max_new=32):
    """The 8 concurrent streams; returns prompts, requests, outputs, wall
    seconds and the engine's prefill / decode totals for the pass."""
    prompts = _prompts(np, seed, SERVE_LENGTHS)
    base = eng.stats()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new) for p in prompts[:-1]]
    reqs.append(eng.submit(prompts[-1], max_new, temperature=0.8, top_k=50,
                           seed=11))
    outs = [r.result(timeout=600) for r in reqs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = eng.stats()
    _check_streams(np, prompts, outs, max_new)
    ttft = [r.ttft_s for r in reqs]
    res = {
        "streams": len(reqs), "max_new_tokens": max_new,
        "tokens": len(reqs) * max_new, "wall_s": wall,
        "tokens_per_s": len(reqs) * max_new / wall,
        "mean_ttft_s": sum(ttft) / len(ttft), "ttft_s": ttft,
        "long_prompt_ttft_s": ttft[0],
    }
    for k in ("decode_steps", "decode_seconds", "prefills", "prefill_seconds"):
        res[k] = st[k] - base[k]
    # graphs captured during the pass (None: a tree without captured steps)
    res["graph_captures"] = (st["graph_captures"] - base["graph_captures"]
                             if "graph_captures" in st else None)
    return prompts, outs, res


# measured passes a serving phase makes of its streams: one pass of the
# host-bound decode step swings +-30% between runs of one tree; the first
# counts the launches, and all give the medians
PASSES = 7


def _log_medians(tag, passes, res):
    """Medians over repeated measured passes, into ``res``."""
    tps = [p["tokens_per_s"] for p in passes]
    dec = [p["decode_seconds"] for p in passes]
    res.update(passes_tokens_per_s=tps, passes_decode_seconds=dec,
               median_tokens_per_s=statistics.median(tps),
               median_decode_seconds=statistics.median(dec))
    log(f"[{tag}] {len(passes)} measured passes: median {res['median_tokens_per_s']:.1f} "
        f"tokens/s (" + ", ".join(f"{t:.1f}" for t in tps) + "), median decode "
        f"{res['median_decode_seconds']:.4f}s")


def _log_pass(name, res):
    log(f"[serve] {name}: {res['tokens']} tokens in {res['wall_s']:.3f}s = "
        f"{res['tokens_per_s']:.1f} tokens/s; mean TTFT {res['mean_ttft_s']*1e3:.1f} ms "
        f"(2000-token prompt {res['long_prompt_ttft_s']*1e3:.1f} ms); "
        f"{res['prefills']} prefills {res['prefill_seconds']:.3f}s, "
        f"{res['decode_steps']} decode steps {res['decode_seconds']:.3f}s")


def phase_serve(torch, np, kernels):
    """Passes of the same 8-stream mix on one engine: the first meets
    every prefill shape for the first time (cuBLAS picks and loads its
    kernels then), the second is the measured main path, with the launch
    counters zeroed just before it and read just after, and it and the
    `PASSES` - 1 after it give the medians."""
    from deeplearning4j_tpu_torch.ops.generation import generate
    from deeplearning4j_tpu_torch.serving.generation import (
        GenerationConfig,
        GenerationEngine,
    )

    t0 = time.perf_counter()
    model = _flagship(torch)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[serve] model: {n_params} params, compute {model.compute_dtype}, "
        f"built in {time.perf_counter() - t0:.1f}s")
    eng = GenerationEngine(model, GenerationConfig(**ENGINE)).start()
    try:
        _, _, cold = _serve_pass(torch, np, eng, seed=2)
        _log_pass("first pass (new shapes)", cold)
        kernels.reset_launches()
        prompts, outs, res = _serve_pass(torch, np, eng, seed=4)
        counts = kernels.launches()
        _log_pass("measured pass", res)
        more = [_serve_pass(torch, np, eng, seed=4)[2] for _ in range(PASSES - 1)]
        _log_medians("serve", [res] + more, res)
        res["tracing"] = _tracing_cost(torch, np, eng)
        if eng.kv.leak_check() is not None:
            raise AssertionError(eng.kv.leak_check())
    finally:
        eng.stop()
    log(f"[serve] launches in the measured pass: {counts}; graph captures "
        f"{res['graph_captures']}")
    for name in ("flash_fwd", "paged_attention_fwd"):
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"{name} never launched on the main path: {counts}")
    # one B4 launch a layer a decode step, counted across graph replays
    want = LAYERS * (32 - 1)
    if res["decode_steps"] != 32 - 1 or counts["paged_attention_fwd"] != want:
        raise AssertionError(f"{res['decode_steps']} decode steps and "
                             f"{counts['paged_attention_fwd']} B4 launches in the "
                             f"measured pass, want 31 and {want}")
    # the long stream's first token against the dense reference (the same
    # prefill through the same kernels)
    dense_first = int(generate(model, prompts[0][None], 1)[0, -1])
    if dense_first != int(outs[0][len(prompts[0])]):
        raise AssertionError("first token of the 2000-token stream differs "
                             "from the dense reference")
    if not bool(torch.isfinite(model.output(prompts[1][None])).all()):
        raise AssertionError("non-finite hidden states")
    res["launches"] = counts
    res["first_pass"] = cold
    res["streams"] = [list(map(int, o)) for o in outs]   # the fleet phase's reference
    res["sample_ms"] = sample_cost(torch)
    del model
    torch.cuda.empty_cache()
    return res


def _tracing_cost(torch, np, eng, rounds=4):
    """Decode seconds a step of the serve pass with span tracing off and
    on, in alternating passes on one engine (a tree without the serving
    plane's tracer: None)."""
    try:
        from deeplearning4j_tpu_torch.observe import tracer
    except ImportError:
        return None
    rec = tracer()
    per = {"off": [], "on": []}
    for _ in range(rounds):
        for mode in ("off", "on"):
            if mode == "on":
                rec.enable()
            try:
                r = _serve_pass(torch, np, eng, seed=4)[2]
            finally:
                rec.disable()
            per[mode].append(r["decode_seconds"] / r["decode_steps"])
    spans = len(rec)
    rec.clear()
    off, on = (statistics.median(per[m]) for m in ("off", "on"))
    log(f"[serve] tracing: decode ms a step off {off * 1e3:.4f} ("
        + ", ".join(f"{x * 1e3:.4f}" for x in per["off"]) + f"), on {on * 1e3:.4f} ("
        + ", ".join(f"{x * 1e3:.4f}" for x in per["on"]) + f"); difference "
        f"{(on - off) * 1e3:.4f} ms a step; {spans} spans recorded")
    return {"off_s_per_step": per["off"], "on_s_per_step": per["on"],
            "median_off_s": off, "median_on_s": on, "spans": spans}


def sample_cost(torch):
    """Host ms to sample one token from a (1, VOCAB) row of logits on the
    card (temperature 0.8, as the serve mix's sampled stream), top-k 50
    and top-k 0; each call ends in a sync, median of 5 rounds of 20.
    Beside the port's `_sample` (jax's noise for the finite candidates
    only, on the host), two yardsticks of the same rule that the port
    does not call: jax's noise over the whole vocabulary on the card, and
    noise from a `torch.Generator` on the card (a few launches, other
    bits than jax's)."""
    from deeplearning4j_tpu_torch.ops.generation import _sample
    from deeplearning4j_tpu_torch.runtime import rng

    def top_k_mask(scaled, top_k):
        if top_k <= 0:
            return scaled
        kth = torch.sort(scaled, dim=-1, descending=True).values[..., top_k - 1:top_k]
        return scaled.masked_fill(scaled < kth, float("-inf"))

    def jax_bits_on_card(logits, top_k, g):
        scaled = top_k_mask(logits.float() / 0.8, top_k)
        key = rng.fold_in(rng.key(11), g)
        return torch.argmax(scaled + rng.gumbel(key, scaled.shape, "cuda"), dim=-1)

    def torch_generator(logits, top_k, g):
        scaled = top_k_mask(logits.float() / 0.8, top_k)
        gen = torch.Generator(device="cuda").manual_seed(11 * 2**32 + g)
        e = torch.empty(scaled.shape, device="cuda").exponential_(generator=gen)
        return torch.argmax(scaled - torch.log(e), dim=-1)

    samplers = {
        "port": lambda x, k, g: _sample(x, temperature=0.8, top_k=k, seed=11, g=g),
        "jax_bits_on_card": jax_bits_on_card,
        "torch_generator": torch_generator,
    }
    logits = torch.randn((1, VOCAB), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(5))
    out = {}
    for top_k in (50, 0):
        want = [int(_sample(logits, temperature=0.8, top_k=top_k, seed=11, g=g)[0])
                for g in range(20)]
        if [int(jax_bits_on_card(logits, top_k, g)[0]) for g in range(20)] != want:
            raise AssertionError("the whole-vocabulary draw on the card gives "
                                 "other tokens than the port's sampler")
        for name, fn in samplers.items():
            rounds = []
            for _ in range(6):   # the first round warms up
                t0 = time.perf_counter()
                for g in range(20):
                    int(fn(logits, top_k, g)[0])
                rounds.append((time.perf_counter() - t0) / 20 * 1e3)
            out[f"{name}/top_k_{top_k}"] = statistics.median(rounds[1:])
    log(f"[serve] sampling a token from a (1, {VOCAB}) row, host ms (median of "
        "5 x 20, synced): " + ", ".join(f"{k} {v:.3f}" for k, v in out.items()))
    return out


# -- server phase -------------------------------------------------------------------



def _http(url, path, payload=None, raw=None, timeout=600):
    """(status, body bytes) of one request to the port's HTTP front."""
    import urllib.error
    import urllib.request

    data = raw if raw is not None else (
        json.dumps(payload).encode() if payload is not None else None)
    req = urllib.request.Request(url + path.lstrip("/"), data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _infer_load(np, call, rows, clients, warm_s, window_s):
    """Closed-loop load: ``clients`` threads each ``call(row)`` back to
    back for ``warm_s + window_s`` seconds.  requests/s counts the
    completions inside the window; the latency percentiles are over the
    requests started inside it (p99 needs 100 of them)."""
    import threading

    t_start = time.perf_counter()
    w0, w1 = t_start + warm_s, t_start + warm_s + window_s
    lats, done, outs, errs = [], [], [], []
    lock = threading.Lock()

    def client(i):
        k = i
        try:
            while time.perf_counter() < w1:
                t0 = time.perf_counter()
                out = call(rows[k % len(rows)])
                t1 = time.perf_counter()
                k += clients
                with lock:
                    done.append(t1)
                    if t0 >= w0:
                        lats.append(t1 - t0)
                    outs.append(out)
        except BaseException as exc:            # re-raised below
            errs.append(exc)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]
    lats.sort()
    in_window = sum(w0 <= t <= w1 for t in done)

    def pct(p):
        return lats[min(len(lats) - 1, int(p * len(lats)))] * 1e3

    return {"requests": len(done), "completed_in_window": in_window,
            "window_s": window_s, "requests_per_s": in_window / window_s,
            "n_latencies": len(lats), "p50_ms": pct(0.50) if lats else None,
            "p99_ms": pct(0.99) if len(lats) >= 100 else None,
            "outputs": outs}


def _parallel(fns):
    """Run callables on threads; their results in order (raises the
    first exception)."""
    import threading

    out, errs = [None] * len(fns), []

    def run(i, fn):
        try:
            out[i] = fn()
        except BaseException as exc:        # re-raised below
            errs.append(exc)

    threads = [threading.Thread(target=run, args=(i, fn)) for i, fn in enumerate(fns)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]
    return out


def _queued_pass(eng, submit_all, n):
    """Stop the engine's loop, have ``submit_all`` queue ``n`` streams,
    then start it: it admits them together, as the serve pass does."""
    import threading

    eng.stop()
    box = {}
    t = threading.Thread(target=lambda: box.update(out=submit_all()))
    t.start()
    t_end = time.monotonic() + 60
    while eng.queue.depth < n:
        if time.monotonic() > t_end or not t.is_alive() and "out" not in box:
            raise AssertionError(f"{eng.queue.depth} of {n} streams queued")
        time.sleep(0.002)
    eng.start()
    t.join()
    if "out" not in box:
        raise AssertionError("the streams' client failed")
    return box["out"]


def _submit_mix(eng, prompts, max_new=32):
    """The serve mix on ``eng`` in-process: the last stream samples."""
    reqs = [eng.submit(p, max_new) for p in prompts[:-1]]
    reqs.append(eng.submit(prompts[-1], max_new, temperature=0.8, top_k=50, seed=11))
    return [list(map(int, r.result(timeout=600))) for r in reqs]


def _http_mix(url, prompts, max_new=32, stream_index=1):
    """The serve mix through ``POST /v1/generate``, one thread a stream:
    stream ``stream_index`` asks for NDJSON; the last samples."""
    def one(i, p):
        body = {"prompt": p.tolist(), "max_new_tokens": max_new}
        if i == len(prompts) - 1:
            body.update(temperature=0.8, top_k=50, seed=11)
        if i == stream_index:
            body["stream"] = True
            code, raw = _http(url, "/v1/generate", body)
            lines = [json.loads(l) for l in raw.decode().splitlines()]
            if code != 200 or not lines[-1].get("done") or lines[-1]["error"]:
                raise AssertionError(f"streamed generate: {code} {lines[-1:]}")
            return p.tolist() + [l["token"] for l in lines if "token" in l]
        code, raw = _http(url, "/v1/generate", body)
        if code != 200:
            raise AssertionError(f"/v1/generate: {code} {raw[:200]}")
        return json.loads(raw)["tokens"]
    return _parallel([lambda i=i, p=p: one(i, p) for i, p in enumerate(prompts)])


def _breakdown(eng):
    st = eng.stats()
    return st["streams"]["settled"], {k: v["seconds_total"] for k, v in
                                      st["latency_breakdown"].items()}


def _perturbed(torch, model, scale=1.001):
    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return t.detach() * scale
    with torch.no_grad():
        return walk(model.params)


def _corrupt_zip(path):
    """A small model's checkpoint zip with one byte flipped mid-file."""
    from deeplearning4j_tpu_torch.train.checkpoint import ModelSerializer
    from deeplearning4j_tpu_torch.zoo.transformer import TransformerEncoder

    small = TransformerEncoder(vocab_size=VOCAB, d_model=64, n_heads=2,
                               n_layers=1).init_model(device="cpu")
    ModelSerializer.write_model(small, path)
    with open(path, "rb") as f:
        raw = bytearray(f.read())
    raw[len(raw) // 2] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(raw))


def phase_server(torch, np, kernels):
    """The serving plane on the card: an `InferenceServer` over the
    flagship with a `GenerationEngine` attached (``server=``) behind its
    HTTP front on 127.0.0.1.  Generate through HTTP, infer, scrape, a
    hot-swap in flight, torn pushes, a wedged step; see the module
    docstring."""
    from deeplearning4j_tpu_torch.observe import registry
    from deeplearning4j_tpu_torch.runtime import faults
    from deeplearning4j_tpu_torch.serving.admission import ServingRejected
    from deeplearning4j_tpu_torch.serving.generation import (
        GenerationConfig,
        GenerationEngine,
    )
    from deeplearning4j_tpu_torch.serving.http import ServingHTTPServer
    from deeplearning4j_tpu_torch.serving.server import InferenceServer, ServingConfig

    crash_dir = os.path.abspath(os.path.join("build", "crash"))
    os.environ["DL4JTPU_CRASH_DIR"] = crash_dir
    model = _flagship(torch)
    srv = InferenceServer(model, ServingConfig(
        max_batch=INFER_BATCH, max_queue=64, linger_s=0.002,
        default_deadline_s=120.0, breaker_threshold=1,
        breaker_probe_after_s=0.5)).start()
    eng = GenerationEngine(server=srv, config=GenerationConfig(**ENGINE)).start()
    http = ServingHTTPServer(srv, port=0, host="127.0.0.1").start()
    url = http.url
    res = {"url": url}
    reg = registry()

    def counter(name, **labels):
        return reg.counter(name).value(**labels)

    try:
        # -- generate: in-process, then the same streams through HTTP ---------
        _serve_pass(torch, np, eng, seed=2)       # new prefill shapes, the capture
        prompts = _prompts(np, 4, SERVE_LENGTHS)
        ref = _queued_pass(eng, lambda: _submit_mix(eng, prompts), len(prompts))
        n0, b0 = _breakdown(eng)
        kernels.reset_launches()
        steps0, t0 = eng.stats()["decode_steps"], time.perf_counter()
        got = _queued_pass(eng, lambda: _http_mix(url, prompts), len(prompts))
        wall = time.perf_counter() - t0
        counts = kernels.launches()
        n1, b1 = _breakdown(eng)
        steps = eng.stats()["decode_steps"] - steps0
        same = [g == r for g, r in zip(got, ref)]
        log(f"[server] /v1/generate: 8 streams x 32 tokens in {wall:.3f}s "
            f"({8 * 32 / wall:.1f} tokens/s, HTTP included), {steps} decode steps; "
            f"launches {counts}; streams equal to in-process generate: {same}")
        if not all(same[:-1]):
            raise AssertionError("a greedy /v1/generate stream differs from "
                                 "in-process generate")
        if steps != 31 or counts.get("paged_attention_fwd", 0) != LAYERS * 31:
            raise AssertionError(f"{steps} steps, {counts.get('paged_attention_fwd')} "
                                 f"B4 launches through HTTP, want 31 and {LAYERS * 31}")
        per = {k: (b1[k] - b0[k]) / (n1 - n0) for k in b1}
        log("[server] per-stream breakdown means (s): " + ", ".join(
            f"{k} {v:.6f}" for k, v in per.items())
            + f"; decode_compute / sampling = {per['decode_compute']:.6f} / "
            f"{per['sampling']:.6f}")
        res["generate"] = {"wall_s": wall, "decode_steps": steps, "launches": counts,
                           "equal": same, "breakdown_mean_s": per}
        res["launches"] = counts

        # -- infer: 16 in-process requests (2 batches of 8), 8 through HTTP ---
        rng = np.random.default_rng(7)
        rows = rng.integers(0, VOCAB, (INFER_REQUESTS, INFER_SEQ)).astype(np.int64)
        srv.warm_start(rows[0])
        srv.stop()
        b_before = srv.stats()["batches"]
        pend = [srv.submit(r) for r in rows]
        kernels.reset_launches()
        srv.start()
        outs = [p.result(timeout=600) for p in pend]
        infer_counts = kernels.launches()
        st = srv.stats()
        batches = st["batches"] - b_before
        refs = [model.output(rows[i:i + INFER_BATCH]).cpu().numpy()
                for i in range(0, INFER_REQUESTS, INFER_BATCH)]
        ref_rows = np.concatenate(refs)
        err = max(float(np.abs(o - r).max()) for o, r in zip(outs, ref_rows))
        scale = float(np.abs(ref_rows).max())
        log(f"[server] infer: {INFER_REQUESTS} requests of {INFER_SEQ} ids queued "
            f"before the batcher started, {batches} batches; launches "
            f"{infer_counts}; max |server - output()| {err:.3e} (max |output()| "
            f"{scale:.3f})")
        if batches != INFER_REQUESTS // INFER_BATCH or \
                infer_counts.get("flash_fwd", 0) != LAYERS * batches:
            raise AssertionError(f"{batches} batches, {infer_counts.get('flash_fwd')} "
                                 f"B1 launches: want {LAYERS} a batch dispatch")
        if err > TOL["flash_fwd/bf16"] * scale:
            raise AssertionError(f"infer rows differ from output(): {err}")
        kernels.reset_launches()
        b_before = srv.stats()["batches"]
        http_rows = rows[:INFER_BATCH]
        http_out = _parallel([
            lambda r=r: _http(url, "/v1/infer", {"features": r.tolist()})
            for r in http_rows])
        http_counts = kernels.launches()
        http_batches = srv.stats()["batches"] - b_before
        if any(code != 200 for code, _ in http_out):
            raise AssertionError(f"/v1/infer: {[c for c, _ in http_out]}")
        http_err = max(float(np.abs(np.asarray(json.loads(raw)["outputs"]) - r).max())
                       for (_, raw), r in zip(http_out, refs[0]))
        log(f"[server] /v1/infer: {len(http_rows)} requests in {http_batches} "
            f"batch(es), launches {http_counts}, max |http - output()| {http_err:.3e}")
        if http_counts.get("flash_fwd", 0) != LAYERS * http_batches or \
                http_err > TOL["flash_fwd/bf16"] * scale:
            raise AssertionError("/v1/infer: B1 launches or rows off")
        res["infer"] = {"requests": INFER_REQUESTS, "batches": batches,
                        "launches": infer_counts, "max_abs_err": err,
                        "http_launches": http_counts, "http_batches": http_batches,
                        "http_max_abs_err": http_err}

        # -- infer at load: in-process, then through HTTP --------------------
        load_rows = rng.integers(0, VOCAB, (64, INFER_SEQ)).astype(np.int64)

        def http_call(r):
            code, body = _http(url, "/v1/infer", {"features": r.tolist()})
            if code != 200:
                raise AssertionError(f"/v1/infer at load: {code} {body[:200]!r}")
            return body

        res["infer_load"] = {}
        for route, call in (("in_process", srv.infer), ("http", http_call)):
            clients, warm_s, window_s = INFER_LOAD[route]
            b_before, lb0 = srv.stats()["batches"], srv.stats()["latency_breakdown"]
            kernels.reset_launches()
            load = _infer_load(np, call, load_rows, clients, warm_s, window_s)
            if not load["n_latencies"]:
                raise AssertionError(f"infer at load ({route}): no request started "
                                     "and ended inside the window")
            st = srv.stats()
            n_batches = st["batches"] - b_before
            flash = kernels.launches().get("flash_fwd", 0)
            seg = {k: v - lb0["seconds_total"].get(k, 0.0)
                   for k, v in st["latency_breakdown"]["seconds_total"].items()}
            if route == "in_process":
                bad = [o.shape for o in load.pop("outputs")[::16]
                       if o.shape != (INFER_SEQ, D_MODEL) or not np.isfinite(o).all()]
                if bad:
                    raise AssertionError(f"infer at load: outputs off {bad}")
            else:
                load.pop("outputs")
            load.update(clients=clients, batches=n_batches, flash_fwd=flash,
                        rows_per_batch=load["requests"] / max(1, n_batches),
                        server_seconds=seg)
            log(f"[server] /v1/infer load, {route}: {clients} closed-loop clients, "
                f"{load['completed_in_window']} completed in {window_s:.1f}s = "
                f"{load['requests_per_s']:.1f} requests/s; latency over "
                f"{load['n_latencies']} requests p50 {load['p50_ms']:.2f} ms, p99 "
                + (f"{load['p99_ms']:.2f} ms" if load["p99_ms"] is not None
                   else "not resolved (fewer than 100 requests)")
                + f"; {load['requests']} requests in {n_batches} batches "
                f"({load['rows_per_batch']:.2f} rows a batch), B1 {flash}; server "
                "seconds " + ", ".join(f"{k} {v:.4f}" for k, v in seg.items()))
            if flash != LAYERS * n_batches:
                raise AssertionError(f"infer at load: {flash} B1 launches in "
                                     f"{n_batches} batches, want {LAYERS} a batch")
            res["infer_load"][route] = load

        # -- hot-swap while 8 streams decode --------------------------------
        cap0, recap0 = eng.stats()["graph_captures"], eng.stats()["graph_recaptures"]
        gen0 = srv.generation
        new = _perturbed(torch, model)
        reqs = [eng.submit(p, SWAP_NEW) for p in _prompts(np, 9, SERVE_LENGTHS)]
        t_end = time.monotonic() + 120
        while not all(len(r.tokens_so_far()) > 2 for r in reqs):
            if time.monotonic() > t_end:
                raise AssertionError("streams did not start decoding")
            time.sleep(0.001)
        during = [len(r.tokens_so_far()) for r in reqs]
        if not srv.push_weights(new, source="chip_smoke"):
            raise AssertionError("the in-flight push rolled back")
        fates = []
        for r in reqs:
            try:
                fates.append(len(r.result(timeout=600)) - len(r.prompt))
            except Exception as exc:      # counted as a dropped stream below
                fates.append(repr(exc))
        st = eng.stats()
        swap = {"tokens_at_push": during, "generated": fates,
                "generation": srv.generation - gen0,
                "captures": st["graph_captures"] - cap0,
                "recaptures": st["graph_recaptures"] - recap0}
        swap["recapture_s"] = eng.stats()["last_capture_s"]
        log(f"[server] hot-swap in flight: {swap}")
        if fates != [SWAP_NEW] * len(reqs) or swap["generation"] != 1 or \
                swap["recaptures"] != 1 or swap["captures"] != 1:
            raise AssertionError(f"hot-swap in flight: {swap}")
        # torn pushes roll back: a truncated tree, a corrupted zip over HTTP
        probe = rows[:1]
        before = model.output(probe).cpu()
        faults.arm("serving.hotswap:truncate:nth=1")
        try:
            torn = srv.push_weights(_perturbed(torch, model, 1.01))
        finally:
            faults.disarm()
        os.makedirs(crash_dir, exist_ok=True)
        bad = os.path.join(crash_dir, "corrupt.zip")
        _corrupt_zip(bad)
        code, _ = _http(url, "/v1/reload", {"path": bad})
        after = model.output(probe).cpu()
        rolled = {"truncate_installed": torn, "reload_status": code,
                  "generation": srv.generation - gen0,
                  "output_unchanged": bool(torch.equal(before, after))}
        log(f"[server] torn pushes: {rolled}")
        if torn or code != 409 or rolled["generation"] != 1 or \
                not rolled["output_unchanged"]:
            raise AssertionError(f"a torn push did not roll back: {rolled}")
        res["hotswap"] = {**swap, **rolled}

        # -- a wedged step -----------------------------------------------------
        ref = _queued_pass(eng, lambda: _submit_mix(eng, prompts), len(prompts))
        stalls0 = {s: counter("dl4jtpu_watchdog_stalls_total", stage=s)
                   for s in ("warn", "stack_dump", "abort")}
        trans0 = {to: counter("dl4jtpu_serving_breaker_transitions_total", to=to)
                  for to in ("open", "half_open", "closed")}
        dumps0 = eng.flight.dumps_written
        states = [srv.breaker.state]
        floor = eng.watchdog.floor_s
        eng.watchdog.floor_s = WEDGE_FLOOR_S
        wedged = [eng.submit(p, 32) for p in prompts[:-1]]
        while not all(r.tokens_so_far() for r in wedged):
            time.sleep(0.001)
        faults.arm(f"serving.decode:delay:nth=3,secs={WEDGE_DELAY_S}")
        try:
            outcomes = []
            for r in wedged:
                try:
                    r.result(timeout=120)
                    outcomes.append("ok")
                except Exception as exc:
                    outcomes.append(f"{r.outcome}: {exc}")
            states.append(srv.breaker.state)
            try:
                eng.submit(prompts[1], 4)
                shed = None
            except ServingRejected as exc:
                shed = exc.reason
            time.sleep(WEDGE_DELAY_S)         # the stale step wakes and drops
        finally:
            faults.disarm()
            eng.watchdog.floor_s = floor
        leak = eng.kv.leak_check()
        stalls = {s: counter("dl4jtpu_watchdog_stalls_total", stage=s) - stalls0[s]
                  for s in stalls0}
        time.sleep(srv.config.breaker_probe_after_s)
        probe_out = eng.generate(prompts[1], 4, timeout=120)   # the half-open probe
        states.append(srv.breaker.state)
        again = _queued_pass(eng, lambda: _submit_mix(eng, prompts), len(prompts))
        trans = {to: counter("dl4jtpu_serving_breaker_transitions_total", to=to)
                 - trans0[to] for to in trans0}
        wedge = {"outcomes": outcomes, "leak_check": leak, "stalls": stalls,
                 "breaker_transitions": trans,
                 "flight_dumps": eng.flight.dumps_written - dumps0,
                 "breaker_states": states, "shed_while_open": shed,
                 "probe_tokens": len(probe_out) - len(prompts[1]),
                 "same_tokens_after": [a == r for a, r in zip(again, ref)],
                 "used_pages": eng.kv.used_pages}
        log(f"[server] wedge: {wedge}")
        if not all(o.startswith("wedged") for o in outcomes) or leak is not None \
                or stalls["abort"] != 1 or wedge["flight_dumps"] < 1 \
                or states != ["closed", "open", "closed"] \
                or trans != {"open": 1, "half_open": 1, "closed": 1} \
                or shed != "breaker_open" or not all(wedge["same_tokens_after"][:-1]):
            raise AssertionError(f"wedge: {wedge}")
        res["wedge"] = wedge

        # -- scrape ----------------------------------------------------------------
        text = reg.to_prometheus_text()
        must = ('dl4jtpu_generation_streams_total{outcome="ok"}',
                'dl4jtpu_generation_streams_total{outcome="wedged"}',
                "dl4jtpu_decode_tokens_total", "dl4jtpu_kv_pages_total",
                "dl4jtpu_ttft_seconds_count",
                'dl4jtpu_serving_requests_total{outcome="ok"}',
                "dl4jtpu_serving_batches_total",
                'dl4jtpu_serving_hotswap_total{result="installed"}',
                'dl4jtpu_serving_hotswap_total{result="rolled_back"}',
                'dl4jtpu_serving_breaker_transitions_total{to="open"}',
                'dl4jtpu_generation_streams_total{outcome="breaker_open"}',
                'dl4jtpu_watchdog_stalls_total{stage="abort"}',
                'dl4jtpu_flight_dumps_total{trigger="watchdog_abort"}',
                'dl4jtpu_faults_injected_total{site="serving.decode"}',
                'dl4jtpu_ckpt_verify_failures_total{reason="corrupt"}')
        values = {}
        for m in must:
            line = next((l for l in text.splitlines() if l.startswith(m + " ")), None)
            values[m] = float(line.split()[-1]) if line else 0.0
        code_s, raw_s = _http(url, "/v1/status")
        code_h, raw_h = _http(url, "/healthz")
        status = json.loads(raw_s)
        log(f"[server] scrape: {values}; /v1/status {code_s} with "
            f"{'generation' in status and isinstance(status['generation'], dict)} "
            f"generation block; /healthz {code_h}")
        if any(v <= 0 for v in values.values()) or code_s != 200 or code_h != 200 \
                or not isinstance(status.get("generation"), dict):
            raise AssertionError(f"scrape: {values} {code_s} {code_h}")
        res["scrape"] = values
        if eng.kv.leak_check() is not None:
            raise AssertionError(eng.kv.leak_check())
    finally:
        faults.disarm()
        http.stop()
        eng.stop()
        srv.stop()
    del model
    torch.cuda.empty_cache()
    return res


# -- fleet phase ------------------------------------------------------------------

# the chaos window: closed-loop infer clients, and the kill that lands once
# the doomed replica holds queued requests (they fail `shutdown` there and
# retry on the survivor).  Four clients a batch slot: with picks alternating
# r0, r1, each replica has about 16 requests outstanding against batches of
# 8, so a queue stands behind every dispatch (with 2 a slot it formed only
# when the two replicas' batches fell out of step, and a run could end the
# kill's search with none queued)
CHAOS_CLIENTS, CHAOS_WINDOW_S = 32, 2.0
FLEET_PROBATION_S = 0.5


def _fleet(torch, roles, generation=True):
    """Two flagship replicas (seed 123 each: the same weights), batches
    of 8, and the serve engine's configuration on each when
    ``generation``."""
    from deeplearning4j_tpu_torch.serving.fleet import ServingFleet
    from deeplearning4j_tpu_torch.serving.generation import GenerationConfig
    from deeplearning4j_tpu_torch.serving.router import RouterConfig
    from deeplearning4j_tpu_torch.serving.server import ServingConfig

    return ServingFleet(
        lambda: _flagship(torch), n_replicas=2,
        config=ServingConfig(max_batch=INFER_BATCH, max_queue=64, linger_s=0.002,
                             default_deadline_s=120.0),
        # the pull cache outlives the phase: routing reads the pressure of
        # a replica's first pull (0 on both), so picks alternate r0, r1
        router_config=RouterConfig(default_deadline_s=120.0,
                                   probation_s=FLEET_PROBATION_S,
                                   health_refresh_s=3600.0),
        roles=roles,
        generation_config=GenerationConfig(**ENGINE) if generation else None)


def _fleet_generate(np, fleet, prompts, max_new=32):
    """The serve mix through `ServingFleet.generate`, one thread a stream,
    all started together (the last samples): outputs, client TTFTs (submit
    to the first token's callback) and the wall seconds."""
    t_first = [None] * len(prompts)

    def one(i, p):
        kw = dict(temperature=0.8, top_k=50, seed=11) if i == len(prompts) - 1 else {}
        t0 = time.perf_counter()

        def on_token(tok, idx):
            if idx == 0:
                t_first[i] = time.perf_counter() - t0
        return list(map(int, fleet.generate(p, max_new, on_token=on_token,
                                            timeout=600, **kw)))

    t0 = time.perf_counter()
    outs = _parallel([lambda i=i, p=p: one(i, p) for i, p in enumerate(prompts)])
    return outs, t_first, time.perf_counter() - t0


def _serial_prefills(pre, dec, prompts, max_new=32):
    """The serve mix's two hops made by one client thread: each prompt's
    `prefill_detached` on ``pre`` after the one before it ends, its
    `join_prefilled` on ``dec`` at once (the last samples).  Tokens/s,
    client TTFTs (from the first prefill's start) and the streams."""
    t_first = [None] * len(prompts)
    t0 = time.perf_counter()
    reqs, pre_s = [], 0.0
    for i, p in enumerate(prompts):
        kw = dict(temperature=0.8, top_k=50, seed=11) if i == len(prompts) - 1 else {}
        hand = pre.prefill_detached(p, max_new, **kw)
        pre_s += hand["prefill_s"]

        def on_token(tok, idx, i=i):
            if idx == 0:
                t_first[i] = time.perf_counter() - t0
        reqs.append(dec.join_prefilled(hand, on_token=on_token))
    outs = [list(map(int, r.result(timeout=600))) for r in reqs]
    wall = time.perf_counter() - t0
    return {"wall_s": wall, "tokens_per_s": len(prompts) * max_new / wall,
            "ttft_s": t_first, "mean_ttft_s": sum(t_first) / len(t_first),
            "prefill_s_total": pre_s, "outs": outs}


def _handoff_copies(torch, np, pre, prompt):
    """One prompt's detached prefill with nothing else running (its
    ``prefill_s``, the host copy included), and the host copies of a
    handoff of its size alone: K and V to pageable host memory and back."""
    pre.prefill_detached(prompt, 32)                  # this shape, once more
    torch.cuda.synchronize()
    hand = pre.prefill_detached(prompt, 32)
    kv = torch.empty((2,) + hand["k"].shape, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = kv.cpu().numpy()
    t1 = time.perf_counter()
    back = torch.from_numpy(host).to("cuda")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del back, kv
    return {"prefill_s": hand["prefill_s"], "mb": host.nbytes / 1e6,
            "d2h_s": t1 - t0, "h2d_s": t2 - t1}


def _row0(np, model, row, bucket):
    """``output()`` row 0 of ``row`` zero-padded to a ``bucket``-row batch:
    a served row is this, bit for bit, when its request dispatched in a
    batch of ``bucket`` (rows do not mix)."""
    batch = np.zeros((bucket,) + row.shape, row.dtype)
    batch[0] = row
    return model.output(batch)[0].cpu().numpy()


def phase_fleet(torch, np, kernels, report):
    """The serving fleet (`serving/fleet.py`, `serving/router.py`) on the
    card: two flagship replicas in one process.  Disaggregated generation
    (prefill on r0, decode on r1), routed inference over two ``both``
    replicas, a replica killed under load, a rolling canary deploy under
    traffic and one that the canary rolls back, the compile stats of the
    phase; see the module docstring."""
    import threading

    from deeplearning4j_tpu_torch.observe import registry
    from deeplearning4j_tpu_torch.runtime import compile_stats, faults

    os.environ["DL4JTPU_CRASH_DIR"] = os.path.abspath(os.path.join("build", "crash"))
    reg = registry()
    res = {}
    kernels.library("flash_fwd")      # every library loaded (built at the start)
    cs0 = compile_stats.snapshot()
    kernels.build_all()               # a warm kernel cache: every source a hit
    fleets = []
    try:
        # -- 1. disaggregated generation: prefill on r0, decode on r1 -------
        t0 = time.perf_counter()
        fa = _fleet(torch, ["prefill", "decode"])
        fleets.append(fa)
        fa.start()
        log(f"[fleet] prefill/decode fleet of 2 flagship replicas built in "
            f"{time.perf_counter() - t0:.1f}s")
        pre, dec = fa.engines["r0"], fa.engines["r1"]
        if pre._thread is not None:
            raise AssertionError("the prefill replica runs a decode loop")
        _fleet_generate(np, fa, _prompts(np, 2, SERVE_LENGTHS))   # new shapes, capture
        prompts = _prompts(np, 4, SERVE_LENGTHS)
        st0, (n0, b0) = dec.stats(), _breakdown(dec)
        kernels.reset_launches()
        outs, ttft, wall = _fleet_generate(np, fa, prompts)
        counts = kernels.launches()
        st1, (n1, b1) = dec.stats(), _breakdown(dec)
        steps = st1["decode_steps"] - st0["decode_steps"]
        r1_prefills = st1["prefills"] - st0["prefills"]
        handoff = (b1["handoff"] - b0["handoff"]) / (n1 - n0)
        per = {k: (b1[k] - b0[k]) / (n1 - n0) for k in b1}
        _check_streams(np, prompts, outs, 32)
        ref = _queued_pass(dec, lambda: _submit_mix(dec, prompts), len(prompts))
        same = [o == r for o, r in zip(outs, ref)]
        served = report.get("serve", {}).get("streams")
        sampled_as_serve = None if served is None else outs[-1] == served[-1]
        mean_ttft = sum(ttft) / len(ttft)
        serial = _serial_prefills(pre, dec, prompts)
        serial["equal"] = serial.pop("outs") == outs
        copies = _handoff_copies(torch, np, pre, prompts[0])
        gen = {"wall_s": wall, "tokens_per_s": len(prompts) * 32 / wall,
               "mean_ttft_s": mean_ttft, "ttft_s": ttft, "long_prompt_ttft_s": ttft[0],
               "handoff_mean_s": handoff, "handoff_share_of_mean_ttft": handoff / mean_ttft,
               "breakdown_mean_s": per, "serial_prefills": serial,
               "handoff_copies": copies,
               "decode_steps": steps, "r1_prefills": r1_prefills, "launches": counts,
               "equal_to_in_process": same, "sampled_equal_to_serve_phase": sampled_as_serve}
        log(f"[fleet] generate (prefill r0, decode r1): 8 streams x 32 tokens in "
            f"{wall:.3f}s = {gen['tokens_per_s']:.1f} tokens/s; mean TTFT "
            f"{mean_ttft * 1e3:.1f} ms (2000-token prompt {ttft[0] * 1e3:.1f} ms); "
            f"handoff {handoff * 1e3:.2f} ms a stream ({gen['handoff_share_of_mean_ttft']:.3f} "
            f"of mean TTFT); r1 {steps} decode steps, {r1_prefills} prefills; launches "
            f"{counts}; equal to r1's in-process streams {same}; sampled stream equal "
            f"to the serve phase's: {sampled_as_serve}")
        log("[fleet] r1's per-stream breakdown means (s): " + ", ".join(
            f"{k} {v:.6f}" for k, v in per.items()))
        log(f"[fleet] the same streams, r0's prefills one after another from one "
            f"client thread: {serial['tokens_per_s']:.1f} tokens/s, mean TTFT "
            f"{serial['mean_ttft_s'] * 1e3:.1f} ms (2000-token prompt "
            f"{serial['ttft_s'][0] * 1e3:.1f} ms), prefill {serial['prefill_s_total']:.4f} s "
            f"in all; streams equal: {serial['equal']}")
        log(f"[fleet] the 2000-token prompt alone, r1 idle: detached prefill "
            f"{copies['prefill_s'] * 1e3:.1f} ms; its K/V ({copies['mb']:.1f} MB) "
            f"device -> host {copies['d2h_s'] * 1e3:.1f} ms, host -> device "
            f"{copies['h2d_s'] * 1e3:.1f} ms")
        if not all(same) or not serial["equal"]:
            raise AssertionError("a fleet stream differs from the decode replica's "
                                 "in-process stream")
        if sampled_as_serve is False:
            raise AssertionError("the sampled fleet stream differs from the serve "
                                 "phase's sampled stream")
        if counts.get("flash_fwd", 0) != LAYERS * len(prompts) or r1_prefills != 0:
            raise AssertionError(f"{counts.get('flash_fwd')} B1 launches and {r1_prefills} "
                                 f"prefills on r1: want {LAYERS} a prompt, all on r0")
        if counts.get("paged_attention_fwd", 0) != LAYERS * steps or steps <= 0:
            raise AssertionError(f"{counts.get('paged_attention_fwd')} B4 launches in "
                                 f"{steps} decode steps, want {LAYERS} a step")
        if set(counts) - {"flash_fwd", "paged_attention_fwd"}:
            raise AssertionError(f"another kernel ran on the fleet's path: {counts}")
        if pre._thread is not None:
            raise AssertionError("the prefill replica started a decode loop")
        res["generate"] = gen
        res["launches"] = counts

        # -- 2. routed inference over two `both` replicas -------------------
        fb = _fleet(torch, ["both", "both"], generation=False)
        fleets.append(fb)
        rng = np.random.default_rng(7)
        rows = rng.integers(0, VOCAB, (INFER_REQUESTS, INFER_SEQ)).astype(np.int64)
        fb.warm_start(rows[0])
        name = fb.router.name

        def routed(replica, outcome="ok"):
            return reg.counter("dl4jtpu_router_requests_total").value(
                router=name, replica=replica, outcome=outcome)

        req0 = {r: routed(r) for r in ("r0", "r1")}
        box = {}
        client = threading.Thread(target=lambda: box.update(
            out=_parallel([lambda r=r: fb.infer(r, deadline_s=600) for r in rows])))
        client.start()                 # queued on both replicas before they start
        t_end = time.monotonic() + 60
        while sum(s.queue.depth for s in fb.replicas) < INFER_REQUESTS:
            if time.monotonic() > t_end:
                raise AssertionError("the routed requests never queued")
            time.sleep(0.002)
        kernels.reset_launches()
        fb.start()
        client.join()
        if "out" not in box:
            raise AssertionError("a routed request failed")
        infer_counts = kernels.launches()
        per = {r: routed(r) - req0[r] for r in ("r0", "r1")}
        batches = [s.stats()["batches"] for s in fb.replicas]
        model = fb.replicas[0].model
        same = [bool(np.array_equal(o, _row0(np, model, r, INFER_BATCH)))
                for o, r in zip(box["out"], rows)]
        log(f"[fleet] infer: {INFER_REQUESTS} routed requests of {INFER_SEQ} ids, "
            f"router counts {per}, batches {batches}, launches {infer_counts}; rows "
            f"bit-identical to output(): {sum(same)} of {len(same)}")
        if per != {"r0": INFER_BATCH, "r1": INFER_BATCH} or batches != [1, 1]:
            raise AssertionError(f"routed {per} in batches {batches}: want one batch "
                                 f"of {INFER_BATCH} on each replica")
        if infer_counts.get("flash_fwd", 0) != LAYERS * 2 or set(infer_counts) != {"flash_fwd"}:
            raise AssertionError(f"launches {infer_counts}: want {LAYERS} B1 a batch")
        if not all(same):
            raise AssertionError("a routed row differs from output()")
        res["infer"] = {"router_requests": per, "batches": batches,
                        "launches": infer_counts, "bit_identical": sum(same)}

        # -- 3. chaos: kill r1 under closed-loop load, revive it ------------
        st0 = fb.router.stats()
        dead0 = reg.counter("dl4jtpu_replica_ejections_total").value(reason="dead")
        killed = {}

        def killer():
            # the kill lands while r1 is in the first half of a batch's
            # dispatch (its EWMA: ~10 ms of host work for 8 x 256 ids) with
            # requests queued behind it: its batcher stops after that
            # batch, so the queued ones fail `shutdown` and are retried;
            # at the latest 0.3 s before the load ends
            srv = fb.replicas[1]
            time.sleep(0.5)
            t_end = time.monotonic() + CHAOS_WINDOW_S - 0.8
            while time.monotonic() < t_end:
                inflight, ewma = srv._inflight, srv._batch_ewma or 0.01
                if (inflight is not None and srv.queue.depth >= 1
                        and time.perf_counter() - inflight["t0_pc"] < ewma / 2):
                    break
                time.sleep(0.0001)
            killed["depth"] = srv.queue.depth
            fb.kill_replica(1)

        kt = threading.Thread(target=killer)
        kt.start()
        load = _infer_load(np, lambda r: fb.infer(r, deadline_s=600), rows,
                           CHAOS_CLIENTS, 0.0, CHAOS_WINDOW_S)
        kt.join()
        st1 = fb.router.stats()
        dead = reg.counter("dl4jtpu_replica_ejections_total").value(reason="dead") - dead0
        retries = st1["retries"] - st0["retries"]
        bad = [o.shape for o in load.pop("outputs")
               if o.shape != (INFER_SEQ, D_MODEL) or not np.isfinite(o).all()]
        state = fb.router.replica_states()["r1"]["state"]
        t_rev = time.perf_counter()
        if not fb.revive_replica(1):
            raise AssertionError("revive_replica(1) failed its re-sync")
        time.sleep(FLEET_PROBATION_S)
        read0 = fb.router.stats()["readmissions"]
        for r in rows[:4]:
            fb.infer(r, deadline_s=600)
        readmitted = fb.router.stats()["readmissions"] - read0
        chaos = {"requests": load["requests"], "failed": st1["failed"] - st0["failed"],
                 "retries": retries, "dead_ejections": dead, "queued_at_kill": killed,
                 "state_after_kill": state, "readmissions": readmitted,
                 "state_after_revive": fb.router.replica_states()["r1"]["state"],
                 "revive_s": time.perf_counter() - t_rev}
        log(f"[fleet] chaos: {load['requests']} requests from {CHAOS_CLIENTS} clients "
            f"in {CHAOS_WINDOW_S:.1f}s, r1 killed with {killed.get('depth')} queued: "
            f"{chaos['failed']} failed, {retries} retries, {dead} ejection(s) "
            f"'dead', r1 {state}; revived: {readmitted} readmission(s), r1 "
            f"{chaos['state_after_revive']}")
        if bad or chaos["failed"] or retries < 1 or dead != 1 or state != "probation":
            raise AssertionError(f"chaos: {chaos}, bad outputs {bad[:3]}")
        if readmitted != 1 or chaos["state_after_revive"] != "active":
            raise AssertionError(f"r1 not re-admitted through one probe: {chaos}")
        res["chaos"] = chaos

        # -- 4. rolling deploy under traffic, then a canary rollback --------
        fa.deployer.set_goldens([rows[0], rows[1]])
        cap0 = compile_stats.snapshot()
        gens0 = [s.generation for s in fa.replicas]
        new = _perturbed(torch, fa.replicas[0].model)
        stop = threading.Event()
        traffic = {"n": 0}

        def client_loop(i):
            while not stop.is_set():
                out = fa.infer(rows[i % len(rows)], deadline_s=600)
                if not np.isfinite(out).all():
                    raise AssertionError("non-finite infer output under the deploy")
                traffic["n"] += 1

        threads = [threading.Thread(target=client_loop, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        try:
            time.sleep(0.2)
            t_dep = time.perf_counter()
            dep = fa.deployer.deploy(new, source="chip_smoke")
            dep_s = time.perf_counter() - t_dep
        finally:
            stop.set()
            for t in threads:
                t.join()
        outs2, _, _ = _fleet_generate(np, fa, prompts[:2], max_new=8)
        captures = (compile_stats.snapshot() - cap0).jit_cache_misses
        gens1 = [s.generation for s in fa.replicas]
        log(f"[fleet] deploy under traffic ({traffic['n']} infer requests meanwhile): "
            f"{dep} in {dep_s:.3f}s; weights generations {gens0} -> {gens1}; graph "
            f"captures after it (deploy + 2 streams) {captures}")
        if not dep["installed"] or dep["replicas_updated"] != 2 or \
                gens1 != [g + 1 for g in gens0] or traffic["n"] <= 0:
            raise AssertionError(f"deploy under traffic: {dep}, generations {gens1}")
        if captures != 1:
            raise AssertionError(f"{captures} graph captures after the deploy, want one "
                                 "re-capture on r1 (r0 never captures)")
        x = rows[2]
        before = [s.infer(x, deadline_s=600) for s in fa.replicas]
        canary0 = reg.counter("dl4jtpu_canary_failures_total").value()
        faults.arm("serving.canary:corrupt:every=1")
        try:
            bad_dep = fa.deployer.deploy(_perturbed(torch, fa.replicas[0].model, 1.01))
        finally:
            faults.disarm()
        after = [s.infer(x, deadline_s=600) for s in fa.replicas]
        canary = reg.counter("dl4jtpu_canary_failures_total").value() - canary0
        unchanged = all(np.array_equal(a, b) for a, b in zip(before, after))
        log(f"[fleet] deploy with serving.canary:corrupt: {bad_dep}; canary failures "
            f"+{canary}; outputs bit-identical to before: {unchanged}")
        if bad_dep["installed"] or "canary:r0" not in (bad_dep["reason"] or "") or \
                bad_dep["rolled_back"] != 1 or canary != 1 or not unchanged or \
                fa.deployer.generation != 1:
            raise AssertionError(f"canary rollback: {bad_dep}, +{canary}, {unchanged}")
        res["deploy"] = {"result": dep, "seconds": dep_s, "traffic": traffic["n"],
                         "generations": [gens0, gens1], "recaptures": captures,
                         "canary_rollback": bad_dep, "canary_failures": canary}
        for srv in fa.replicas:
            eng = srv.generation_engine
            if eng.kv.leak_check() is not None:
                raise AssertionError(eng.kv.leak_check())
    finally:
        faults.disarm()
        for f in fleets:
            f.stop()

    # -- 5. compile stats of the phase: nothing compiled, every library a hit
    spent = compile_stats.snapshot() - cs0
    res["compile_stats"] = spent.as_dict()
    log(f"[fleet] compile stats of the phase: {res['compile_stats']}")
    if spent.fresh_backend_compiles != 0 or \
            spent.persistent_cache_hits != len(kernels.SIGNATURES):
        raise AssertionError(f"compile stats: {spent}; want no nvcc run and "
                             f"{len(kernels.SIGNATURES)} library hits")
    del fleets
    torch.cuda.empty_cache()
    return res


# -- spec phase ---------------------------------------------------------------------

SPEC_MAX_NEW, SPEC_ROUNDS = 100, 3
SPEC_GATE = 0.95        # the parity phase's rule, for f32 spec against plain


def _spec_pass(torch, eng, prompts, max_new=SPEC_MAX_NEW):
    """The serve prompts (the last sampled, as in the serve phase) through
    ``eng``: outputs, wall seconds, and the engine's counters for the
    pass."""
    base = eng.stats()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new) for p in prompts[:-1]]
    reqs.append(eng.submit(prompts[-1], max_new, temperature=0.8, top_k=50, seed=11))
    outs = [r.result(timeout=600) for r in reqs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = eng.stats()
    res = {"wall_s": wall, "tokens_per_s": len(reqs) * max_new / wall}
    for k in ("decode_steps", "decode_seconds", "prefills", "prefill_seconds"):
        res[k] = st[k] - base[k]
    for k in ("drafted", "accepted", "rejected", "bonus", "verify_dispatches",
              "plain_dispatches", "fallbacks"):
        res[k] = st["speculative"][k] - base["speculative"][k]
    res["acceptance_ratio"] = res["accepted"] / res["drafted"] if res["drafted"] else 0.0
    res["per_stream_drafted_accepted"] = [[r.spec_drafted, r.spec_accepted] for r in reqs]
    # a verify dispatch emits its accepted drafts and one token of its own
    res["tokens_per_verify_dispatch"] = (
        (res["accepted"] + res["bonus"]) / res["verify_dispatches"]
        if res["verify_dispatches"] else 0.0)
    return outs, res


def _first_divergence(torch, np, model, prompts, outs, refs):
    """Position and top-2 logit gap of the first token where a stream of
    ``outs`` leaves its reference: the reference's logits there, from a
    dense forward of the prompt and the reference's tokens before it."""
    from deeplearning4j_tpu_torch.ops.generation import _plan

    for i, (p, o, r) in enumerate(zip(prompts, outs, refs)):
        o, r = np.asarray(o), np.asarray(r)
        diff = np.flatnonzero(o != r)
        if not diff.size:
            continue
        at = int(diff[0])
        head = _plan(model)[3]
        params = model.compute_params()
        ids = torch.from_numpy(r[None, :at].astype(np.int64)).cuda()
        with torch.no_grad():
            h = model._forward(params, model.net_state, ids)[0][0, -1]
            logits = head.logits(params[model.conf.layers[-1].name], h).float()
        top = torch.topk(logits, 2).values
        return {"stream": i, "position": at - len(p), "token": int(o[at]),
                "reference_token": int(r[at]), "top2_gap": float(top[0] - top[1])}
    return None


def graph_check(torch, np, model, kernels, extra=None, tag="spec"):
    """The captured plain and verify steps against the eager ones, on the
    same state: 8 streams admitted into a spec engine (not started), 3
    dispatches of each width; logits and argmax bit for bit, and each
    replay counting 8 launches of its B4 route (and ``extra``'s count of
    each kernel it names)."""
    from deeplearning4j_tpu_torch.serving.generation import (
        GenerationConfig,
        GenerationEngine,
    )

    eng = GenerationEngine(model, GenerationConfig(**ENGINE, spec_k=SPEC_K))
    rng = np.random.default_rng(6)
    for slot, p in enumerate(_prompts(np, 4, SERVE_LENGTHS)):
        eng.submit(p, 64)
        eng._admit_to_slot(eng._loop_gen, slot, eng.queue.take_batch(1, 0.0, eng._stop)[0])
    res = {}
    for c, name in ((1, "paged_attention_fwd"), (SPEC_K + 1, "paged_attention_chunk")):
        want = {name: LAYERS, **(extra or {})}
        same, counted = True, []
        for _ in range(3):
            toks = np.concatenate([eng._last_tok[:, None],
                                   rng.integers(0, VOCAB, (ENGINE["slots"], c - 1))],
                                  axis=1).astype(np.int32)
            host = eng._inputs(eng._page_tbl.copy(), eng._seq_lens.copy(), toks)
            logits, greedy = (t.clone() for t in eng._run_eager(c, host))
            before = kernels.launches()
            (got, got_greedy), _ = eng._replay(c, host)
            torch.cuda.synchronize()
            after = kernels.launches()
            counted.append({k: after.get(k, 0) - before.get(k, 0) for k in want})
            same &= bool(torch.equal(got, logits) and torch.equal(got_greedy, greedy))
            nxt = greedy.view(ENGINE["slots"], c)[:, 0].cpu().numpy()
            eng._seq_lens += 1
            eng._last_tok[:] = nxt
        res[f"c{c}"] = {"bit_identical": same, "launches_per_dispatch": counted}
        log(f"[{tag}] graph check, {c} row(s) a slot: captured == eager bit for bit: "
            f"{same}; launches a dispatch {counted} (the first includes the "
            "capture's warm-up)")
        if not same or counted[1:] != [want] * 2:
            raise AssertionError(f"captured step ({c} rows) differs from the eager one "
                                 f"or miscounts its launches: {res}")
    for req in eng._slot_req:
        eng.kv.release(req.rid)
    return res


def phase_spec(torch, np, kernels):
    """Speculative decoding on the flagship; see the module docstring."""
    from deeplearning4j_tpu_torch.runtime import faults
    from deeplearning4j_tpu_torch.serving.generation import (
        GenerationConfig,
        GenerationEngine,
    )

    prompts = _prompts(np, 4, SERVE_LENGTHS)
    model = _flagship(torch)
    plain = GenerationEngine(model, GenerationConfig(**ENGINE, spec_k=0)).start()
    spec = GenerationEngine(model, GenerationConfig(**ENGINE, spec_k=SPEC_K,
                                                    spec_drafter="ngram")).start()
    res = {"spec_k": SPEC_K, "drafter": "ngram", "max_new_tokens": SPEC_MAX_NEW}
    try:
        _spec_pass(torch, plain, prompts)                  # warm-up: every shape
        _spec_pass(torch, spec, prompts)
        rounds = {"plain": [], "spec": []}
        for r in range(SPEC_ROUNDS):
            rounds["plain"].append(_spec_pass(torch, plain, prompts)[1])
            if r == 0:
                kernels.reset_launches()
            outs, one = _spec_pass(torch, spec, prompts)
            if r == 0:
                counts = kernels.launches()
                bf16_outs = outs
            rounds["spec"].append(one)
        for eng in (plain, spec):
            if eng.kv.leak_check() is not None or eng.kv.used_pages:
                raise AssertionError(f"pages left after the passes: {eng.kv.stats()}")
    finally:
        plain.stop()
        spec.stop()
    first = rounds["spec"][0]
    res.update(rounds=rounds, launches=counts,
               plain_tokens_per_s=[x["tokens_per_s"] for x in rounds["plain"]],
               spec_tokens_per_s=[x["tokens_per_s"] for x in rounds["spec"]])
    res["median_plain_tokens_per_s"] = statistics.median(res["plain_tokens_per_s"])
    res["median_spec_tokens_per_s"] = statistics.median(res["spec_tokens_per_s"])
    log(f"[spec] bf16, spec_k {SPEC_K} ngram, {len(prompts)} streams x {SPEC_MAX_NEW} "
        f"tokens: plain {res['median_plain_tokens_per_s']:.1f} tokens/s ("
        + ", ".join(f"{t:.1f}" for t in res["plain_tokens_per_s"]) + "), spec "
        f"{res['median_spec_tokens_per_s']:.1f} tokens/s ("
        + ", ".join(f"{t:.1f}" for t in res["spec_tokens_per_s"]) + ")")
    log(f"[spec] first measured spec pass: drafted {first['drafted']}, accepted "
        f"{first['accepted']} ({first['acceptance_ratio']:.4f}), bonus {first['bonus']}, "
        f"{first['tokens_per_verify_dispatch']:.4f} tokens a verify dispatch, "
        f"{first['verify_dispatches']} verify and {first['plain_dispatches']} plain "
        f"dispatches, decode {first['decode_seconds']:.3f}s; launches {counts}; per "
        f"stream (drafted, accepted) {first['per_stream_drafted_accepted']}")
    if not (first["drafted"] > 0 and first["accepted"] > 0
            and first["verify_dispatches"] > 0):
        raise AssertionError(f"speculative decode did not run: {first}")
    if (counts.get("paged_attention_chunk", 0) != LAYERS * first["verify_dispatches"]
            or counts.get("paged_attention_fwd", 0) != LAYERS * first["plain_dispatches"]):
        raise AssertionError(f"B4 launches {counts} do not match {LAYERS} a layer for "
                             f"{first['verify_dispatches']} verify and "
                             f"{first['plain_dispatches']} plain dispatches")
    del model, plain, spec
    torch.cuda.empty_cache()

    # f32 compute: the spec engine against the plain engine, the parity rule
    model = _flagship(torch, bf16=False)
    plain = GenerationEngine(model, GenerationConfig(**ENGINE, spec_k=0)).start()
    spec = GenerationEngine(model, GenerationConfig(**ENGINE, spec_k=SPEC_K)).start()
    try:
        refs, _ = _spec_pass(torch, plain, prompts)
        for tag in ("f32", "f32_corrupt"):
            if tag == "f32_corrupt":
                faults.arm("serving.draft:corrupt:every=1")
            try:
                outs, one = _spec_pass(torch, spec, prompts)
            finally:
                faults.disarm()
            agree, first_ok = _agreement(np, prompts, outs, refs)
            same = sum(bool(np.array_equal(o, r)) for o, r in zip(outs, refs))
            div = _first_divergence(torch, np, model, prompts, outs, refs)
            res[tag] = {"agreement": agree, "first_token_identical": first_ok,
                        "byte_identical_streams": same, "first_divergence": div,
                        **{k: one[k] for k in ("drafted", "accepted", "acceptance_ratio",
                                               "verify_dispatches", "plain_dispatches",
                                               "tokens_per_s")}}
            log(f"[spec] {tag}: agreement with the plain engine {agree:.4f} (gate "
                f"{SPEC_GATE}), first tokens identical {first_ok}, byte-identical "
                f"streams {same} of {len(prompts)}, first divergence {div}; drafted "
                f"{one['drafted']}, accepted {one['accepted']}, "
                f"{one['verify_dispatches']} verify dispatches")
            if agree < SPEC_GATE or not first_ok or one["verify_dispatches"] <= 0:
                raise AssertionError(f"f32 spec engine ({tag}) fails the parity rule")
            if tag == "f32_corrupt" and one["acceptance_ratio"] >= 0.5:
                raise AssertionError(f"corrupt drafts accepted: {one}")
        # int8 pages: the verify's int8 B4, held as the int8 phase holds
        # int8 pages (>= 0.9 against f32 pages), launches counted
        spec8 = GenerationEngine(model, GenerationConfig(**ENGINE, kv_dtype="int8",
                                                         spec_k=SPEC_K)).start()
        try:
            _spec_pass(torch, spec8, prompts)              # meet every shape
            kernels.reset_launches()
            outs, one = _spec_pass(torch, spec8, prompts)
            counts8 = kernels.launches()
        finally:
            spec8.stop()
        agree, first_ok = _agreement(np, prompts, outs, refs)
        res["int8"] = {"agreement": agree, "first_token_identical": first_ok,
                       "launches": counts8, **one}
        log(f"[spec] int8 pages, f32 compute: agreement with the f32-page plain engine "
            f"{agree:.4f} (gate 0.9), first tokens identical {first_ok}; drafted "
            f"{one['drafted']}, accepted {one['accepted']}, {one['verify_dispatches']} "
            f"verify and {one['plain_dispatches']} plain dispatches; launches {counts8}")
        if agree < 0.9 or not first_ok or one["verify_dispatches"] <= 0:
            raise AssertionError("int8-page spec engine fails the int8 rule")
        if (counts8.get("paged_attention_chunk_int8", 0) != LAYERS * one["verify_dispatches"]
                or counts8.get("paged_attention_fwd_int8", 0)
                != LAYERS * one["plain_dispatches"]):
            raise AssertionError(f"int8 B4 launches {counts8} do not match the dispatches")
        for eng in (plain, spec, spec8):
            if not eng.drain(60) or eng.kv.leak_check() is not None or eng.kv.used_pages:
                raise AssertionError(f"pages left after the f32 passes: {eng.kv.stats()}")
    finally:
        plain.stop()
        spec.stop()
    res["bf16_vs_f32_plain_agreement"] = _agreement(np, prompts, bf16_outs, refs)[0]
    res["graph_check"] = graph_check(torch, np, model, kernels)
    del model, plain, spec
    torch.cuda.empty_cache()
    return res


def _agreement(np, prompts, outs, refs):
    agree = total = 0
    first_ok = True
    for p, o, r in zip(prompts, outs, refs):
        a, b = np.asarray(o)[len(p):], np.asarray(r)[len(p):]
        first_ok &= bool(a[0] == b[0])
        agree += int((a == b).sum())
        total += len(a)
    return agree / total, first_ok


def phase_parity(torch, np, kernels, kv_dtype="f32", gate=0.95, refs=None):
    from deeplearning4j_tpu_torch.ops.generation import generate
    from deeplearning4j_tpu_torch.serving.generation import (
        GenerationConfig,
        GenerationEngine,
    )

    model = _flagship(torch, bf16=False)
    prompts = _prompts(np, 3, PARITY_LENGTHS)
    max_new = 32
    if refs is None:
        refs = [generate(model, p[None], max_new)[0].cpu().numpy() for p in prompts]
    eng = GenerationEngine(model, GenerationConfig(**ENGINE, kv_dtype=kv_dtype)).start()
    try:
        _parity_streams(eng, prompts, max_new)             # meet every shape
        base = eng.stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        outs = _parity_streams(eng, prompts, max_new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launches()
        st = eng.stats()
        more = []
        for _ in range(PASSES - 1):
            b, t1 = eng.stats(), time.perf_counter()
            _parity_streams(eng, prompts, max_new)
            torch.cuda.synchronize()
            e = eng.stats()
            more.append({"tokens_per_s": len(prompts) * max_new / (time.perf_counter() - t1),
                         "decode_seconds": e["decode_seconds"] - b["decode_seconds"]})
    finally:
        eng.stop()
    _check_streams(np, prompts, outs, max_new)
    agree, first_ok = _agreement(np, prompts, outs, refs)
    timing = {"wall_s": wall, "tokens_per_s": len(prompts) * max_new / wall}
    for k in ("decode_steps", "decode_seconds", "prefills", "prefill_seconds"):
        timing[k] = st[k] - base[k]
    tag = "int8" if kv_dtype == "int8" else "parity"
    log(f"[{tag}] kv {kv_dtype}, f32 compute: "
        f"greedy agreement with dense generate {agree:.4f} (gate {gate}), "
        f"first tokens identical: {first_ok}, launches {counts}")
    log(f"[{tag}] {len(prompts)} streams x {max_new} tokens in {wall:.3f}s = "
        f"{timing['tokens_per_s']:.1f} tokens/s; {timing['decode_steps']} decode steps "
        f"{timing['decode_seconds']:.3f}s, {timing['prefills']} prefills "
        f"{timing['prefill_seconds']:.3f}s (second pass of the same streams)")
    _log_medians(tag, [timing] + more, timing)
    if agree < gate or not first_ok:
        raise AssertionError(f"engine ({kv_dtype} pages) disagrees with dense generate")
    del model
    torch.cuda.empty_cache()
    return {"agreement": agree, "first_token_identical": first_ok, "gate": gate,
            "launches": counts, **timing}, refs


PARITY_LENGTHS = [600, 150, 64, 17]


def _parity_streams(eng, prompts, max_new):
    reqs = [eng.submit(p, max_new) for p in prompts]
    return [r.result(timeout=600) for r in reqs]


# -- quant phase ------------------------------------------------------------------

def int8pack_case(torch, timer, x, q, scale, ref):
    """PyTorch's own int8-weight product, ``torch._weight_int8pack_mm``
    with f32 activations, where this build has it for CUDA tensors:
    (ms, relative error, note).  A second yardstick only; the port never
    calls it."""
    fn = getattr(torch, "_weight_int8pack_mm", None)
    if fn is None:
        return None, None, "this torch has no _weight_int8pack_mm"
    w_nk = q.t().contiguous()
    try:
        y = fn(x, w_nk, scale)
        torch.cuda.synchronize()
    except RuntimeError as e:          # not built for CUDA or for f32
        return None, None, str(e).splitlines()[0][:200]
    rel = (y - ref).abs().max().item() / ref.abs().max().item()
    # median of 3: it takes up to ~0.3 s a call at the head's shape
    return timer(lambda: fn(x, w_nk, scale), iters=3), rel, "f32 activations"


def dm_case(torch, timer, m, k, n, route=None):
    """Kernel B5 against `dequant_matmul_plain` at (M, K, N): random f32
    activations, int8 weights in [-127, 127] and positive scales.  With
    ``route`` None, through `dequant_matmul` (the route it picks by shape,
    the main path's), timed; else through that route alone, checked and
    not timed.  A second launch must give the same bits."""
    from deeplearning4j_tpu_torch.ops.dequant_matmul import (
        dequant_matmul,
        dequant_matmul_plain,
        dequant_matmul_work,
        kernel_route,
        launch_dequant_matmul,
    )

    g = torch.Generator(device="cuda").manual_seed(7 * m + 3 * k + n)
    x = torch.randn((m, k), generator=g, device="cuda")
    q = torch.randint(-127, 128, (k, n), generator=g, device="cuda",
                      dtype=torch.int8)
    scale = torch.rand((n,), generator=g, device="cuda") / 127 + 1e-4
    timed = route is None
    route = kernel_route(m, n, k, q) if route is None else route

    def fn():
        return dequant_matmul(x, q, scale) if timed else \
            launch_dequant_matmul(x, q, scale, route)

    y = fn()
    again = fn()
    ref = dequant_matmul_plain(x, q, scale)
    torch.cuda.synchronize()
    if not torch.equal(y, again):
        raise AssertionError(f"dequant_matmul {route} at {[m, k, n]}: a second "
                             "launch gave other bits")
    del again
    diff = (y - ref).abs().max().item()
    row = {
        "name": "dequant_matmul", "dtype": "int8", "shape": [m, k, n],
        "kernel": f"dequant_matmul_{route}", "route": route,
        "max_abs_err": diff, "rel_err": diff / ref.abs().max().item(),
        "tol": TOL["dequant_matmul/K1024" if k <= 1024 else "dequant_matmul/K4096"],
        "second_launch_identical": True,
    }
    if not timed:
        return row
    w = q.float() * scale                  # the library's dequantized weight
    # the port's own count of B5's work, on the bf16 peak whatever the route
    (_, n_ops, n_bytes), = dequant_matmul_work(m, k, n)
    b_ms, b_by = bound_ms(n_bytes, n_ops, "bf16")
    row.update({
        "ms": timer(fn),
        "plain_ms": timer(lambda: dequant_matmul_plain(x, q, scale)),
        "library_ms": timer(lambda: torch.matmul(x, w)),
        "library": "cuBLAS f32 (torch.matmul) on the dequantized weight",
        "bound_ms": b_ms, "bound_by": b_by,
        # log only: the f32-FMA bound of the CUDA-core kernel the
        # tensor-core route replaced, and that route's own floor, two bf16
        # part products (x_hi q, x_lo q) for each multiply-add
        "f32_fma_bound_ms": bound_ms(n_bytes, n_ops, "f32")[0],
    })
    if route == "wgmma":
        row["part_floor_ms"] = bound_ms(n_bytes, 2 * n_ops, "bf16")[0]
    row["int8pack_ms"], row["int8pack_rel_err"], row["int8pack"] = int8pack_case(
        torch, timer, x, q, scale, ref)
    return row


def dm_rows(torch, timer):
    """B5 at every shape on the route the wrapper picks, timed; and the
    other route, where TMA can describe the weights (N a multiple of 16),
    checked against the plain version."""
    rows, other_rows = [], []
    for m, k, n in DM_SHAPES + DM_SERVE_SHAPES + [DM_RAGGED, DM_RAGGED_TMA]:
        rows.append(dm_case(torch, timer, m, k, n))
        other = "rows" if rows[-1]["route"] == "wgmma" else "wgmma"
        if other == "rows" or n % 16 == 0:
            other_rows.append(dm_case(torch, timer, m, k, n, route=other))
    return rows, other_rows


def _outputs(torch, model, ids, kernels=None):
    """``QUANT_WARMUP`` then ``QUANT_CALLS`` timed ``output()`` calls; with
    ``kernels``, the launch counters are zeroed just before the timed
    calls and read just after.  Returns (ms per call, counts, last out)."""
    for _ in range(QUANT_WARMUP):
        model.output(ids)
    torch.cuda.synchronize()
    if kernels is not None:
        kernels.reset_launches()
    ms = []
    for _ in range(QUANT_CALLS):
        t0 = time.perf_counter()
        out = model.output(ids)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    counts = kernels.launches() if kernels is not None else None
    return ms, counts, out


def _argmax_agreement(a, b) -> float:
    return (a.argmax(dim=-1) == b.argmax(dim=-1)).float().mean().item()


def phase_quant(torch, np, kernels, timer):
    """B5's kernel rows and B1's f32 row, then `quantize` of the
    full-width flagship with its softmax head and the measured quantized
    ``output()`` calls, held against the f32 model of the same weights."""
    from deeplearning4j_tpu_torch.models.sequential import SequentialModel
    from deeplearning4j_tpu_torch.quant import (
        dequantize_tree,
        quantize,
        quantized_bytes,
    )
    from deeplearning4j_tpu_torch.zoo.transformer import TransformerEncoder

    rows, other_rows = dm_rows(torch, timer)
    rows.append(flash_case(torch, timer, QUANT_SEQ, torch.float32,
                           bh=QUANT_BATCH * HEADS))
    check_rows("quant", rows + other_rows)
    for r in rows:
        if "int8pack" in r:
            log(f"[quant] int8pack_mm at {r['shape']}: ms={r['int8pack_ms']} "
                f"rel_err={r['int8pack_rel_err']} ({r['int8pack']})")

    def zoo(bf16):
        # bench_longctx_quant's model (default RnnOutputLayer softmax head)
        # at the flagship widths
        return TransformerEncoder(vocab_size=VOCAB, d_model=D_MODEL, n_heads=HEADS,
                                  n_layers=LAYERS, causal=True, seed=123,
                                  bf16_compute=bf16)

    ids = np.random.default_rng(3).integers(
        0, VOCAB, (QUANT_BATCH, QUANT_SEQ)).astype(np.int64)
    tokens = QUANT_BATCH * QUANT_SEQ
    model = zoo(None).init_model(device="cuda")      # bf16 compute, as served today
    bf16_ms, _, _ = _outputs(torch, model, ids)
    t0 = time.perf_counter()
    qmodel = quantize(model)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    f32_bytes = quantized_bytes(model.params)["tree_bytes"]
    qb = quantized_bytes(qmodel.params)
    log(f"[quant] quantize: {quantize_s:.2f}s; tree {f32_bytes} -> "
        f"{qb['tree_bytes']} bytes ({qb['tree_bytes'] / f32_bytes:.4f}); "
        f"quantized weights {qb['quantized_bytes']} of {qb['f32_equiv_bytes']} "
        f"f32 bytes, ratio {qb['ratio']:.4f}; compute {qmodel.compute_dtype}")
    if not qb["tree_bytes"] < f32_bytes or qmodel.compute_dtype != torch.float32:
        raise AssertionError("the quantized model is not smaller, or not f32")

    q_ms, counts, p_q = _outputs(torch, qmodel, ids, kernels)
    want = {"dequant_matmul": (6 * LAYERS + 1) * QUANT_CALLS,
            "flash_fwd": LAYERS * QUANT_CALLS}
    log(f"[quant] int8 output(): {['%.2f' % t for t in q_ms]} ms a call, "
        f"{tokens / (statistics.median(q_ms) / 1e3):.1f} tokens/s; launches "
        f"{counts} (want {want})")
    log(f"[quant] unquantized bf16 output() (as the port serves it today, for "
        f"comparison): {['%.2f' % t for t in bf16_ms]} ms a call, "
        f"{tokens / (statistics.median(bf16_ms) / 1e3):.1f} tokens/s")
    if {k: counts.get(k, 0) for k in want} != want:
        raise AssertionError(f"quantized output() launches {counts}, want {want}")
    if tuple(p_q.shape) != (QUANT_BATCH, QUANT_SEQ, VOCAB) or \
            not bool(torch.isfinite(p_q).all()):
        raise AssertionError(f"quantized output {tuple(p_q.shape)} not finite")
    row_sum_err = (p_q.sum(-1) - 1).abs().max().item()
    if row_sum_err > 1e-3:
        raise AssertionError(f"probabilities sum to 1 +- {row_sum_err}")

    # the same int8 weights, dequantized into an f32 model: cuBLAS f32
    # products and the same f32 flash forward
    ref = SequentialModel(zoo(False).conf(), device="cuda").load_params(
        dequantize_tree(qmodel.params))
    p_ref = ref.output(ids)
    agree = _argmax_agreement(p_q, p_ref)
    dp = (p_q - p_ref).abs().max().item()
    p_max = p_ref.max().item()
    del ref, p_ref
    # the original f32 weights in f32: what int8 costs (information only)
    f32w = SequentialModel(zoo(False).conf(), device="cuda").load_params(model.params)
    agree_w = _argmax_agreement(p_q, f32w.output(ids))
    log(f"[quant] vs the f32 model of the dequantized weights: argmax "
        f"agreement {agree:.5f} (gate {QUANT_AGREEMENT}), max |dp| {dp:.3e} "
        f"of max p {p_max:.3e} (gate {QUANT_DP_REL:.0e} of max p); vs the "
        f"original f32 weights (information): agreement {agree_w:.5f}")
    if agree < QUANT_AGREEMENT or dp > QUANT_DP_REL * p_max:
        raise AssertionError("the quantized model disagrees with its dequantized "
                             "f32 twin")
    del model, qmodel, f32w, p_q
    torch.cuda.empty_cache()
    return {
        "kernel_rows": rows, "other_route_rows": other_rows,
        "batch": [QUANT_BATCH, QUANT_SEQ],
        "quantize_s": quantize_s, "f32_tree_bytes": f32_bytes,
        "quantized_bytes": qb, "output_ms": q_ms,
        "tokens_per_s": tokens / (statistics.median(q_ms) / 1e3),
        "bf16_unquantized_output_ms": bf16_ms, "launches": counts,
        "agreement_vs_dequantized_f32": agree, "max_abs_dp": dp, "max_p": p_max,
        "probability_row_sum_err": row_sum_err,
        "agreement_vs_f32_weights": agree_w,
    }


# -- lenet phase --------------------------------------------------------------------

# the accuracy floor of LeNet after bench_lenet's 1,100 steps, on 5,000 test
# images: `python -m deeplearning4j_tpu_torch.bench_lenet --device cpu` read
# LENET_CPU_ACCURACY (f32, the procedural digits, 4 host threads: 141.0 s
# for the 1,000 measured steps; the last 50 losses average 1.25e-5); the
# floor leaves 0.02 for bf16 compute and another summation order on the card
LENET_CPU_ACCURACY = 1.0
LENET_ACC_FLOOR = 0.98
# B5 at quantized LeNet's products: Dense (2450 -> 500) and the head (500 ->
# 10) over the 1,000-image evaluation batches, and the entry's 8 images
LENET_DM_SHAPES = [(1000, 2450, 500), (1000, 500, 10), (8, 2450, 500)]
# held to 1e-5 of max |plain|, K 2450 included: the rows route's f32 sums
# in another order read 1.6e-6 there (this phase on an H100 80GB HBM3)
LENET_DM_TOL = 1e-5
# SimpleCNN on CIFAR-shaped data: BatchNorm and Dropout on the card
SIMPLECNN_HW, SIMPLECNN_BATCH, SIMPLECNN_STEPS, SIMPLECNN_SPE = 32, 128, 20, 10
CAPTURE_CMP_STEPS = 3
# eager LeNet steps timed beside the captured ones
LENET_EAGER_STEPS = 100
# the rows of MnistDataSetIterator's last training batch (30,000 = 58 x 512 + 304)
LENET_TAIL_ROWS = 304


def _lenet_flops_by_hand(batch: int) -> float:
    """FLOPs of one LeNet training step at ``batch``, from the shapes:
    each conv 2 x (output elements) x (kernel volume) forward, its weight
    gradient the same, its input gradient the same again except at the
    first layer (the images take none); each dense product 2 M N K
    forward and 4 M N K backward."""
    conv1 = 2 * 28 * 28 * 20 * (5 * 5 * 1)
    conv2 = 2 * 14 * 14 * 50 * (5 * 5 * 20)
    dense = 2 * 2450 * 500 + 2 * 500 * 10
    return batch * (2 * conv1 + 3 * conv2 + 3 * dense)


def _full_state(torch, model, device=None) -> dict:
    """Copies of everything a step changes: parameters, optimizer leaves
    (tensors and counts), layer state, the step counter; on ``device``
    (the card by default)."""
    from deeplearning4j_tpu_torch.models.sequential import tree_leaves
    from deeplearning4j_tpu_torch.nn.updaters import state_leaves

    def cp(x):
        if not isinstance(x, torch.Tensor):
            return int(x)
        return x.detach().to(device, copy=True) if device else x.detach().clone()

    return {"params": [cp(p) for p in tree_leaves(model.params)],
            "updater": [cp(x) for x in state_leaves(model.opt_state or ())],
            "net_state": [cp(x) for x in tree_leaves(model.net_state)],
            "iteration": model.iteration}


def _restore_state(torch, model, snap) -> None:
    """`_full_state` back into the model's own tensors (a graph reads them)."""
    from deeplearning4j_tpu_torch.models.sequential import tree_leaves
    from deeplearning4j_tpu_torch.nn.updaters import load_state_leaves

    with torch.no_grad():
        for dst, src in zip(tree_leaves(model.params), snap["params"]):
            dst.copy_(src)
        for dst, src in zip(tree_leaves(model.net_state), snap["net_state"]):
            dst.copy_(src)
    model.opt_state = load_state_leaves(model.opt_state, snap["updater"])
    model.iteration = snap["iteration"]
    model._compute = None


def _differing(torch, a: dict, b: dict) -> list:
    bad = []
    for k in ("params", "updater", "net_state"):
        for i, (x, y) in enumerate(zip(a[k], b[k])):
            if not (torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y):
                bad.append(f"{k} leaf {i}")
    if a["iteration"] != b["iteration"]:
        bad.append("iteration")
    return bad


def _captured_vs_eager(torch, model, batches, tag, phase="lenet", host=False):
    """From one snapshot, ``len(batches)`` `fit_batch` steps replaying the
    model's captured step, then the same steps eagerly (``capture_steps =
    False``: the same program on the same device inputs): losses,
    parameters, optimizer state and layer state must be bit-identical, and
    the captured run must replay, not capture again.  ``host``: the two
    end states are compared in host memory (a large model)."""
    where = "cpu" if host else None
    snap = _full_state(torch, model)
    captures0 = model.compile_stats()["jit_cache_misses"]
    cap = []
    for b in batches:
        model.fit_batch(b)
        cap.append(model._last_score.clone())
    recaptures = model.compile_stats()["jit_cache_misses"] - captures0
    after_cap = _full_state(torch, model, where)
    _restore_state(torch, model, snap)
    model.capture_steps = False
    try:
        eag = []
        for b in batches:
            model.fit_batch(b)
            eag.append(model._last_score.clone())
    finally:
        model.capture_steps = True
    after_eager = _full_state(torch, model, where)
    del snap
    same_losses = all(torch.equal(x, y) for x, y in zip(cap, eag))
    bad = _differing(torch, after_cap, after_eager)
    log(f"[{phase}] {tag}: {len(batches)} captured steps against eager from one "
        f"snapshot: losses {[x.tolist() for x in cap]} identical: {same_losses}; "
        f"state differs at {bad or 'no leaf'}; captures during the replays "
        f"{recaptures}")
    if not same_losses or bad or recaptures:
        raise AssertionError(f"{tag}: the captured step is not the eager step")
    return {"losses": [x.tolist() for x in cap], "identical": True}


def _lenet_train(torch, np, bl, batches, f32):
    """bench_lenet's warm-up and measured steps on the card."""
    from deeplearning4j_tpu_torch.observe import cost

    tag = "f32" if f32 else "bf16"
    model = bl.lenet("cuda", f32)
    mem0 = _memory_window(torch)
    t0 = time.perf_counter()
    first = bl.train(model, batches, bl.WARMUP)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    measured = bl.train(model, batches, bl.STEPS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    losses = torch.cat([first, measured]).float().cpu().numpy()
    step_ms = secs / bl.STEPS * 1e3
    memory = {"captured": _memory_window(torch, mem0)}
    # a profiled group of replays (it trains on: the gates below read
    # the measured steps)
    def group():
        bl.train(model, batches, bl.SPE)

    prof = None if f32 else _profiled(torch, "lenet", group)
    recs = cost.analyze_model(model)
    rec = next(r for r in recs if r.kind == "train")
    hand = _lenet_flops_by_hand(bl.BATCH)
    peak_f, _ = cost.peaks()
    achieved = rec.flops / (step_ms / 1e3)
    res = {"compute": str(model.compute_dtype), "warmup_s": warm_s,
           "seconds": secs, "ms_per_step": step_ms,
           "samples_per_s": bl.STEPS * bl.BATCH / secs,
           "first50_mean": float(losses[:50].mean()),
           "last50_mean": float(losses[-50:].mean()),
           "flops": rec.flops, "flops_by_hand": hand,
           "achieved_flops_per_s": achieved, "mfu": achieved / peak_f,
           "graphs": model.compile_stats()["step_programs"], "profile": prof}
    log(f"[lenet] {tag}: {bl.WARMUP} warm-up steps in {warm_s:.2f}s, {bl.STEPS} "
        f"measured in {secs:.3f}s: {step_ms:.4f} ms a step, "
        f"{res['samples_per_s']:.1f} samples/s; loss first 50 "
        f"{res['first50_mean']:.5f}, last 50 {res['last50_mean']:.5f}; "
        f"{rec.flops:.6e} FLOPs a step (by hand {hand:.6e}, "
        f"{rec.flops / hand - 1:+.2e}), {achieved / 1e12:.3f} TFLOP/s, MFU "
        f"{res['mfu']:.5f} against {peak_f / 1e12:.0f} TFLOP/s; "
        f"{res['graphs']} step graph(s)")
    if not np.isfinite(losses).all():
        raise AssertionError(f"{tag}: non-finite LeNet loss")
    if not res["last50_mean"] < res["first50_mean"]:
        raise AssertionError(f"{tag}: LeNet loss did not fall")
    if abs(rec.flops / hand - 1) > 0.01:
        raise AssertionError(f"{tag}: counted FLOPs {rec.flops} not within 1% "
                             f"of the hand count {hand}")
    t0 = time.perf_counter()
    res["accuracy"] = bl.accuracy(model)
    res["evaluate_s"] = time.perf_counter() - t0
    log(f"[lenet] {tag}: accuracy {res['accuracy']:.4f} on {bl.EVAL_EXAMPLES} "
        f"test images (floor {LENET_ACC_FLOOR}; the CPU read "
        f"{LENET_CPU_ACCURACY}) in {res['evaluate_s']:.2f}s")
    if not res["accuracy"] >= LENET_ACC_FLOOR:
        raise AssertionError(f"{tag}: LeNet accuracy {res['accuracy']} below "
                             f"{LENET_ACC_FLOOR}")
    res["captured_vs_eager"] = _captured_vs_eager(
        torch, model, batches[:CAPTURE_CMP_STEPS], f"LeNet {tag}")
    # a ragged tail batch is a second signature: its graph shares the
    # first one's pool, so what stays reserved should barely grow
    held1 = _memory_window(torch)
    tail = batches[0].split_batches(LENET_TAIL_ROWS)[0]
    model.fit_batch(tail)
    memory["second_signature"] = _memory_window(torch, held1)
    graphs2 = model.compile_stats()["step_programs"]
    # the same steps' program eagerly, with no graph held
    model.capture_steps = False
    model._drop_graphs()
    mem0 = _memory_window(torch)
    t0 = time.perf_counter()
    bl.train(model, batches, LENET_EAGER_STEPS)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) / LENET_EAGER_STEPS * 1e3
    memory["eager"] = _memory_window(torch, mem0)
    model.capture_steps = True
    res.update({"eager_ms_per_step": eager_ms, "memory": memory,
                "peak_memory_gib": {k: memory[k]["peak_gib"]
                                    for k in ("captured", "eager")}})
    log(f"[lenet] {tag}: the eager step {eager_ms:.4f} ms ({LENET_EAGER_STEPS} "
        f"steps, no graph held) against the captured {step_ms:.4f} ms; "
        f"{graphs2} step graphs after a {LENET_TAIL_ROWS}-row batch; memory "
        f"(GiB) {_memory_text(memory)}")
    if graphs2 != 2:
        raise AssertionError(f"{tag}: {graphs2} step graphs for two signatures")
    return model, res


def _simplecnn(torch, np, bl):
    """SimpleCNN at 32 x 32 x 3, batch 128, 20 steps: BatchNorm's running
    stats move; captured == eager; save / restore bit for bit."""
    import tempfile

    from deeplearning4j_tpu_torch.data.builtin import CifarDataSetIterator
    from deeplearning4j_tpu_torch.train.checkpoint import ModelSerializer
    from deeplearning4j_tpu_torch.zoo.simplecnn import SimpleCNN

    it = CifarDataSetIterator(SIMPLECNN_BATCH, train=True,
                              num_examples=SIMPLECNN_BATCH * SIMPLECNN_STEPS)
    batches = list(it)
    model = SimpleCNN(height=SIMPLECNN_HW, width=SIMPLECNN_HW).init_model("cuda")
    stats0 = _full_state(torch, model)["net_state"]
    losses = bl.train(model, batches, SIMPLECNN_STEPS, SIMPLECNN_SPE)
    losses = losses.float().cpu().numpy()
    stats = _full_state(torch, model)["net_state"]
    moved = all(not torch.equal(a, b) for a, b in zip(stats0, stats))
    finite = all(bool(torch.isfinite(s).all()) for s in stats)
    head, tail = float(losses[:5].mean()), float(losses[-5:].mean())
    log(f"[lenet] SimpleCNN {SIMPLECNN_HW}x{SIMPLECNN_HW}x3 batch {SIMPLECNN_BATCH}, "
        f"{SIMPLECNN_STEPS} steps (synthetic {it.is_synthetic}), compute "
        f"{model.compute_dtype}: losses {[round(float(x), 4) for x in losses]}; "
        f"first 5 {head:.4f}, last 5 {tail:.4f}; BatchNorm stats moved {moved}, "
        f"finite {finite}")
    if not np.isfinite(losses).all() or not tail < head or not moved or not finite:
        raise AssertionError("SimpleCNN did not train, or its BatchNorm stats")
    cmp = _captured_vs_eager(torch, model, batches[:CAPTURE_CMP_STEPS], "SimpleCNN")
    os.makedirs("build", exist_ok=True)
    path = os.path.join(tempfile.mkdtemp(dir="build"), "simplecnn.zip")
    try:
        model.save(path)
        back = ModelSerializer.restore(path, device="cuda")
        x = torch.from_numpy(batches[0].features).cuda()
        bad = _differing(torch, _full_state(torch, model), _full_state(torch, back))
        same_out = torch.equal(model.output(x), back.output(x))
    finally:
        shutil.rmtree(os.path.dirname(path), ignore_errors=True)
    log(f"[lenet] SimpleCNN saved and restored on the card: state differs at "
        f"{bad or 'no leaf'}; output() bit-identical {same_out}")
    if bad or not same_out:
        raise AssertionError("the restored SimpleCNN is not the saved one")
    return {"losses": [float(x) for x in losses], "bn_stats_moved": moved,
            "captured_vs_eager": cmp, "restored_identical": True}


def phase_lenet(torch, np, kernels, timer):
    """The LeNet slice on the card; see the module docstring."""
    from deeplearning4j_tpu_torch import bench_lenet as bl
    from deeplearning4j_tpu_torch.data.builtin import MnistDataSetIterator
    from deeplearning4j_tpu_torch.entry import entry
    from deeplearning4j_tpu_torch.models.sequential import SequentialModel
    from deeplearning4j_tpu_torch.quant import dequantize_tree, quantize

    res = {}
    fwd, (params, net_state, x8) = entry()
    out = fwd(params, net_state, x8)
    torch.cuda.synchronize()
    log(f"[lenet] entry(): forward of {tuple(x8.shape)} -> {tuple(out.shape)} "
        f"{out.dtype} on {out.device}, finite {bool(torch.isfinite(out).all())}")
    if tuple(out.shape) != (8, 10) or not bool(torch.isfinite(out).all()):
        raise AssertionError("entry() forward is not an (8, 10) finite output")

    synthetic, batches = bl.train_batches()
    res["is_synthetic"] = synthetic
    log(f"[lenet] MnistDataSetIterator(train=True, num_examples={bl.EXAMPLES}): "
        f"is_synthetic {synthetic}; {len(batches)} batches of {bl.BATCH} cycled, "
        f"fit(steps_per_execution={bl.SPE})")
    trained = None
    for f32 in (False, True):
        model, res["f32" if f32 else "bf16"] = _lenet_train(torch, np, bl, batches, f32)
        if not f32:
            trained = model
        else:
            del model
    res["simplecnn"] = _simplecnn(torch, np, bl)

    # quantized LeNet: Dense and the head through B5, the convs on a
    # dequantized kernel; against the f32 model of the same weights
    qm = quantize(trained)
    twin = SequentialModel(bl.lenet_conf(f32=True), device="cuda").load_params(
        dequantize_tree(qm.params))
    test = list(MnistDataSetIterator(bl.EVAL_BATCH, train=False,
                                     num_examples=bl.EVAL_EXAMPLES))
    feats = [torch.from_numpy(b.features).cuda() for b in test]
    qm.output(feats[0])                              # warm-up
    torch.cuda.synchronize()
    kernels.reset_launches()
    ms, outs = [], []
    for f in feats:
        t0 = time.perf_counter()
        outs.append(qm.output(f))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    counts = kernels.launches()
    res["launches"] = counts
    kernels.reset_launches()
    qm.output(x8)
    torch.cuda.synchronize()
    res["entry"] = {"launches": kernels.launches()}
    refs = [twin.output(f) for f in feats]
    agree = sum(_argmax_agreement(a, b) for a, b in zip(outs, refs)) / len(outs)
    labels = np.concatenate([b.labels.argmax(-1) for b in test])
    preds = torch.cat(outs).argmax(-1).cpu().numpy()
    q_acc = float((preds == labels).mean())
    want = {"dequant_matmul": 2 * len(feats)}
    log(f"[lenet] quantized LeNet output() of {len(feats)} x {bl.EVAL_BATCH} images: "
        f"{['%.3f' % t for t in ms]} ms a call; launches {counts} (want {want}); "
        f"the entry's 8 images {res['entry']['launches']}; argmax agreement with "
        f"the dequantized f32 twin {agree:.5f} (gate {QUANT_AGREEMENT}); accuracy "
        f"{q_acc:.4f} (the bf16 model's {res['bf16']['accuracy']:.4f})")
    if counts != want or res["entry"]["launches"] != {"dequant_matmul": 2}:
        raise AssertionError(f"quantized LeNet launched {counts}, want {want}")
    if agree < QUANT_AGREEMENT:
        raise AssertionError("quantized LeNet disagrees with its dequantized twin")
    res.update({"quantized_output_ms": ms, "quantized_agreement": agree,
                "quantized_accuracy": q_acc})
    del qm, twin, trained, feats, outs, refs
    torch.cuda.empty_cache()
    rows = [dm_case(torch, timer, m, k, n) for m, k, n in LENET_DM_SHAPES]
    for r in rows:
        r["tol"] = LENET_DM_TOL
    check_rows("lenet", rows)
    res["kernel_rows"] = rows
    return res


# -- qserve phase -----------------------------------------------------------------

# B5 launches a prefill and a decode (or verify) dispatch of the quantized
# flagship: 8 layers x 6 products, and the head (one row at prefill)
QSERVE_B5 = 6 * LAYERS + 1


def _qflagship(torch):
    """The serve configuration's flagship, `quantize`d (the f32 copy freed)."""
    from deeplearning4j_tpu_torch.quant import quantize

    model = _flagship(torch)
    q = quantize(model)
    del model
    torch.cuda.empty_cache()
    return q


def _requantized(torch, qmodel, factor=1.001):
    """A quantized tree of the same structure, every scale and float leaf
    times ``factor``: a push that must install."""
    from deeplearning4j_tpu_torch.quant import QuantizedTensor

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, QuantizedTensor):
            return QuantizedTensor(t.q.clone(), t.scale * factor)
        return t.detach() * factor
    with torch.no_grad():
        return walk(qmodel.params)


def _nan_scale(torch, qmodel):
    from deeplearning4j_tpu_torch.quant import QuantizedTensor

    tree = _requantized(torch, qmodel, 1.0)
    w = tree["layer2"]["W1"]
    scale = w.scale.clone()
    scale[0] = float("nan")
    tree["layer2"]["W1"] = QuantizedTensor(w.q, scale)
    return tree


def _swap_reason(staged, live):
    from deeplearning4j_tpu_torch.serving.hotswap import SwapVerifyError, verify_weights

    try:
        verify_weights(staged, live)
    except SwapVerifyError as exc:
        return exc.reason
    return None


def phase_qserve(torch, np, kernels, report, timer):
    """Int8 serving on the card (ROADMAP A7): the quantized flagship in the
    engine, dense `generate`, speculation, the server and the fleet; see
    the module docstring."""
    from deeplearning4j_tpu_torch.observe import registry
    from deeplearning4j_tpu_torch.ops.generation import generate
    from deeplearning4j_tpu_torch.quant import quantized_bytes
    from deeplearning4j_tpu_torch.runtime import faults
    from deeplearning4j_tpu_torch.serving.fleet import ServingFleet
    from deeplearning4j_tpu_torch.serving.generation import (
        GenerationConfig,
        GenerationEngine,
    )
    from deeplearning4j_tpu_torch.serving.http import ServingHTTPServer
    from deeplearning4j_tpu_torch.serving.server import InferenceServer, ServingConfig
    from deeplearning4j_tpu_torch.train.checkpoint import ModelSerializer

    os.environ["DL4JTPU_CRASH_DIR"] = os.path.abspath(os.path.join("build", "crash"))
    res = {}
    # B1 f32 at the long prompt's prefill shape, beside the bf16 row
    rows = [flash_case(torch, timer, SERVE_LENGTHS[0], torch.float32, bh=HEADS)]
    check_rows("qserve", rows)
    res["kernel_rows"] = rows

    t0 = time.perf_counter()
    qmodel = _qflagship(torch)
    qb = quantized_bytes(qmodel.params)
    f32_bytes = qb["tree_bytes"] - qb["quantized_bytes"] + qb["f32_equiv_bytes"]
    res["tree_bytes"] = {"quantized": qb["tree_bytes"], "f32": f32_bytes}
    log(f"[qserve] quantized flagship (chunked head, seed 123) built in "
        f"{time.perf_counter() - t0:.1f}s: tree {qb['tree_bytes']} bytes against "
        f"{f32_bytes} in f32 ({qb['tree_bytes'] / f32_bytes:.4f}); compute "
        f"{qmodel.compute_dtype}")
    if qmodel.compute_dtype != torch.float32:
        raise AssertionError("the quantized model does not compute in f32")

    # -- 1-2. the engine on the serve mix; exact launch counts --------------
    eng = GenerationEngine(qmodel, GenerationConfig(**ENGINE)).start()
    try:
        _, _, cold = _serve_pass(torch, np, eng, seed=2)
        _log_pass("qserve first pass (new shapes, the capture)", cold)
        kernels.reset_launches()
        prompts, outs, one = _serve_pass(torch, np, eng, seed=4)
        counts = kernels.launches()
        _log_pass("qserve measured pass", one)
        more = [_serve_pass(torch, np, eng, seed=4)[2] for _ in range(2)]
        _log_medians("qserve", [one] + more, one)
        prof = _profiled(torch, "qserve", lambda: _serve_pass(torch, np, eng, seed=4)[2])
        if eng.kv.leak_check() is not None:
            raise AssertionError(eng.kv.leak_check())
    finally:
        eng.stop()
    steps, prefills = one["decode_steps"], one["prefills"]
    want = {"dequant_matmul": QSERVE_B5 * (steps + prefills),
            "flash_fwd": LAYERS * prefills,
            "paged_attention_fwd": LAYERS * steps}
    log(f"[qserve] launches in the measured pass: {counts} (want {want}, "
        f"{steps} steps, {prefills} prefills)")
    if steps != 31 or prefills != len(SERVE_LENGTHS) or \
            {k: counts.get(k, 0) for k in want} != want or \
            set(counts) - set(want):
        raise AssertionError(f"qserve launches {counts}, want exactly {want}")
    step_ms = one["decode_seconds"] / steps * 1e3
    serve = report.get("serve")
    res["engine"] = {**one, "launches": counts, "decode_ms_per_step": step_ms,
                     "first_pass": cold, "profile": prof}
    log(f"[qserve] int8 engine: median {one['median_tokens_per_s']:.1f} tokens/s, "
        f"mean TTFT {one['mean_ttft_s'] * 1e3:.2f} ms, 2000-token prompt TTFT "
        f"{one['long_prompt_ttft_s'] * 1e3:.2f} ms, decode {step_ms:.4f} ms a step; "
        f"B5 device time in the profiled pass {prof['dequant_matmul_device_ms']:.3f} ms "
        f"in {prof['dequant_matmul_launches']} launches, of {prof['device_busy_s'] * 1e3:.3f} "
        f"ms busy")
    if serve is not None:
        log(f"[qserve] bf16 serve engine, same call: median "
            f"{serve['median_tokens_per_s']:.1f} tokens/s, mean TTFT "
            f"{serve['mean_ttft_s'] * 1e3:.2f} ms, 2000-token prompt TTFT "
            f"{serve['long_prompt_ttft_s'] * 1e3:.2f} ms, decode "
            f"{serve['decode_seconds'] / serve['decode_steps'] * 1e3:.4f} ms a step")
        res["bf16_serve"] = {k: serve[k] for k in (
            "median_tokens_per_s", "mean_ttft_s", "long_prompt_ttft_s",
            "decode_seconds", "decode_steps")}
    else:
        log("[qserve] bf16 serve engine: the serve phase did not run in this call")

    # -- 3. tokens against dense generate; int8 pages; the captured step ----
    pprompts = _prompts(np, 3, PARITY_LENGTHS)
    refs = [generate(qmodel, p[None], 32)[0].cpu().numpy() for p in pprompts]
    for kv in ("f32", "int8"):
        e = GenerationEngine(qmodel, GenerationConfig(**ENGINE, kv_dtype=kv)).start()
        try:
            got = _parity_streams(e, pprompts, 32)
        finally:
            e.stop()
        agree, first_ok = _agreement(np, pprompts, got, refs)
        gate = 0.95 if kv == "f32" else 0.9
        res[f"parity_{kv}"] = {"agreement": agree, "first_token_identical": first_ok,
                               "gate": gate}
        log(f"[qserve] {kv} pages: greedy agreement with dense generate over the "
            f"quantized model {agree:.4f} (gate {gate}), first tokens identical "
            f"{first_ok}")
        if agree < gate or not first_ok:
            raise AssertionError(f"quantized engine ({kv} pages) disagrees with dense "
                                 "generate")
    res["graph_check"] = graph_check(torch, np, qmodel, kernels,
                                     extra={"dequant_matmul": QSERVE_B5}, tag="qserve")

    # -- 4. speculation: the verify at C = k + 1 through B5 and B4 ----------
    sprompts = _prompts(np, 4, SERVE_LENGTHS)
    plain = GenerationEngine(qmodel, GenerationConfig(**ENGINE, spec_k=0)).start()
    spec = GenerationEngine(qmodel, GenerationConfig(**ENGINE, spec_k=SPEC_K)).start()
    try:
        srefs, _ = _spec_pass(torch, plain, sprompts)
        _spec_pass(torch, spec, sprompts)                  # meet every shape
        kernels.reset_launches()
        souts, sone = _spec_pass(torch, spec, sprompts)
        scounts = kernels.launches()
    finally:
        plain.stop()
        spec.stop()
    agree, first_ok = _agreement(np, sprompts, souts, srefs)
    same = sum(bool(np.array_equal(o, r)) for o, r in zip(souts, srefs))
    dispatches = sone["verify_dispatches"] + sone["plain_dispatches"]
    swant = {"dequant_matmul": QSERVE_B5 * (dispatches + sone["prefills"]),
             "paged_attention_chunk": LAYERS * sone["verify_dispatches"],
             "paged_attention_fwd": LAYERS * sone["plain_dispatches"],
             "flash_fwd": LAYERS * sone["prefills"]}
    res["spec"] = {"agreement": agree, "first_token_identical": first_ok,
                   "byte_identical_streams": same, "launches": scounts, **sone}
    log(f"[qserve] spec_k {SPEC_K}: agreement with the plain quantized engine "
        f"{agree:.4f} (gate {SPEC_GATE}), first tokens identical {first_ok}, "
        f"byte-identical streams {same} of {len(sprompts)}; drafted {sone['drafted']}, "
        f"accepted {sone['accepted']}, {sone['verify_dispatches']} verify and "
        f"{sone['plain_dispatches']} plain dispatches; launches {scounts} (want {swant})")
    if agree < SPEC_GATE or not first_ok or sone["verify_dispatches"] <= 0:
        raise AssertionError("quantized spec engine fails the parity rule")
    if {k: scounts.get(k, 0) for k in swant} != swant or set(scounts) - set(swant):
        raise AssertionError(f"quantized spec launches {scounts}, want {swant}")

    # -- 5. the server and its HTTP front -----------------------------------
    srv = InferenceServer(qmodel, ServingConfig(
        max_batch=INFER_BATCH, max_queue=64, linger_s=0.002,
        default_deadline_s=120.0)).start()
    eng = GenerationEngine(server=srv, config=GenerationConfig(**ENGINE)).start()
    http = ServingHTTPServer(srv, port=0, host="127.0.0.1").start()
    url = http.url
    try:
        if srv.health().get("quantized") is not True or not srv.stats()["quantized"]:
            raise AssertionError("the server does not advertise its int8 model")
        _serve_pass(torch, np, eng, seed=2)                # shapes, the capture
        ref = _queued_pass(eng, lambda: _submit_mix(eng, sprompts), len(sprompts))
        got = _queued_pass(eng, lambda: _http_mix(url, sprompts), len(sprompts))
        same = [g == r for g, r in zip(got, ref)]
        log(f"[qserve] /v1/generate streams equal to in-process generate: {same}")
        if not all(same):
            raise AssertionError("a /v1/generate stream differs from in-process generate")
        rng = np.random.default_rng(7)
        rows_in = rng.integers(0, VOCAB, (INFER_BATCH, INFER_SEQ)).astype(np.int64)
        srv.warm_start(rows_in[0])
        b0 = srv.stats()["batches"]
        kernels.reset_launches()
        http_out = _parallel([
            lambda r=r: _http(url, "/v1/infer", {"features": r.tolist()})
            for r in rows_in])
        icounts = kernels.launches()
        batches = srv.stats()["batches"] - b0
        if any(code != 200 for code, _ in http_out):
            raise AssertionError(f"/v1/infer: {[c for c, _ in http_out]}")
        outs_h = [np.asarray(json.loads(raw)["outputs"], np.float32) for _, raw in http_out]
        # each row as the batch it dispatched in computes it (rows do not mix)
        want_rows = qmodel.output(rows_in).cpu().numpy()
        ierr = max(float(np.abs(o - w).max()) for o, w in zip(outs_h, want_rows))
        iwant = {"flash_fwd": LAYERS * batches, "dequant_matmul": 6 * LAYERS * batches}
        log(f"[qserve] /v1/infer: {INFER_BATCH} requests in {batches} batch(es), "
            f"launches {icounts} (want {iwant}), max |http - output()| {ierr:.3e}")
        if {k: icounts.get(k, 0) for k in iwant} != iwant or \
                ierr > TOL["dequant_matmul/K4096"] * float(np.abs(want_rows).max()):
            raise AssertionError("/v1/infer over the int8 model: launches or rows off")
        probe = rows_in[:1]
        before = qmodel.output(probe).cpu()
        nan_reason = _swap_reason(_nan_scale(torch, qmodel), qmodel.params)
        f32_tree = _flagship(torch).params
        f32_reason = _swap_reason(f32_tree, qmodel.params)
        nan_ok = srv.push_weights(_nan_scale(torch, qmodel), source="qserve-nan")
        f32_ok = srv.push_weights(f32_tree, source="qserve-f32")
        del f32_tree
        unchanged = bool(torch.equal(before, qmodel.output(probe).cpu()))
        rejected = {"nan_scale": [nan_ok, nan_reason], "f32_tree": [f32_ok, f32_reason],
                    "output_unchanged": unchanged, "generation": srv.generation}
        log(f"[qserve] bad pushes: {rejected}")
        if nan_ok or f32_ok or nan_reason != "nonfinite" or f32_reason != "structure" \
                or not unchanged or srv.generation != 0:
            raise AssertionError(f"a bad push onto the int8 model: {rejected}")
        cap0, recap0 = eng.stats()["graph_captures"], eng.stats()["graph_recaptures"]
        if not srv.push_weights(_requantized(torch, qmodel), source="qserve"):
            raise AssertionError("the quantized push rolled back")
        _serve_pass(torch, np, eng, seed=5)
        st = eng.stats()
        swap = {"generation": srv.generation, "captures": st["graph_captures"] - cap0,
                "recaptures": st["graph_recaptures"] - recap0,
                "output_changed": not torch.equal(before, qmodel.output(probe).cpu())}
        log(f"[qserve] hot-swap of a quantized tree: {swap}")
        if swap != {"generation": 1, "captures": 1, "recaptures": 1,
                    "output_changed": True}:
            raise AssertionError(f"quantized hot-swap: {swap}")
        os.makedirs(CKPT_DIR, exist_ok=True)
        zpath = os.path.abspath(os.path.join(CKPT_DIR, "qserve.zip"))
        t0 = time.perf_counter()
        ModelSerializer.write_model(qmodel, zpath)
        write_s = time.perf_counter() - t0
        pre = qmodel.output(probe).cpu()
        t0 = time.perf_counter()
        code, body = _http(url, "/v1/reload", {"path": zpath})
        reload_s = time.perf_counter() - t0
        # the zip holds the live weights: the same outputs after the install
        reload = {"status": code, "generation": srv.generation, "write_s": write_s,
                  "reload_s": reload_s, "zip_bytes": os.path.getsize(zpath),
                  "output_identical": bool(torch.equal(pre, qmodel.output(probe).cpu()))}
        log(f"[qserve] /v1/reload of the quantized zip: {reload}")
        if code != 200 or srv.generation != 2 or not reload["output_identical"]:
            raise AssertionError(f"/v1/reload of a quantized zip: {code} {body[:200]!r}")
        res["server"] = {"generate_equal": same, "infer_launches": icounts,
                         "infer_batches": batches, "infer_max_abs_err": ierr,
                         "rejected": rejected, "hotswap": swap, "reload": reload}
        if eng.kv.leak_check() is not None:
            raise AssertionError(eng.kv.leak_check())
    finally:
        http.stop()
        eng.stop()
        srv.stop()
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    del qmodel, srv, eng
    torch.cuda.empty_cache()

    # -- 6. the fleet: two quantized `both` replicas, deploy and rollback ----
    reg = registry()
    rng = np.random.default_rng(8)
    goldens = list(rng.integers(0, VOCAB, (2, INFER_SEQ)).astype(np.int64))
    fleet = ServingFleet(
        lambda: _qflagship(torch), n_replicas=2,
        config=ServingConfig(max_batch=INFER_BATCH, max_queue=64, linger_s=0.002,
                             default_deadline_s=120.0),
        golden_inputs=goldens)
    try:
        fleet.warm_start(goldens[0])
        fleet.start()
        if not all(s.quantized for s in fleet.replicas):
            raise AssertionError("a fleet replica does not advertise its int8 model")
        x = goldens[1]
        gens0 = [s.generation for s in fleet.replicas]
        t0 = time.perf_counter()
        dep = fleet.deployer.deploy(_requantized(torch, fleet.replicas[0].model),
                                    source="qserve")
        dep_s = time.perf_counter() - t0
        gens1 = [s.generation for s in fleet.replicas]
        before = [s.infer(x, deadline_s=600) for s in fleet.replicas]
        canary0 = reg.counter("dl4jtpu_canary_failures_total").value()
        faults.arm("serving.canary:corrupt:nth=1")
        try:
            bad = fleet.deployer.deploy(_requantized(torch, fleet.replicas[0].model, 1.01))
        finally:
            faults.disarm()
        after = [s.infer(x, deadline_s=600) for s in fleet.replicas]
        canary = reg.counter("dl4jtpu_canary_failures_total").value() - canary0
        unchanged = all(np.array_equal(a, b) for a, b in zip(before, after))
        log(f"[qserve] fleet deploy of a quantized tree: {dep} in {dep_s:.3f}s, "
            f"generations {gens0} -> {gens1}; corrupted canary: {bad}, canary "
            f"failures +{canary}, outputs bit-identical to before: {unchanged}")
        if not dep["installed"] or dep["replicas_updated"] != 2 or \
                gens1 != [g + 1 for g in gens0]:
            raise AssertionError(f"quantized fleet deploy: {dep}, {gens1}")
        if bad["installed"] or bad["rolled_back"] != 1 or canary != 1 or not unchanged:
            raise AssertionError(f"quantized canary rollback: {bad}, {unchanged}")
        res["fleet"] = {"deploy": dep, "deploy_s": dep_s, "generations": [gens0, gens1],
                        "canary_rollback": bad, "canary_failures": canary}
    finally:
        faults.disarm()
        fleet.stop()
    del fleet
    torch.cuda.empty_cache()
    res["launches"] = counts
    return res


# -- ckpt phase -------------------------------------------------------------------

CKPT_STEPS = 3                             # steps before the save, and resumed after
# the flagship's depth in this phase: 1 of its 8 blocks, cut for the
# script's time limit (at 8 blocks the 1.66 GB zip's deflate alone took
# 95 s, at 2 its write 59.9 s); every other width is the flagship's
CKPT_LAYERS = 1
CKPT_DIR = os.path.join("build", "ckpt")   # inside the checkout; removed after


def _steps(model, batch, n):
    out = []
    for _ in range(n):
        model.fit_batch(batch)
        out.append(model.score_value)             # synchronises
    return out


def _snapshot(torch, model):
    """Copies of the model's parameters, optimizer state and step."""
    from deeplearning4j_tpu_torch.models.sequential import tree_leaves
    from deeplearning4j_tpu_torch.nn.updaters import state_leaves

    return ([p.detach().clone() for p in tree_leaves(model.params)],
            [x.clone() if isinstance(x, torch.Tensor) else x
             for x in state_leaves(model.opt_state)], model.iteration)


def _load_snapshot(torch, model, snap):
    from deeplearning4j_tpu_torch.models.sequential import tree_leaves
    from deeplearning4j_tpu_torch.nn.updaters import load_state_leaves

    params, opt, it = snap
    with torch.no_grad():
        for p, s in zip(tree_leaves(model.params), params):
            p.copy_(s)
    model.opt_state = load_state_leaves(model.opt_state, opt)
    model.iteration = it
    model._compute = None


def _state_diffs(torch, a, b) -> list:
    """Where two models' parameters, optimizer states and counters
    differ in any bit."""
    from deeplearning4j_tpu_torch.models.sequential import tree_leaves
    from deeplearning4j_tpu_torch.nn.updaters import state_leaves

    bad = []
    for name, x, y in (("params", tree_leaves(a.params), tree_leaves(b.params)),
                       ("updater", state_leaves(a.opt_state or ()),
                        state_leaves(b.opt_state or ()))):
        if len(x) != len(y):
            bad.append(f"{name}: {len(x)} leaves against {len(y)}")
            continue
        for i, (u, v) in enumerate(zip(x, y)):
            same = (torch.equal(u, v) if isinstance(u, torch.Tensor)
                    else int(u) == int(v))
            if not same:
                bad.append(f"{name} leaf {i}")
    for k in ("iteration", "epoch"):
        if getattr(a, k) != getattr(b, k):
            bad.append(f"{k} {getattr(a, k)} != {getattr(b, k)}")
    return bad


def _zip_times(torch, model, path):
    """write_model, verify, restore: their seconds and the zip's bytes."""
    from deeplearning4j_tpu_torch.train.checkpoint import ModelSerializer

    t0 = time.perf_counter()
    ModelSerializer.write_model(model, path)
    t1 = time.perf_counter()
    meta = ModelSerializer.verify(path)
    t2 = time.perf_counter()
    restored = ModelSerializer.restore(path)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    res = {"bytes": os.path.getsize(path), "write_s": t1 - t0,
           "verify_s": t2 - t1, "restore_s": t3 - t2, "meta": meta}
    if restored.device != model.device:      # restore's default is the card
        raise AssertionError(f"restore built the model on {restored.device}")
    return restored, res


def phase_ckpt(torch, np, kernels):
    """The checkpoint zip on the card: train, save, verify, restore; the
    restored model's state, output and greedy streams against the live
    model's, bit for bit; 3 resumed steps against the live model's within
    the spread of two runs of the live model from one state; then the
    quantized model saved and restored (int8 and scale leaves and its
    ``output()`` bit for bit)."""
    from deeplearning4j_tpu_torch.quant import quantize
    from deeplearning4j_tpu_torch.serving.generation import (
        GenerationConfig,
        GenerationEngine,
    )

    smi = nvidia_smi()
    os.makedirs(CKPT_DIR, exist_ok=True)
    res = {"card": smi, "steps": CKPT_STEPS, "layers": CKPT_LAYERS}
    try:
        # the softmax head (the JAX zoo's default, as in the quant phase):
        # its quantized output() runs the head's product through B5 too
        model = _flagship(torch, chunked=False, layers=CKPT_LAYERS)
        batch = _train_batch(np)
        res["losses_before_save"] = _steps(model, batch, CKPT_STEPS)
        restored, res["trained_zip"] = _zip_times(
            torch, model, os.path.join(CKPT_DIR, "trained.zip"))
        bad = _state_diffs(torch, model, restored)
        ids = batch.features[:QUANT_BATCH]
        same_out = torch.equal(model.output(ids), restored.output(ids))
        log(f"[ckpt] trained zip: {res['trained_zip']}; restored state "
            f"differs at {bad or 'no leaf'}; output() bit-identical: {same_out}")
        if bad or not same_out:
            raise AssertionError(f"the restored model is not the saved one: {bad}, "
                                 f"output identical {same_out}")

        prompts = _prompts(np, 3, PARITY_LENGTHS)

        def serve(m):
            eng = GenerationEngine(m, GenerationConfig(**ENGINE)).start()
            try:
                return _parity_streams(eng, prompts, 32)
            finally:
                eng.stop()

        live_tokens = serve(model)
        kernels.reset_launches()
        rest_tokens = serve(restored)
        res["serve_launches"] = kernels.launches()
        same_tokens = all(np.array_equal(np.asarray(a), np.asarray(b))
                          for a, b in zip(live_tokens, rest_tokens))
        _check_streams(np, prompts, rest_tokens, 32)
        log(f"[ckpt] restored engine, {len(prompts)} greedy streams: tokens "
            f"identical to the live model's: {same_tokens}; launches "
            f"{res['serve_launches']}")
        if not same_tokens or min(res["serve_launches"].get(k, 0) for k in (
                "flash_fwd", "paged_attention_fwd")) <= 0:
            raise AssertionError("the restored engine's streams differ, or it "
                                 "skipped a kernel")

        snap = _snapshot(torch, model)
        live = _steps(model, batch, CKPT_STEPS)
        _load_snapshot(torch, model, snap)
        again = _steps(model, batch, CKPT_STEPS)
        del snap
        kernels.reset_launches()
        resumed = _steps(restored, batch, CKPT_STEPS)
        counts = kernels.launches()
        spread = max(abs(a - b) for a, b in zip(live, again))
        dev = max(abs(a - b) for a, b in zip(live, resumed))
        res.update(live_losses=live, live_again_losses=again,
                   resumed_losses=resumed, spread=spread, deviation=dev,
                   resume_launches=counts)
        log(f"[ckpt] resumed {CKPT_STEPS} steps: live {live}, live again "
            f"{again} (spread {spread}), restored {resumed} (deviation "
            f"{dev}); launches {counts}")
        if dev > spread:
            raise AssertionError("the resumed run left the live model's spread")
        want = CKPT_LAYERS * CKPT_STEPS
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv"):
            if counts.get(name, 0) != want:
                raise AssertionError(f"{name} launched {counts.get(name, 0)} "
                                     f"times in the resumed steps, want {want}")
        del restored

        qmodel = quantize(model)
        del model
        torch.cuda.empty_cache()
        rq, res["quantized_zip"] = _zip_times(
            torch, qmodel, os.path.join(CKPT_DIR, "quantized.zip"))
        bad = _state_diffs(torch, qmodel, rq)
        qids = np.random.default_rng(3).integers(
            0, VOCAB, (QUANT_BATCH, QUANT_SEQ)).astype(np.int64)
        p_live = qmodel.output(qids)
        torch.cuda.synchronize()
        kernels.reset_launches()
        p_rest = rq.output(qids)
        torch.cuda.synchronize()
        counts = kernels.launches()
        same_p = torch.equal(p_live, p_rest)
        res["quantized_launches"] = counts
        want = {"dequant_matmul": 6 * CKPT_LAYERS + 1, "flash_fwd": CKPT_LAYERS}
        log(f"[ckpt] quantized zip: {res['quantized_zip']}; restored leaves "
            f"differ at {bad or 'no leaf'}; output() of {QUANT_BATCH}x{QUANT_SEQ} "
            f"ids bit-identical: {same_p}; launches {counts} (want {want})")
        if bad or not same_p or {k: counts.get(k, 0) for k in want} != want:
            raise AssertionError("the restored quantized model is not the saved one")
        del qmodel, rq, p_live, p_rest
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
        torch.cuda.empty_cache()
    for name in ("trained_zip", "quantized_zip"):
        z = res[name]
        log(f"[ckpt] {name}: {z['bytes']} bytes; write_model {z['write_s']:.2f}s, "
            f"verify {z['verify_s']:.2f}s, restore {z['restore_s']:.2f}s ({smi})")
    return res


# -- attn phase ---------------------------------------------------------------------

# the MoE flagship: the train phase's flagship with the zoo's MoE knob
MOE_EXPERTS, MOE_TOP_K = 8, 2
# untimed steps after the measured ones, at most, for the loss to fall
# below the first (`_attn_moe`)
MOE_SETTLE_STEPS = 40
# the masked classifier at BERT-base widths (BASELINE config 4: SST-2
# fine-tuning), padded to run_classifier.py's max_seq_length 128 for GLUE,
# with its train batch 32 and learning rate 5e-5; row lengths 8-64 drawn
# from the seed
CLS_VOCAB, CLS_D, CLS_HEADS, CLS_LAYERS, CLS_FF, CLS_MAXLEN = 30522, 768, 12, 12, 3072, 512
CLS_BATCH, CLS_SEQ, CLS_LENGTHS = 32, 128, (8, 64)
CLS_WARMUP, CLS_STEPS, CLS_HELD_OUT, CLS_LR = 2, 20, 1024, 5e-5
# B5's shapes in the quantized classifier's output(): each block's four
# attention products and its two FFN products, and the head
CLS_DM_SHAPES = [(CLS_BATCH * CLS_SEQ, CLS_D, CLS_D), (CLS_BATCH * CLS_SEQ, CLS_D, CLS_FF),
                 (CLS_BATCH * CLS_SEQ, CLS_FF, CLS_D), (CLS_BATCH, CLS_D, 2)]
# rows of the f32 twin run alone at their own length (the B1 route)
CLS_ALONE_ROWS = 4
# the server's /v1/infer requests: rows of one padded batch, one with a hole
ATTN_SERVER_ROWS = 12


def _moe_flops_by_hand(model) -> float:
    """FLOPs of one MoE flagship training step: the flagship's
    (`_train_flops_by_hand`) plus, a MoE layer, the router (2 N D E
    forward, 4 N D E backward) and the experts' two batched f32 products
    over every capacity slot (2 E C D H forward each, 4 E C D H
    backward); the dispatch and combine are gathers (no FLOPs)."""
    from deeplearning4j_tpu_torch.parallel.expert import capacity

    n = TRAIN_BATCH * TRAIN_SEQ
    extra = 0
    for layer in model.conf.layers:
        if type(layer).__name__ == "MoELayer":
            cfg = layer._cfg()
            c = capacity(cfg, n)
            extra += 6 * n * cfg.d_model * cfg.n_experts
            extra += 2 * 6 * cfg.n_experts * c * cfg.d_model * cfg.d_hidden
    return _train_flops_by_hand() + extra


def _moe_drop_share(torch, model, ids):
    """The share of (token, choice) pairs each MoE layer drops for want of
    capacity on ``ids``: its input from `feed_forward`, routed again."""
    from deeplearning4j_tpu_torch.parallel.expert import dropped_share

    acts = model.feed_forward(ids)
    out = []
    for i, layer in enumerate(model.conf.layers):
        if type(layer).__name__ == "MoELayer":
            out.append(dropped_share(model.params[layer.name], acts[i - 1], layer._cfg()))
    del acts
    return out


def _device_time_by_kind(prof) -> dict:
    """A profiled run's device ms by kind of kernel: the flash kernels,
    f32 GEMMs (CUTLASS's SIMT sgemm, cuBLAS's f32 xmma), bf16 GEMMs
    (cuBLAS's nvjet and bf16 xmma kernels), everything else."""
    out = {"flash": 0.0, "gemm_f32": 0.0, "gemm_bf16": 0.0, "other": 0.0}
    for k, ms, _ in prof["all_device_kernels_ms"]:
        name = k.lower()
        if "flash" in name:
            out["flash"] += ms
        elif "sgemm" in name or "f32f32_f32f32" in name:
            out["gemm_f32"] += ms
        elif "gemm" in name or "nvjet" in name:
            out["gemm_bf16"] += ms
        else:
            out["other"] += ms
    return out


def _attn_moe(torch, np, kernels, timer):
    """(a) The MoE flagship trained on the card."""
    from deeplearning4j_tpu_torch.models._common import AUX_LOSS_KEY
    from deeplearning4j_tpu_torch.zoo.transformer import TransformerEncoder

    t0 = time.perf_counter()
    model = TransformerEncoder(
        vocab_size=VOCAB, d_model=D_MODEL, n_heads=HEADS, n_layers=LAYERS,
        causal=True, chunked_vocab_loss=True, vocab_chunk=8192, seed=123,
        moe_experts=MOE_EXPERTS, moe_top_k=MOE_TOP_K).init_model(device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[attn] MoE flagship: {n_params} params (f32 masters; the experts stay "
        f"f32 in compute), {MOE_EXPERTS} experts top-{MOE_TOP_K} after each of "
        f"{LAYERS} blocks, built in {time.perf_counter() - t0:.1f}s")
    batch = _train_batch(np)
    losses = []
    mem0 = _memory_window(torch)
    for i in range(TRAIN_WARMUP):
        t1 = time.perf_counter()
        model.fit_batch(batch)
        losses.append(model.score_value)
        log(f"[attn] MoE warm-up step {i}: loss {losses[-1]:.5f}, "
            f"{(time.perf_counter() - t1) * 1e3:.1f} ms")
    torch.cuda.synchronize()
    kernels.reset_launches()
    step_ms = []
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        t1 = time.perf_counter()
        model.fit_batch(batch)
        losses.append(model.score_value)
        step_ms.append((time.perf_counter() - t1) * 1e3)
    wall = time.perf_counter() - t0
    counts = kernels.launches()
    graphs = model.compile_stats()["step_programs"]
    memory = {"captured": _memory_window(torch, mem0)}
    tokens = TRAIN_STEPS * TRAIN_BATCH * TRAIN_SEQ
    res = {"params": n_params, "losses": losses, "step_ms": step_ms,
           "median_step_ms": statistics.median(step_ms), "wall_s": wall,
           "tokens_per_s": tokens / wall, "launches": counts, "step_graphs": graphs,
           "peak_memory_gib": memory["captured"]["peak_gib"], "memory": memory}
    log(f"[attn] MoE: {TRAIN_STEPS} steps of {TRAIN_BATCH}x{TRAIN_SEQ} tokens in "
        f"{wall:.3f}s = {res['tokens_per_s']:.1f} tokens/s; median step "
        f"{res['median_step_ms']:.1f} ms ({['%.1f' % t for t in step_ms]}); losses "
        f"{['%.5f' % x for x in losses]}; launches {counts}; {graphs} step graph(s); "
        f"memory (GiB) {_memory_text(memory)}")
    # the JAX package's MoE stack at this init grows its residual stream
    # about 1.5-2x a MoE layer, and Adam's first steps on one batch can
    # raise its loss before they lower it (its CPU run at d 256 does):
    # steps go on, untimed, until the loss falls below the first
    settle = 0
    while not losses[-1] < losses[0] and settle < MOE_SETTLE_STEPS:
        model.fit_batch(batch)
        losses.append(model.score_value)
        settle += 1
    res["settle_steps"] = settle
    log(f"[attn] MoE: {settle} more step(s) until the loss fell below the first: "
        f"{['%.5f' % x for x in losses[TRAIN_WARMUP + TRAIN_STEPS:]]}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"MoE loss not finite or not falling: {losses}")
    if graphs != 1:
        raise AssertionError(f"MoE: {graphs} step graphs for one batch signature")
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv"):
        if counts.get(name, 0) != LAYERS * TRAIN_STEPS:
            raise AssertionError(f"MoE: {name} launched {counts.get(name, 0)} times in "
                                 f"{TRAIN_STEPS} steps, want {LAYERS * TRAIN_STEPS}")
    res["cost"] = _step_cost(torch, model, res["median_step_ms"],
                             hand=_moe_flops_by_hand(model), tag="attn")
    res["captured_vs_eager"] = _captured_vs_eager(
        torch, model, [batch] * CAPTURE_CMP_STEPS, "MoE flagship", phase="attn",
        host=True)

    # one eager step's loss against its parts, computed from the same state
    feats = torch.from_numpy(batch.features).cuda()
    labels = torch.from_numpy(batch.labels).cuda()
    with torch.no_grad():
        data, reg, aux, state = model._step_loss_parts(
            model.params, model.net_state, feats, labels,
            keys=model._layer_keys(model.iteration))
        parts = [float(data), float(reg), float(aux)]
    model.capture_steps = False
    try:
        model.fit_batch(batch)
        loss = model.score_value
        # one profiled eager step: where the time goes
        prof = _profiled(torch, "moe", lambda: model.fit_batch(batch))
    finally:
        model.capture_steps = True
    whole = float(data + reg + aux)
    res["loss_parts"] = {"loss": loss, "data": parts[0], "reg": parts[1],
                         "aux": parts[2], "sum": whole}
    res["profile"] = prof
    res["device_ms_by_kind"] = _device_time_by_kind(prof)
    log(f"[attn] MoE eager step: loss {loss:.7f} = data {parts[0]:.7f} + reg "
        f"{parts[1]:.7f} + aux {parts[2]:.7f} (sum {whole:.7f}); state after "
        f"{sorted(state)}, net_state {sorted(model.net_state)}; profiled eager step "
        f"device ms by kind {res['device_ms_by_kind']}")
    if abs(loss - whole) > 1e-6 * abs(loss) or not parts[2] > 0:
        raise AssertionError("the MoE step's loss is not data + reg + aux")
    if state or any(AUX_LOSS_KEY in s for s in model.net_state.values()):
        raise AssertionError("an aux entry reached the layer state")

    ids = batch.features[:QUANT_BATCH]
    torch.cuda.synchronize()
    kernels.reset_launches()
    out = model.output(ids)
    torch.cuda.synchronize()
    res["output"] = {"launches": kernels.launches()}
    log(f"[attn] MoE output() of {list(ids.shape)} ids: {tuple(out.shape)}, launches "
        f"{res['output']['launches']}")
    if res["output"]["launches"].get("flash_fwd", 0) != LAYERS or \
            not bool(torch.isfinite(out).all()):
        raise AssertionError("MoE output(): B1 launches or values off")
    # B1 at the shape that output() gave it, against its plain version
    res["kernel_rows"] = [flash_case(torch, timer, TRAIN_SEQ, torch.bfloat16,
                                     bh=QUANT_BATCH * HEADS)]
    res["dropped_share"] = _moe_drop_share(torch, model, batch.features)
    log(f"[attn] MoE choices dropped for want of capacity, by layer: "
        f"{['%.5f' % s for s in res['dropped_share']]} (mean "
        f"{statistics.mean(res['dropped_share']):.5f})")
    del model, out
    torch.cuda.empty_cache()
    return res


def _cls_conf(bf16=None):
    from deeplearning4j_tpu_torch.nn.activations import Activation
    from deeplearning4j_tpu_torch.nn.conf.attention import (
        PositionalEncoding,
        TransformerEncoderBlock,
    )
    from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers import (
        Embedding,
        GlobalPooling,
        OutputLayer,
    )
    from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.losses import Loss
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    from deeplearning4j_tpu_torch.nn.weights import WeightInit

    b = (NeuralNetConfiguration.builder().seed(123).updater(Adam(CLS_LR))
         .weight_init(WeightInit.XAVIER).bf16_compute(bf16).list()
         .layer(Embedding(n_in=CLS_VOCAB, n_out=CLS_D))
         .layer(PositionalEncoding(learned=True, max_length=CLS_MAXLEN)))
    for _ in range(CLS_LAYERS):
        b.layer(TransformerEncoderBlock(d_model=CLS_D, n_heads=CLS_HEADS, d_ff=CLS_FF,
                                        causal=False))
    return (b.layer(GlobalPooling(pooling="avg"))
            .layer(OutputLayer(n_out=2, loss=Loss.MCXENT, activation=Activation.SOFTMAX))
            .set_input_type(InputType.recurrent(1)).build())


def _cls_data(np, rows, seed, full=False):
    """``rows`` padded rows of procedural two-class 'sentences': a row's
    length is drawn in CLS_LENGTHS (CLS_SEQ with ``full``); about 30% of
    its tokens are its class's marker id, the rest drawn from the whole
    vocab; id 0 ([PAD]) after its end.  (ids int64, one-hot labels, mask
    f32.)"""
    r = np.random.default_rng(seed)
    lengths = (np.full(rows, CLS_SEQ) if full
               else r.integers(CLS_LENGTHS[0], CLS_LENGTHS[1] + 1, rows))
    mask = (np.arange(CLS_SEQ)[None] < lengths[:, None]).astype(np.float32)
    cls = r.integers(0, 2, rows)
    noise = r.integers(1000, CLS_VOCAB, (rows, CLS_SEQ))
    marker = np.broadcast_to((1000 + 500 * cls)[:, None], noise.shape)
    ids = np.where(r.random((rows, CLS_SEQ)) < 0.3, marker, noise) * (mask > 0)
    return ids.astype(np.int64), np.eye(2, dtype=np.float32)[cls], mask


def _cls_batch(np, rows, seed):
    from deeplearning4j_tpu_torch.data.dataset import DataSet

    ids, labels, mask = _cls_data(np, rows, seed)
    return DataSet(ids, labels, features_mask=mask)


def _rewrite_padding(np, ids, mask, seed):
    r = np.random.default_rng(seed)
    return np.where(mask > 0, ids, r.integers(1, CLS_VOCAB, ids.shape)).astype(ids.dtype)


def _b5_sites(qmodel) -> int:
    """Products a quantized ``output()`` runs through B5: every int8 leaf
    but an embedding table's (gathered, not multiplied)."""
    from deeplearning4j_tpu_torch.nn.conf.layers import Embedding
    from deeplearning4j_tpu_torch.quant.qtensor import QuantizedTensor

    def count(tree):
        return sum(count(v) if isinstance(v, dict) else isinstance(v, QuantizedTensor)
                   for v in tree.values())

    return sum(count(qmodel.params.get(l.name, {})) for l in qmodel.conf.layers
               if not isinstance(l, Embedding))


def _attn_classifier(torch, np, kernels, timer):
    """(b) The masked encoder classifier at BERT-base widths."""
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.models.sequential import SequentialModel
    from deeplearning4j_tpu_torch.quant import dequantize_tree, quantize

    def masked_calls(m, ids, mask):
        torch.cuda.synchronize()
        kernels.reset_launches()
        out = m.output(ids, mask)
        torch.cuda.synchronize()
        return out, kernels.launches()

    model = SequentialModel(_cls_conf(), device="cuda").init()
    n_params = sum(p.numel() for p in model.parameters())
    batches = [_cls_batch(np, CLS_BATCH, 100 + i) for i in range(CLS_WARMUP + CLS_STEPS)]
    losses = []
    mem0 = _memory_window(torch)
    captures0 = model.compile_stats()["jit_cache_misses"]
    for b in batches[:CLS_WARMUP]:
        model.fit_batch(b)
        losses.append(model.score_value)
    torch.cuda.synchronize()
    kernels.reset_launches()
    step_ms = []
    t0 = time.perf_counter()
    for b in batches[CLS_WARMUP:]:
        t1 = time.perf_counter()
        model.fit_batch(b)
        losses.append(model.score_value)
        step_ms.append((time.perf_counter() - t1) * 1e3)
    wall = time.perf_counter() - t0
    counts = kernels.launches()
    captures = model.compile_stats()["jit_cache_misses"] - captures0
    graphs = model.compile_stats()["step_programs"]
    memory = {"captured": _memory_window(torch, mem0)}
    res = {"params": n_params, "losses": losses, "step_ms": step_ms,
           "median_step_ms": statistics.median(step_ms), "wall_s": wall,
           "samples_per_s": CLS_STEPS * CLS_BATCH / wall, "launches": counts,
           "captures": captures, "step_graphs": graphs, "memory": memory}
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    log(f"[attn] classifier ({n_params} params, bf16, batch {CLS_BATCH} x {CLS_SEQ}, "
        f"lengths {CLS_LENGTHS}): {CLS_STEPS} masked steps in {wall:.3f}s = "
        f"{res['samples_per_s']:.1f} samples/s, median {res['median_step_ms']:.2f} ms "
        f"a step; losses {['%.4f' % x for x in losses]} (first 5 mean {first:.4f}, "
        f"last 5 {last:.4f}); launches {counts}; {captures} capture(s), {graphs} "
        f"step graph(s) over {len(batches)} batches with different masks; memory "
        f"(GiB) {_memory_text(memory)}")
    if not all(np.isfinite(losses)) or not last < first:
        raise AssertionError(f"classifier loss not finite or not falling: {losses}")
    if any(counts.get(k, 0) for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv")):
        raise AssertionError(f"a masked step launched a flash kernel: {counts}")
    if captures != 1 or graphs != 1:
        raise AssertionError(f"{captures} captures, {graphs} graphs across batches "
                             "that differ only in their masks")
    res["captured_vs_eager"] = _captured_vs_eager(
        torch, model, batches[:CAPTURE_CMP_STEPS], "classifier", phase="attn")

    ids, labels, mask = _cls_data(np, CLS_BATCH, 7)
    ids2 = _rewrite_padding(np, ids, mask, 8)
    f32 = SequentialModel(_cls_conf(bf16=False), device="cuda").load_params(model.params)
    inv = {}
    for tag, m in (("bf16", model), ("f32", f32)):
        a, ca = masked_calls(m, ids, mask)
        b, cb = masked_calls(m, ids2, mask)
        inv[tag] = bool(torch.equal(a, b))
        if not inv[tag] or ca.get("flash_fwd", 0) or cb.get("flash_fwd", 0):
            raise AssertionError(f"{tag}: padded ids changed masked output(), or a "
                                 f"masked call launched B1 ({ca}, {cb})")
    p32 = f32.output(ids, mask)
    alone, alone_counts = [], []
    for r in range(CLS_ALONE_ROWS):
        n = int(mask[r].sum())
        torch.cuda.synchronize()
        kernels.reset_launches()
        p = f32.output(ids[r:r + 1, :n])
        torch.cuda.synchronize()
        alone_counts.append(kernels.launches().get("flash_fwd", 0))
        alone.append((p[0] - p32[r]).abs().max().item())
    lengths = [int(mask[r].sum()) for r in range(CLS_ALONE_ROWS)]
    res["padding_invariant"] = inv
    res["alone"] = {"max_abs_err": max(alone), "lengths": lengths,
                    "b1_launches": alone_counts,
                    "launches": {"flash_fwd": sum(alone_counts)}}
    log(f"[attn] padding invariance (every padded id rewritten), bit for bit: {inv}; "
        f"f32 rows alone at their own length {lengths} (B1 f32) against their padded "
        f"masked rows: max |dp| {['%.3e' % e for e in alone]} (tol "
        f"{TOL['flash_fwd/f32']}), B1 launches {alone_counts}")
    if max(alone) > TOL["flash_fwd/f32"] or any(c != CLS_LAYERS for c in alone_counts):
        raise AssertionError("an f32 row alone disagrees with its padded masked row")

    full = _cls_data(np, CLS_BATCH, 9, full=True)[0]
    torch.cuda.synchronize()
    kernels.reset_launches()
    pf = model.output(full)
    torch.cuda.synchronize()
    res["unmasked"] = {"launches": kernels.launches()}
    _, res["masked_launches"] = masked_calls(model, ids, mask)
    log(f"[attn] unmasked full-length output() of {list(full.shape)}: launches "
        f"{res['unmasked']['launches']}; masked: {res['masked_launches']}")
    if res["unmasked"]["launches"].get("flash_fwd", 0) != CLS_LAYERS or \
            res["masked_launches"].get("flash_fwd", 0) or not bool(torch.isfinite(pf).all()):
        raise AssertionError("B1 launches of the classifier's output() off")
    # B1 at the shapes these calls gave it, against its plain version:
    # bf16 unmasked, and f32 at each row's own length run alone
    res["kernel_rows"] = [flash_case(torch, timer, CLS_SEQ, torch.bfloat16, causal=False,
                                     bh=CLS_BATCH * CLS_HEADS, d=CLS_D // CLS_HEADS)]
    res["kernel_rows"] += [flash_case(torch, timer, n, torch.float32, causal=False,
                                      bh=CLS_HEADS, d=CLS_D // CLS_HEADS)
                           for n in sorted(set(lengths))]

    held = _cls_data(np, CLS_HELD_OUT, 11)
    t0 = time.perf_counter()
    ev = model.evaluate(DataSet(held[0], held[1], features_mask=held[2]),
                        batch_size=CLS_BATCH)
    res["accuracy"] = ev.accuracy()
    log(f"[attn] classifier accuracy on {CLS_HELD_OUT} held-out masked rows: "
        f"{res['accuracy']:.4f} ({time.perf_counter() - t0:.2f}s)")

    # int8: masked output() through B5 (each block's six products and the
    # head), against the f32 model of the dequantized weights
    q = quantize(model)
    sites = _b5_sites(q)
    twin = SequentialModel(_cls_conf(bf16=False), device="cuda").load_params(
        dequantize_tree(q.params))
    pq, pt, qcounts = [], [], {}
    calls = CLS_HELD_OUT // CLS_BATCH
    torch.cuda.synchronize()
    kernels.reset_launches()
    for i in range(calls):
        sl = slice(i * CLS_BATCH, (i + 1) * CLS_BATCH)
        pq.append(q.output(held[0][sl], held[2][sl]))
    torch.cuda.synchronize()
    qcounts = kernels.launches()
    for i in range(calls):
        sl = slice(i * CLS_BATCH, (i + 1) * CLS_BATCH)
        pt.append(twin.output(held[0][sl], held[2][sl]))
    pq, pt = torch.cat(pq), torch.cat(pt)
    agree = _argmax_agreement(pq, pt)
    res["quant"] = {"b5_sites": sites, "calls": calls, "launches": qcounts,
                    "agreement": agree, "max_abs_dp": (pq - pt).abs().max().item()}
    log(f"[attn] quantized masked output(): {calls} calls of {CLS_BATCH} rows, launches "
        f"{qcounts} (want {sites} B5 a call from the tree, no B1); argmax agreement "
        f"with the dequantized f32 twin {agree:.5f} (gate {QUANT_AGREEMENT}), max "
        f"|dp| {res['quant']['max_abs_dp']:.3e}")
    if qcounts.get("dequant_matmul", 0) != sites * calls or qcounts.get("flash_fwd", 0) \
            or agree < QUANT_AGREEMENT:
        raise AssertionError("quantized classifier: B5 launches or agreement off")
    res["kernel_rows"] += [dm_case(torch, timer, *s) for s in CLS_DM_SHAPES]
    del q, twin, f32, pq, pt
    torch.cuda.empty_cache()
    return res, model


def _attn_layers(torch, np):
    """(c) SelfAttentionLayer both ways and LearnedSelfAttentionLayer in
    a small f32 stack: the card against the port's CPU run, same weights."""
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.models.sequential import SequentialModel
    from deeplearning4j_tpu_torch.nn.conf.attention import (
        LearnedSelfAttentionLayer,
        SelfAttentionLayer,
    )
    from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers import Embedding
    from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.conf.recurrent import RnnOutputLayer
    from deeplearning4j_tpu_torch.nn.updaters import Adam

    conf = (NeuralNetConfiguration.builder().seed(5).updater(Adam(1e-3))
            .bf16_compute(False).list()
            .layer(Embedding(n_in=100, n_out=64))
            .layer(SelfAttentionLayer(n_out=64, n_heads=4, causal=False))
            .layer(SelfAttentionLayer(n_out=64, n_heads=4, project_input=False))
            .layer(LearnedSelfAttentionLayer(n_out=32, n_heads=2, n_queries=4))
            .layer(RnnOutputLayer(n_out=3))
            .set_input_type(InputType.recurrent(1)).build())
    r = np.random.default_rng(21)
    ids = r.integers(1, 100, (4, 24)).astype(np.int64)
    mask = (np.arange(24)[None] < np.array([[24], [17], [9], [13]])).astype(np.float32)
    mask[0, 5] = 0.0
    y = np.eye(3, dtype=np.float32)[r.integers(0, 3, (4, 4))]
    cpu = SequentialModel(conf, device="cpu").init()
    card = SequentialModel(conf, device="cuda").load_params(cpu.params)
    pc, pg = cpu.output(ids, mask), card.output(ids, mask).cpu()
    out_err = ((pg - pc).abs().max() / pc.abs().max()).item()
    lc, lg = [], []
    for _ in range(3):
        cpu.fit_batch(DataSet(ids, y, features_mask=mask))
        card.fit_batch(DataSet(ids, y, features_mask=mask))
        lc.append(cpu.score_value)
        lg.append(card.score_value)
    loss_err = max(abs(a - b) / abs(a) for a, b in zip(lc, lg))
    log(f"[attn] layers alone (f32): masked output() rel err {out_err:.3e}; losses "
        f"card {lg} cpu {lc}, rel err {loss_err:.3e} (tol 1e-5)")
    if out_err > 1e-5 or loss_err > 1e-5:
        raise AssertionError("the attention layers on the card disagree with the CPU")
    return {"output_rel_err": out_err, "losses_card": lg, "losses_cpu": lc,
            "loss_rel_err": loss_err}


def _attn_server(torch, np, kernels, model):
    """(d) `/v1/infer` over the trained classifier: padded requests with
    their own masks, one with a hole, batched by the server."""
    from deeplearning4j_tpu_torch.serving.http import ServingHTTPServer
    from deeplearning4j_tpu_torch.serving.server import InferenceServer, ServingConfig

    ids, _, mask = _cls_data(np, ATTN_SERVER_ROWS, 31)
    mask[0, 2] = 0.0                                  # a hole, not padding
    ref = model.output(ids, mask)
    srv = InferenceServer(model, ServingConfig(
        max_batch=8, max_queue=64, linger_s=0.005, default_deadline_s=120.0)).start()
    http = ServingHTTPServer(srv, port=0, host="127.0.0.1").start()
    try:
        def call(i):
            return _http(http.url, "/v1/infer", {"features": ids[i].tolist(),
                                                  "features_mask": mask[i].tolist()})

        call(0)                                       # first use of the bucket
        torch.cuda.synchronize()
        b0 = srv.stats()["batches"]
        kernels.reset_launches()
        got = _parallel([lambda i=i: call(i) for i in range(ATTN_SERVER_ROWS)])
        torch.cuda.synchronize()
        counts = kernels.launches()
        batches = srv.stats()["batches"] - b0
    finally:
        http.stop()
        srv.stop()
    if any(code != 200 for code, _ in got):
        raise AssertionError(f"/v1/infer refused a masked request: {got}")
    rows = torch.tensor([json.loads(body)["outputs"] for _, body in got])
    err = (rows - ref.cpu()).abs().max().item()
    scale = ref.abs().max().item()
    log(f"[attn] /v1/infer: {ATTN_SERVER_ROWS} padded masked requests (one with a hole) "
        f"in {batches} batch(es), launches {counts}; max |http - output(x, mask)| "
        f"{err:.3e} of max {scale:.3e} (tol {TOL['flash_fwd/bf16']} of max)")
    if counts.get("flash_fwd", 0) or err > TOL["flash_fwd/bf16"] * scale:
        raise AssertionError("/v1/infer: masked rows off, or B1 launched")
    return {"requests": ATTN_SERVER_ROWS, "batches": batches, "launches": counts,
            "max_abs_err": err}


def phase_attn(torch, np, kernels, timer):
    """The attention slice (ROADMAP A5): the MoE flagship trained, the
    masked classifier trained, evaluated, quantized and served, and the
    attention layers alone against the CPU."""
    res = {"moe": _attn_moe(torch, np, kernels, timer)}
    res["cls"], model = _attn_classifier(torch, np, kernels, timer)
    res["kernel_rows"] = res["moe"].pop("kernel_rows") + res["cls"].pop("kernel_rows")
    check_rows("attn", res["kernel_rows"])
    res["server"] = _attn_server(torch, np, kernels, model)
    del model
    torch.cuda.empty_cache()
    res["layers"] = _attn_layers(torch, np)
    return res


# -- the ResNet-50 slice (ROADMAP A4) ---------------------------------------------

# bench.py bench_resnet50: 224 x 224 x 3 images, 1000 classes, batch 256, 4
# batches cycled, steps_per_execution 16, 3 x 16 warm-up steps; bench.py
# times 15 x 16 steps: here 1 x 16 warm-up and 2 x 16 timed, cut for the
# script's time limit (with 12 timed groups the phase ran 136-145 s, with
# 3 warm-up and 4 timed 106.5 s)
RESNET_BATCH, RESNET_HW, RESNET_CLASSES, RESNET_BATCHES = 256, 224, 1000, 4
RESNET_SPE, RESNET_WARMUP_GROUPS, RESNET_GROUPS = 16, 1, 2
# the eager run beside the captured one, and the prefetch-fed run: groups
# of RESNET_SPE steps (one of warm-up each)
# (the prefetch run: 2 groups for the script's time limit, 3 before)
RESNET_EAGER_GROUPS, RESNET_PREFETCH_GROUPS = 2, 2
# the quantized head's B5 shape: (batch, the pooled width, classes)
RESNET_DM_SHAPE = (RESNET_BATCH, 2048, RESNET_CLASSES)
# the AttentionVertex graph: BERT-base attention widths, unmasked, non-causal
AV_BATCH, AV_SEQ, AV_D, AV_HEADS, AV_CLASSES = 32, 128, 768, 12, 10
# f32 output on the card against the same graph's f32 output on the CPU:
# softmax probabilities, the same f32 arithmetic (B1 f32 at f32 accuracy by
# split parts) summed in another order
AV_CPU_TOL = 1e-4


def _resnet_flops_by_hand(batch: int) -> float:
    """FLOPs of one ResNet-50 training step at ``batch``, counted from the
    shapes: each convolution 2 H_out W_out k_h k_w C_in C_out an image
    forward, its weight gradient the same and its input gradient the same
    again, except the stem's (the images take no gradient); the head's
    product 2 x 2048 x classes forward and twice that backward."""
    convs, h, c_in = [], RESNET_HW // 4, 64
    stem = (RESNET_HW // 2) ** 2 * 7 * 7 * 3 * 64
    for stage, (blocks, f) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512))):
        for block in range(blocks):
            ho = h // (2 if block == 0 and stage > 0 else 1)
            convs += [ho * ho * c_in * f, ho * ho * 9 * f * f, ho * ho * f * 4 * f]
            if block == 0:
                convs.append(ho * ho * c_in * 4 * f)
            c_in, h = 4 * f, ho
    macs = sum(convs) + 2048 * RESNET_CLASSES
    return batch * 2.0 * (3 * macs + 2 * stem)


def _resnet_train(torch, model, batches, groups):
    """``groups`` groups of RESNET_SPE steps over ``batches`` cycled,
    ``fit(..., steps_per_execution=RESNET_SPE)`` each; every loss (on
    the card, not synchronised)."""
    out = []
    for g in range(groups):
        group = [batches[(g * RESNET_SPE + i) % len(batches)] for i in range(RESNET_SPE)]
        model.fit(group, steps_per_execution=RESNET_SPE)
        out.append(model._last_score.reshape(-1))
    return torch.cat(out)


def _timed_groups(torch, model, batches, warm, groups):
    """``warm`` groups, then ``groups`` timed: (warm-up losses, timed
    losses, seconds of the timed groups)."""
    first = _resnet_train(torch, model, batches, warm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = _resnet_train(torch, model, batches, groups)
    torch.cuda.synchronize()
    return first, timed, time.perf_counter() - t0


def _resnet_prefetch(torch, np, model, host, res):
    """(b) The same training fed through `PrefetchIterator` over a
    generator of the host batches (staged from pinned memory on a side
    stream): the batches come out in order with their bytes, and the
    producer's work overlaps the steps."""
    from deeplearning4j_tpu_torch.data.prefetch import PrefetchIterator

    def feed(n):
        for i in range(n):
            yield host[i % len(host)]

    staged = list(PrefetchIterator(feed(len(host)), depth=2, device="cuda"))
    same = len(staged) == len(host) and all(
        s.features.is_cuda and np.array_equal(s.features.cpu().numpy(), h.features)
        and np.array_equal(s.labels.cpu().numpy(), h.labels)
        for s, h in zip(staged, host))
    del staged
    if not same:
        raise AssertionError("prefetch: the staged batches differ from the source")
    model.fit(feed(RESNET_SPE), steps_per_execution=RESNET_SPE)        # warm-up
    torch.cuda.synchronize()
    overlap0, wait0 = model.overlap_s, model.etl_wait_s
    steps = (RESNET_PREFETCH_GROUPS - 1) * RESNET_SPE
    t0 = time.perf_counter()
    model.fit(feed(steps), steps_per_execution=RESNET_SPE)
    losses = model._last_score.float().cpu().numpy()
    secs = time.perf_counter() - t0
    out = {"same_order_and_bytes": True, "steps": steps, "seconds": secs,
           "samples_per_s": steps * RESNET_BATCH / secs,
           "overlap_s": model.overlap_s - overlap0,
           "etl_wait_s": model.etl_wait_s - wait0}
    log(f"[resnet] (b) prefetch: {len(host)} batches staged in order with their "
        f"bytes; {steps} steps fed by PrefetchIterator over a generator of host "
        f"batches in {secs:.3f}s = {out['samples_per_s']:.1f} samples/s (in-memory "
        f"card batches: {res['samples_per_s']:.1f}); producer seconds hidden behind "
        f"the steps {out['overlap_s']:.3f}, consumer wait {out['etl_wait_s']:.3f}; "
        f"last group's losses finite {bool(np.isfinite(losses).all())}")
    if not out["overlap_s"] > 0 or not np.isfinite(losses).all():
        raise AssertionError(f"prefetch: no overlap, or non-finite losses: {out}")
    return out


def _resnet_ckpt_quant(torch, np, kernels, timer, model, batches, host):
    """(c) `write_model` / `restore` bit for bit and the next step's loss;
    `quantize`, `parity_check` on the first batch, and B5 at the head's
    shape."""
    from deeplearning4j_tpu_torch.quant import parity_check, quantize
    from deeplearning4j_tpu_torch.train.checkpoint import ModelSerializer

    out = {}
    # eager steps below: the step graph of another model would hold a
    # second pool (the captured step gives the eager step's bits, (a))
    model.capture_steps = False
    model._drop_graphs()
    gc.collect()
    torch.cuda.empty_cache()
    path = os.path.join("build", "ckpt", "resnet50.zip")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    try:
        t0 = time.perf_counter()
        ModelSerializer.write_model(model, path)
        out["write_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = ModelSerializer.restore(path, device="cuda")
        torch.cuda.synchronize()
        out["restore_s"] = time.perf_counter() - t0
        out["zip_bytes"] = os.path.getsize(path)
    finally:
        if os.path.exists(path):
            os.remove(path)
    back.capture_steps = False
    bad = _differing(torch, _full_state(torch, model, "cpu"), _full_state(torch, back, "cpu"))
    model.fit_batch(batches[0])
    back.fit_batch(batches[0])
    a, b = model._last_score, back._last_score
    out["next_loss"] = [float(a), float(b)]
    out["identical"] = not bad and bool(torch.equal(a, b))
    log(f"[resnet] (c) checkpoint: {out['zip_bytes']} bytes written in "
        f"{out['write_s']:.2f}s, restored on the card in {out['restore_s']:.2f}s; "
        f"state differs at {bad or 'no leaf'}; the next step's loss {float(a)!r} "
        f"saved, {float(b)!r} restored")
    if not out["identical"]:
        raise AssertionError("resnet checkpoint: the restored model is not the saved one")
    del back
    gc.collect()
    torch.cuda.empty_cache()

    q = quantize(model)
    x0 = host[0].features
    labels = host[0].labels.argmax(-1)
    q.output(x0)                                     # warm-up
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    qout = q.output(x0)
    torch.cuda.synchronize()
    q_ms = (time.perf_counter() - t0) * 1e3
    out["launches"] = kernels.launches()
    parity = parity_check(model, q, x0, labels)
    out.update(parity=parity, quant_output_ms=q_ms,
               quant_output_finite=bool(torch.isfinite(qout).all()))
    log(f"[resnet] (c) quantized: output() of {tuple(x0.shape)} in {q_ms:.2f} ms, "
        f"launches {out['launches']}; parity_check on the first batch {parity}")
    if out["launches"].get("dequant_matmul", 0) != 1 or not parity["pass"] \
            or not out["quant_output_finite"]:
        raise AssertionError(f"resnet quantized: {out}")
    row = dm_case(torch, timer, *RESNET_DM_SHAPE)
    out["kernel_rows"] = check_rows("resnet", [row])
    del q
    return out


def _attention_graph_conf(bf16):
    from deeplearning4j_tpu_torch.nn.activations import Activation
    from deeplearning4j_tpu_torch.nn.conf.graph_conf import AttentionVertex, GraphBuilder
    from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers import GlobalPooling, OutputLayer
    from deeplearning4j_tpu_torch.nn.updaters import Adam

    return (GraphBuilder().seed(123).updater(Adam(1e-4)).bf16_compute(bf16)
            .add_inputs("x").set_input_types(InputType.recurrent(AV_D, AV_SEQ))
            .add_vertex("att", AttentionVertex(n_out=AV_D, n_heads=AV_HEADS), "x")
            .add_layer("pool", GlobalPooling(), "att")
            .add_layer("out", OutputLayer(n_out=AV_CLASSES, activation=Activation.SOFTMAX),
                       "pool")
            .set_outputs("out").build())


def _resnet_attention(torch, np, kernels, timer):
    """(d) A graph with an unmasked `AttentionVertex` at BERT-base widths:
    B1 once a vertex a call, B2 and B3 in a training step, in bf16 and
    f32; the f32 output against the same graph's on the CPU."""
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.models.computation_graph import GraphModel

    r = np.random.default_rng(5)
    x = r.normal(size=(AV_BATCH, AV_SEQ, AV_D)).astype(np.float32)
    y = np.eye(AV_CLASSES, dtype=np.float32)[r.integers(0, AV_CLASSES, AV_BATCH)]
    out = {}
    for tag, bf16 in (("bf16", True), ("f32", False)):
        m = GraphModel(_attention_graph_conf(bf16), device="cuda").init()
        m.output(x)
        torch.cuda.synchronize()
        kernels.reset_launches()
        probs = m.output(x)
        torch.cuda.synchronize()
        infer = kernels.launches()
        m.fit_batch(DataSet(x, y))                   # the capture's warm-up
        torch.cuda.synchronize()
        kernels.reset_launches()
        m.fit_batch(DataSet(x, y))
        loss = m.score_value
        train = kernels.launches()
        # launches of one output() call (the kernels line's count)
        res = {"launches": infer, "train_launches": train, "loss": loss}
        if not bf16:
            cpu = GraphModel(_attention_graph_conf(False), device="cpu").init()
            ref = cpu.output(x).numpy()
            res["cpu_max_abs_err"] = float(np.abs(probs.cpu().numpy() - ref).max())
        out[tag] = res
        log(f"[resnet] (d) AttentionVertex graph {tag}: output() launches {infer}; "
            f"one captured step's launches {train}; loss {loss:.5f}"
            + (f"; f32 output against the CPU's: max |diff| {res['cpu_max_abs_err']:.3e} "
               f"(tol {AV_CPU_TOL:.0e})" if not bf16 else ""))
        if (infer.get("flash_fwd", 0) != 1 or train.get("flash_fwd", 0) != 1
                or train.get("flash_bwd_dq", 0) != 1 or train.get("flash_bwd_dkdv", 0) != 1
                or not np.isfinite(loss)):
            raise AssertionError(f"AttentionVertex graph {tag}: {res}")
        if not bf16 and not res["cpu_max_abs_err"] <= AV_CPU_TOL:
            raise AssertionError(f"AttentionVertex graph f32: {res}")
        del m
    out["kernel_rows"] = check_rows("resnet", [
        flash_case(torch, timer, AV_SEQ, dt, causal=False, bh=AV_BATCH * AV_HEADS,
                   d=AV_D // AV_HEADS) for dt in (torch.bfloat16, torch.float32)])
    return out


def phase_resnet(torch, np, kernels, timer):
    """The ResNet-50 slice on the card; see the module docstring."""
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.observe import cost
    from deeplearning4j_tpu_torch.zoo.resnet import ResNet50

    t_phase = time.perf_counter()
    rng = np.random.default_rng(0)
    host = [DataSet(rng.normal(0, 1, (RESNET_BATCH, RESNET_HW, RESNET_HW, 3)
                               ).astype(np.float32),
                    np.eye(RESNET_CLASSES, dtype=np.float32)[
                        rng.integers(0, RESNET_CLASSES, RESNET_BATCH)])
            for _ in range(RESNET_BATCHES)]
    # staged on the card once, as bench.py stages its batches
    batches = [DataSet(torch.from_numpy(b.features).cuda(),
                       torch.from_numpy(b.labels).cuda()) for b in host]
    model = ResNet50().init_model()
    res = {"params": model.num_params(), "compute": str(model.compute_dtype)}

    # (a) eager first (the program's cost analysis runs with no graph held)
    model.capture_steps = False
    mem0 = _memory_window(torch)
    e_first, e_timed, e_secs = _timed_groups(torch, model, batches, 1,
                                             RESNET_EAGER_GROUPS - 1)
    eager_ms = e_secs / ((RESNET_EAGER_GROUPS - 1) * RESNET_SPE) * 1e3
    memory = {"eager": _memory_window(torch, mem0)}
    hand = _resnet_flops_by_hand(RESNET_BATCH)
    rec = next(r for r in cost.analyze_model(model) if r.kind == "train")
    model.capture_steps = True
    mem0 = _memory_window(torch)
    first, timed, secs = _timed_groups(torch, model, batches, RESNET_WARMUP_GROUPS,
                                       RESNET_GROUPS)
    memory["captured"] = _memory_window(torch, mem0)
    n = RESNET_GROUPS * RESNET_SPE
    step_ms = secs / n * 1e3
    losses = torch.cat([e_first, e_timed, first, timed]).float().cpu().numpy()
    peak_f, _ = cost.peaks()
    res.update({
        "ms_per_step": step_ms, "eager_ms_per_step": eager_ms,
        "samples_per_s": n * RESNET_BATCH / secs,
        "eager_samples_per_s": RESNET_BATCH / eager_ms * 1e3,
        "flops": rec.flops, "flops_by_hand": hand,
        "mfu": rec.flops / (step_ms / 1e3) / peak_f, "peak_flops": peak_f,
        "memory": memory, "step_graphs": model.compile_stats()["step_programs"],
        "first_group_mean": float(losses[:RESNET_SPE].mean()),
        "last_group_mean": float(losses[-RESNET_SPE:].mean())})
    log(f"[resnet] (a) ResNet-50 ({res['params']} params, {res['compute']}) at "
        f"{RESNET_HW} x {RESNET_HW} x 3, batch {RESNET_BATCH}, steps_per_execution "
        f"{RESNET_SPE}: captured {step_ms:.3f} ms a step = {res['samples_per_s']:.1f} "
        f"samples/s ({RESNET_WARMUP_GROUPS} warm-up + {RESNET_GROUPS} timed groups); "
        f"eager {eager_ms:.3f} ms a step = {res['eager_samples_per_s']:.1f} samples/s; "
        f"{rec.flops:.6e} FLOPs a step (by hand {hand:.6e}, {rec.flops / hand - 1:+.2e}); "
        f"MFU {res['mfu']:.4f} against {peak_f / 1e12:.0f} TFLOP/s "
        f"({torch.cuda.get_device_name(0)}); {res['step_graphs']} step graph(s); "
        f"memory (GiB) {_memory_text(memory)}")
    log(f"[resnet] (a) losses: first group mean {res['first_group_mean']:.5f}, last "
        f"{res['last_group_mean']:.5f}; every group's mean "
        f"{[round(float(x), 4) for x in losses.reshape(-1, RESNET_SPE).mean(1)]}")
    if not np.isfinite(losses).all():
        raise AssertionError("resnet: a non-finite loss")
    if not res["last_group_mean"] < res["first_group_mean"]:
        raise AssertionError("resnet: the loss did not fall")
    if abs(rec.flops / hand - 1) > 0.01:
        raise AssertionError(f"resnet: counted FLOPs {rec.flops} not within 1% of "
                             f"the hand count {hand}")
    def group():
        _resnet_train(torch, model, batches, 1)

    res["profile"] = _profiled(torch, "resnet", group)
    res["captured_vs_eager"] = _captured_vs_eager(
        torch, model, batches[:2], "ResNet-50", phase="resnet", host=True)
    t0 = time.perf_counter()
    res["prefetch"] = _resnet_prefetch(torch, np, model, host, res)
    res["prefetch"]["phase_s"] = time.perf_counter() - t0
    res["ckpt"] = _resnet_ckpt_quant(torch, np, kernels, timer, model, batches, host)
    res["quant"] = {"launches": res["ckpt"]["launches"]}
    del model, batches
    gc.collect()
    torch.cuda.empty_cache()
    res["attn"] = _resnet_attention(torch, np, kernels, timer)
    res["kernel_rows"] = res["ckpt"].pop("kernel_rows") + res["attn"].pop("kernel_rows")
    res["seconds"] = time.perf_counter() - t_phase
    log(f"[resnet] phase seconds {res['seconds']:.1f}")
    return res


# -- the data pipeline slice (ROADMAP A12) -------------------------------------------

# (a) BASELINE config 2 fed from files as bench.py bench_resnet50_etl feeds
# it: 1,024 images of 4 classes written from numpy seed 0 by the rule of
# bench.py _etl_corpus (500 x 375 JPEG q85 where the host can write and
# decode JPEG, else 256 x 256 x 3 uint8 .npy), read at 256 x 256 x 3 uint8
# in batches of 256, randomly cropped to 224 and flipped on the card
ETL_IMAGES, ETL_CLASSES, ETL_BATCH, ETL_SIDE, ETL_CROP = 1024, 4, 256, 256, 224
ETL_SRC_H, ETL_SRC_W = 375, 500
# fused against host-decoded training from one state: 3 steps; the gap may
# not exceed ETL_FLOOR_X times the same host-decoded steps' own floor, the
# gap to the same steps with each batch's two halves of rows swapped (the
# same function, its batch sums in another order)
ETL_PARITY_STEPS, ETL_FLOOR_X = 3, 2.0
# DeviceDecode.fn on the card against DeviceDecode.host: the reference's
# own host / device bound
ETL_DECODE_TOL = 1e-6
# (b) LeNet fed from IDX bytes: MNIST-format files of 10,000 images from
# numpy seed 0, batches of 512 (19 whole ones), grouped fits of 16 steps
LENET_IDX_IMAGES, LENET_IDX_BATCH, LENET_IDX_SPE = 10000, 512, 16
ETL_LENET_LOSS_REL = 1e-5
ETL_DIR = os.path.join("build", "etl")     # inside the checkout; removed after


def _etl_counters():
    from deeplearning4j_tpu_torch.observe.metrics import registry

    reg = registry()
    return {"decode_batches": reg.counter("dl4jtpu_device_decode_batches_total").sum_series(),
            "decode_s": reg.counter("dl4jtpu_device_decode_seconds_total").sum_series(),
            "fallbacks": reg.counter("dl4jtpu_device_decode_fallbacks_total").sum_series(),
            "raw": reg.counter("dl4jtpu_h2d_bytes_total").value(feed="raw"),
            "decoded": reg.counter("dl4jtpu_h2d_bytes_total").value(feed="decoded"),
            "cache_wait": reg.counter("dl4jtpu_etl_wait_seconds_total").value(source="cache")}


def _etl_delta(c0):
    c1 = _etl_counters()
    return {k: c1[k] - c0[k] for k in c0}


def _etl_corpus(np, root, jpeg):
    """bench.py _etl_corpus's images (numpy seed 0: a class-shifted
    gradient, a jittered gradient, noise), as JPEG q85 at 500 x 375 or as
    256 x 256 x 3 uint8 .npy; the encodes run on 8 threads in order of
    the draws.  Returns the seconds."""
    from concurrent.futures import ThreadPoolExecutor

    h, w = (ETL_SRC_H, ETL_SRC_W) if jpeg else (ETL_SIDE, ETL_SIDE)
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    gx = np.linspace(0, 255, w)[None, :] * np.ones((h, 1))
    gy = np.linspace(0, 255, h)[:, None] * np.ones((1, w))
    for cls in range(ETL_CLASSES):
        os.makedirs(os.path.join(root, f"c{cls}"), exist_ok=True)

    def save(img, path):
        if jpeg:
            from PIL import Image

            Image.fromarray(img).save(path, quality=85)
        else:
            np.save(path, img)

    with ThreadPoolExecutor(8) as pool:
        pending = []
        for i in range(ETL_IMAGES):
            cls = i % ETL_CLASSES
            img = np.stack([(gx + 40 * cls) % 256, (gy * 0.7 + rng.integers(0, 64)) % 256,
                            rng.integers(0, 255, (h, w))], -1).astype(np.uint8)
            name = f"img_{i:05d}." + ("jpg" if jpeg else "npy")
            pending.append(pool.submit(save, img, os.path.join(root, f"c{cls}", name)))
            if len(pending) >= 32:
                pending.pop(0).result()
        for f in pending:
            f.result()
    return time.perf_counter() - t0


class _EtlHashing:
    """A base iterator whose batches' bytes are hashed as they pass (the
    cache tier's populate pass)."""

    def __init__(self, base):
        self._base = base
        self.hashes = []

    @property
    def batch_size(self):
        return self._base.batch_size

    def reset(self):
        self._base.reset()

    def __iter__(self):
        for b in self._base:
            self.hashes.append(_etl_hash(b))
            yield b


def _etl_hash(batch):
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for a in (batch.features, batch.labels):
        a = np.ascontiguousarray(a)
        h.update(str((a.dtype, a.shape)).encode())
        h.update(a.data)
    return h.hexdigest()


class _EtlHostDecoded:
    """The same raw batches decoded on the host (`DeviceDecode.host`, one
    augmentation index a batch): the unfused feed."""

    def __init__(self, base, decode):
        self._base, self._decode, self._step = base, decode, 0

    @property
    def batch_size(self):
        return self._base.batch_size

    def reset(self):
        self._base.reset()

    def __iter__(self):
        for b in self._base:
            self._step += 1
            yield self._decode.host(self._step - 1, b)


class _EtlLosses:
    def __init__(self):
        self.values = []

    def iteration_done(self, model, iteration, epoch, score):
        self.values.append(float(score))

    def on_epoch_start(self, model, epoch):
        pass

    def on_epoch_end(self, model, epoch):
        pass


def _etl_fit(torch, model, feed, **kw):
    """``model.fit(feed)``; (seconds to the card's end, the steps' losses)."""
    lst = _EtlLosses()
    model.set_listeners(lst)
    t0 = time.perf_counter()
    try:
        model.fit(feed, **kw)
        torch.cuda.synchronize()
    finally:
        model.set_listeners()
    return time.perf_counter() - t0, lst.values


def _etl_raw_feed(dv, batches, chain, start=0):
    """A `DeviceTransformIterator` over in-memory raw ``batches`` whose
    augmentation counter starts at ``start``."""
    from deeplearning4j_tpu_torch.data.iterator import ExistingDataSetIterator

    it = dv.DeviceTransformIterator(ExistingDataSetIterator(list(batches)), chain)
    for _ in range(start):
        it.next_decode_step()
    return it


def _etl_change_gap(a, b, s0):
    """Relative L2 between two runs' parameter changes from the state
    ``s0`` (host copies), over every parameter leaf."""
    num = den = 0.0
    for x, y, z in zip(a["params"], b["params"], s0["params"]):
        z = z.double()
        dx, dy = x.double() - z, y.double() - z
        num += float(((dx - dy) ** 2).sum())
        den += float((dy ** 2).sum())
    return (num / den) ** 0.5 if den else 0.0


def _etl_loss_gap(a, b):
    return max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a, b))


def _etl_captured_vs_eager(torch, model, make_feed, tag, spe=1, host=False):
    """From one state, the fused fit over ``make_feed()`` replaying the
    model's captured step, then the same fit eagerly (``capture_steps =
    False``): losses, parameters, optimizer and layer state bit for bit,
    and no step graph captured during the replays."""
    where = "cpu" if host else None
    snap = _full_state(torch, model)
    graphs0 = dict(model._captured)
    _, cap = _etl_fit(torch, model, make_feed(), steps_per_execution=spe)
    recaptures = sum(model._captured.get(k) is not g for k, g in graphs0.items()) + len(
        set(model._captured) - set(graphs0))
    after_cap = _full_state(torch, model, where)
    _restore_state(torch, model, snap)
    model.capture_steps = False
    try:
        _, eag = _etl_fit(torch, model, make_feed(), steps_per_execution=spe)
    finally:
        model.capture_steps = True
    after_eager = _full_state(torch, model, where)
    del snap
    bad = _differing(torch, after_cap, after_eager)
    log(f"[etl] {tag}: {len(cap)} fused steps replaying the captured step against "
        f"eager from one state: losses {cap} identical: {cap == eag}; state differs "
        f"at {bad or 'no leaf'}; step graphs captured during the replays {recaptures}")
    if cap != eag or bad or recaptures or len(cap) < 3:
        raise AssertionError(f"etl: {tag}: the captured fused step is not the eager step")
    return {"losses": cap, "identical": True}


def _etl_resnet(torch, np, card, root):
    """(a) ResNet-50 fed from files; see the module docstring."""
    from deeplearning4j_tpu_torch.data.cached import CachedDataSetIterator
    from deeplearning4j_tpu_torch.data.iterator import ExistingDataSetIterator
    from deeplearning4j_tpu_torch.data.prefetch import PrefetchIterator
    from deeplearning4j_tpu_torch.datavec import (
        ImageRecordReader,
        RecordReaderDataSetIterator,
    )
    from deeplearning4j_tpu_torch.datavec import device as dv
    from deeplearning4j_tpu_torch.zoo.resnet import ResNet50

    def base():
        reader = ImageRecordReader(ETL_SIDE, ETL_SIDE, 3, shuffle_seed=0,
                                   dtype="uint8").initialize(root)
        return RecordReaderDataSetIterator(reader, ETL_BATCH, label_index=1,
                                           num_classes=ETL_CLASSES, drop_last=True)

    chain = dv.TransformChain(features=(dv.RandomCrop(ETL_CROP, ETL_CROP), dv.RandomFlip(0.5),
                                        dv.Scale(1 / 127.5, -1.0)), seed=0)
    decode = dv.try_lower(chain)[0]
    steps = ETL_IMAGES // ETL_BATCH
    out = {}
    # ETL alone: the reader's decode and batching, no card in the loop
    t0 = time.perf_counter()
    held = []
    n = 0
    for b in base():
        n += b.num_examples
        if len(held) < ETL_PARITY_STEPS + 1:
            held.append(b)
    etl_s = time.perf_counter() - t0
    out["etl_images_per_s"] = n / etl_s
    raw_bytes = held[0].features.nbytes + held[0].labels.nbytes
    dec_bytes = ETL_BATCH * ETL_CROP * ETL_CROP * 3 * 4 + held[0].labels.nbytes
    log(f"[etl] (a) ETL without the card: {n} images read, decoded and batched in "
        f"{etl_s:.3f} s = {out['etl_images_per_s']:.1f} images/s ({os.cpu_count()} host "
        f"cores; {card}); a raw batch {held[0].features.dtype} "
        f"{tuple(held[0].features.shape)}")

    model = ResNet50(num_classes=ETL_CLASSES).init_model()
    out["compute"] = str(model.compute_dtype)
    # 1. live decode, fused: epoch 1 captures the fused step, epoch 2 timed
    c0 = _etl_counters()
    dti = dv.DeviceTransformIterator(base(), chain)
    warm_s, warm = _etl_fit(torch, model, dti)
    timed_s, fused_losses = _etl_fit(torch, model, dti)
    d = _etl_delta(c0)
    fused_keys = [k for k in model._captured if k[-1][0] == "fused"]
    out["fused"] = {"s": timed_s, "ms_per_step": timed_s / steps * 1e3,
                    "samples_per_s": ETL_IMAGES / timed_s, "warm_s": warm_s,
                    "losses": warm + fused_losses, "counters": d,
                    "h2d_mb_per_step": d["raw"] / (2 * steps) / 1e6,
                    "staged": [str(s) for s in (fused_keys[0][:2] if fused_keys else ())]}
    log(f"[etl] (a1) live decode, fused (ResNet-50 {out['compute']}, batch {ETL_BATCH}, "
        f"steps_per_execution 1): {out['fused']['ms_per_step']:.3f} ms a step = "
        f"{out['fused']['samples_per_s']:.1f} samples/s over the timed epoch (the first, "
        f"which captures, {warm_s:.3f} s); host-to-device {out['fused']['h2d_mb_per_step']:.3f} "
        f"MB a step raw; decoded batches {d['decode_batches']}, fallbacks {d['fallbacks']}; "
        f"staged inputs {out['fused']['staged']}; losses {out['fused']['losses']} ({card})")
    if d["decode_batches"] != 2 * steps or d["fallbacks"] != 0:
        raise AssertionError(f"etl: the fused route did not run every step: {d}")
    if d["raw"] != 2 * steps * raw_bytes or d["decoded"] != 0:
        raise AssertionError(f"etl: raw host-to-device bytes {d['raw']} are not the "
                             f"batches' {2 * steps * raw_bytes}")
    if len(fused_keys) != 1 or fused_keys[0][0][1] != torch.uint8:
        raise AssertionError(f"etl: want one fused step graph with uint8 inputs, got {fused_keys}")
    if not np.isfinite(out["fused"]["losses"]).all():
        raise AssertionError("etl: a non-finite loss")
    # the measurement the fused steps charged (cached for this signature)
    out["decode_ms"] = decode.calibrated_seconds(*(torch.from_numpy(a).cuda() for a in (
        held[0].features, held[0].labels))) * 1e3
    log(f"[etl] (a1) the decode's calibrated ms (the standalone decode as its own "
        f"CUDA graph, CUDA events): {out['decode_ms']:.4f} ({card})")

    # 2. the same batches host-decoded through PrefetchIterator, unfused
    c0 = _etl_counters()
    feed = PrefetchIterator(_EtlHostDecoded(base(), decode), depth=2)
    warm_s, _ = _etl_fit(torch, model, feed)
    timed_s, host_losses = _etl_fit(torch, model, feed)
    d = _etl_delta(c0)
    out["host_decoded"] = {"s": timed_s, "ms_per_step": timed_s / steps * 1e3,
                           "samples_per_s": ETL_IMAGES / timed_s, "warm_s": warm_s,
                           "losses": host_losses, "counters": d,
                           "h2d_mb_per_step": d["decoded"] / (2 * steps) / 1e6}
    log(f"[etl] (a2) host-decoded (DeviceDecode.host through PrefetchIterator), unfused: "
        f"{out['host_decoded']['ms_per_step']:.3f} ms a step = "
        f"{out['host_decoded']['samples_per_s']:.1f} samples/s (first epoch {warm_s:.3f} s); "
        f"host-to-device {out['host_decoded']['h2d_mb_per_step']:.3f} MB a step decoded "
        f"against {out['fused']['h2d_mb_per_step']:.3f} raw = "
        f"{out['host_decoded']['h2d_mb_per_step'] / out['fused']['h2d_mb_per_step']:.3f}x ({card})")
    if d["decode_batches"] != 0 or d["decoded"] != 2 * steps * dec_bytes:
        raise AssertionError(f"etl: the host-decoded run is not unfused: {d}")

    # the decode inside the step equals the host decode
    crop_flip = dv.DeviceDecode(dv.TransformChain(chain.features[:2], seed=chain.seed))
    f_dev = torch.from_numpy(held[0].features).cuda()
    l_dev = torch.from_numpy(held[0].labels).cuda()
    worst = 0.0
    for step in (0, 1, 5, 1000):
        host = decode.host(step, held[0])
        keys = torch.from_numpy(decode.keys(step)).cuda()
        f, _, _, _ = decode.fn(step, f_dev, l_dev, keys=keys)
        worst = max(worst, float((f.cpu() - torch.from_numpy(host.features)).abs().max()))
        pixels = crop_flip.fn(step, f_dev, l_dev)[0].cpu().numpy()
        if not np.array_equal(pixels, crop_flip.host(step, held[0]).features):
            raise AssertionError(f"etl: the card's crop window or flip coins differ at step {step}")
    out["decode_max_abs_err"] = worst
    log(f"[etl] (a) DeviceDecode.fn on the card against DeviceDecode.host (numpy), steps "
        f"0, 1, 5, 1000: crop windows and flip coins identical (uint8 pixels equal), "
        f"values max |diff| {worst:.3e} (tol {ETL_DECODE_TOL})")
    if worst > ETL_DECODE_TOL:
        raise AssertionError("etl: the decode inside the step differs from the host decode")
    del f_dev, l_dev

    # captured against eager: 4 fused steps after the capture, their own keys
    out["captured_vs_eager"] = _etl_captured_vs_eager(
        torch, model, lambda: _etl_raw_feed(dv, held, chain, start=1),
        "ResNet-50 (augmentation indices 1-4)", host=True)

    # fused against host-decoded training from one state, and the floor
    snap = _full_state(torch, model)
    s0 = _full_state(torch, model, "cpu")
    parity = held[:ETL_PARITY_STEPS]
    decoded = [decode.host(i, b) for i, b in enumerate(parity)]
    half = ETL_BATCH // 2

    def swapped(b):
        from deeplearning4j_tpu_torch.data.dataset import DataSet

        return DataSet(*(np.concatenate([a[half:], a[:half]]) for a in (b.features, b.labels)))

    runs = {}
    for name, feed in (("fused", lambda: _etl_raw_feed(dv, parity, chain)),
                       ("host", lambda: ExistingDataSetIterator(decoded)),
                       ("swapped", lambda: ExistingDataSetIterator([swapped(b) for b in decoded]))):
        _restore_state(torch, model, snap)
        _, losses = _etl_fit(torch, model, feed())
        runs[name] = (losses, _full_state(torch, model, "cpu"))
    _restore_state(torch, model, snap)
    del snap
    floor = {"loss": _etl_loss_gap(runs["swapped"][0], runs["host"][0]),
             "change": _etl_change_gap(runs["swapped"][1], runs["host"][1], s0)}
    gap = {"loss": _etl_loss_gap(runs["fused"][0], runs["host"][0]),
           "change": _etl_change_gap(runs["fused"][1], runs["host"][1], s0)}
    out["parity"] = {"floor": floor, "gap": gap, "losses": {k: v[0] for k, v in runs.items()}}
    log(f"[etl] (a) fused against host-decoded training, {ETL_PARITY_STEPS} steps from one "
        f"state: losses fused {runs['fused'][0]}, host {runs['host'][0]}; gap: loss "
        f"{gap['loss']:.3e} relative, parameter change {gap['change']:.3e} relative L2; the "
        f"floor (the host-decoded steps with each batch's halves of rows swapped): loss "
        f"{floor['loss']:.3e}, change {floor['change']:.3e}; gate {ETL_FLOOR_X}x the floor")
    for k in ("loss", "change"):
        if gap[k] > ETL_FLOOR_X * floor[k]:
            raise AssertionError(f"etl: fused training differs from host-decoded training "
                                 f"beyond its floor ({k}: {gap[k]} > {ETL_FLOOR_X} x {floor[k]})")
    del runs, s0, decoded

    # 3. the cache tier: populate, then a replayed fused epoch
    cache_dir = os.path.join(ETL_DIR, "cache")
    hashing = _EtlHashing(base())
    cached = CachedDataSetIterator(hashing, cache_dir)
    cdti = dv.DeviceTransformIterator(cached, chain)
    c0 = _etl_counters()
    pop_s, _ = _etl_fit(torch, model, cdti)
    c1 = _etl_counters()
    replay_s, replay_losses = _etl_fit(torch, model, cdti)
    d_replay = _etl_delta(c1)
    replayed = [_etl_hash(b) for b in cached]
    cache_mb = sum(os.path.getsize(os.path.join(cache_dir, f)) for f in os.listdir(cache_dir)) / 1e6
    out["cached"] = {"populate_s": pop_s, "s": replay_s, "ms_per_step": replay_s / steps * 1e3,
                     "samples_per_s": ETL_IMAGES / replay_s, "losses": replay_losses,
                     "decode_epochs": cached.decode_epochs, "cache_hits": cached.cache_hits,
                     "cache_mb": cache_mb, "counters": _etl_delta(c0),
                     "cache_wait_s": d_replay["cache_wait"]}
    log(f"[etl] (a3) CachedDataSetIterator: populate epoch (decode, write, fused steps) "
        f"{pop_s:.3f} s; replayed fused epoch {out['cached']['ms_per_step']:.3f} ms a step = "
        f"{out['cached']['samples_per_s']:.1f} samples/s; {cache_mb:.1f} MB on disk; decode "
        f"epochs {cached.decode_epochs}, cache hits {cached.cache_hits}; replay pull seconds "
        f"on source=\"cache\" {d_replay['cache_wait']:.4f}; replayed batches byte-identical: "
        f"{replayed == hashing.hashes} ({card})")
    if replayed != hashing.hashes or len(replayed) != steps or cached.decode_epochs != 1:
        raise AssertionError("etl: the cached epoch does not replay the populated batches")
    if d_replay["decode_batches"] != steps or d_replay["fallbacks"] != 0 or not d_replay[
            "cache_wait"] > 0:
        raise AssertionError(f"etl: the replayed epoch did not run fused: {d_replay}")
    del model, held
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _etl_lenet(torch, np, card):
    """(b) LeNet fed from IDX bytes; see the module docstring."""
    import struct

    from deeplearning4j_tpu_torch import bench_lenet as bl
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.data.iterator import ExistingDataSetIterator
    from deeplearning4j_tpu_torch.data.normalizers import (
        ImagePreProcessingScaler,
        NormalizingIterator,
    )
    from deeplearning4j_tpu_torch.runtime import native
    from deeplearning4j_tpu_torch.runtime.flags import environment

    root = os.path.join(ETL_DIR, "mnist")
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (LENET_IDX_IMAGES, 28, 28)).astype(np.uint8)
    labels = rng.integers(0, 10, LENET_IDX_IMAGES).astype(np.uint8)
    paths = {}
    for name, arr in (("train-images-idx3-ubyte", images), ("train-labels-idx1-ubyte", labels)):
        paths[name] = os.path.join(root, name)
        with open(paths[name], "wb") as f:
            f.write(struct.pack(">BBBB", 0, 0, 8, arr.ndim))
            f.write(struct.pack(f">{arr.ndim}I", *arr.shape))
            f.write(arr.tobytes())
    t0 = time.perf_counter()
    x = native.idx_read_u8(paths["train-images-idx3-ubyte"])
    y = native.idx_read_u8(paths["train-labels-idx1-ubyte"])
    read_s = time.perf_counter() - t0
    if not (np.array_equal(x, images) and np.array_equal(y, labels)):
        raise AssertionError("etl: idx_read_u8 did not read the written IDX bytes")
    n = LENET_IDX_IMAGES // LENET_IDX_BATCH
    onehot = np.eye(10, dtype=np.float32)[y]
    batches = [DataSet(x[i * LENET_IDX_BATCH:(i + 1) * LENET_IDX_BATCH, :, :, None],
                       onehot[i * LENET_IDX_BATCH:(i + 1) * LENET_IDX_BATCH]) for i in range(n)]
    scaler = ImagePreProcessingScaler(0.0, 1.0)

    def feed(bs):
        return NormalizingIterator(ExistingDataSetIterator(list(bs)), scaler)

    out = {"idx_read_s": read_s, "batches": n}
    raw_bytes = batches[0].features.nbytes + batches[0].labels.nbytes
    for kind in ("f32", "bf16"):
        model = bl.lenet(device="cuda", f32=kind == "f32")
        c0 = _etl_counters()
        warm_s, _ = _etl_fit(torch, model, feed(batches))
        single_s, single = _etl_fit(torch, model, feed(batches))
        grouped_s, grouped = _etl_fit(torch, model, feed(batches),
                                      steps_per_execution=LENET_IDX_SPE)
        d = _etl_delta(c0)
        fused_keys = [k for k in model._captured if k[-1][0] == "fused"]
        r = out[kind] = {"single_ms_per_step": single_s / n * 1e3,
                         "single_samples_per_s": n * LENET_IDX_BATCH / single_s,
                         "grouped_ms_per_step": grouped_s / n * 1e3,
                         "grouped_samples_per_s": n * LENET_IDX_BATCH / grouped_s,
                         "warm_s": warm_s, "counters": d,
                         "h2d_mb_per_step": d["raw"] / (3 * n) / 1e6,
                         "losses_first_last": [single[0], grouped[-1]]}
        log(f"[etl] (b) LeNet {kind} fed from IDX bytes ({LENET_IDX_IMAGES} images read by "
            f"idx_read_u8 in {read_s * 1e3:.3f} ms) through NormalizingIterator("
            f"ImagePreProcessingScaler), batch {LENET_IDX_BATCH}: single steps "
            f"{r['single_ms_per_step']:.4f} ms a step = {r['single_samples_per_s']:.1f} "
            f"samples/s; steps_per_execution {LENET_IDX_SPE}: {r['grouped_ms_per_step']:.4f} ms "
            f"a step = {r['grouped_samples_per_s']:.1f} samples/s; first epoch (captures) "
            f"{warm_s:.3f} s; host-to-device {r['h2d_mb_per_step']:.4f} MB a step raw; "
            f"decoded batches {d['decode_batches']}, fallbacks {d['fallbacks']} ({card})")
        if d["decode_batches"] != 3 * n or d["fallbacks"] != 0 or d["decoded"] != 0:
            raise AssertionError(f"etl: LeNet {kind}: the fused route did not run every step: {d}")
        if d["raw"] != 3 * n * raw_bytes:
            raise AssertionError(f"etl: LeNet {kind}: raw bytes {d['raw']} are not the batches' "
                                 f"{3 * n * raw_bytes}")
        if len(fused_keys) != 1 or fused_keys[0][0][1] != torch.uint8:
            raise AssertionError(f"etl: LeNet {kind}: want one fused graph of uint8 inputs")
        if kind == "bf16":
            del model
            continue
        # fused against host-decoded (the native scaler, unfused), f32
        snap = _full_state(torch, model)
        _, fused = _etl_fit(torch, model, feed(batches[:3]))
        _restore_state(torch, model, snap)
        env = environment()
        env.device_decode = False
        try:
            _, host = _etl_fit(torch, model, feed(batches[:3]))
        finally:
            env.device_decode = True
        _restore_state(torch, model, snap)
        del snap
        gap = _etl_loss_gap(fused, host)
        r["parity"] = {"fused": fused, "host": host, "loss_rel": gap}
        log(f"[etl] (b) LeNet f32 fused against host-decoded, 3 steps from one state: "
            f"losses {fused} against {host}, max relative gap {gap:.3e} "
            f"(tol {ETL_LENET_LOSS_REL})")
        if gap > ETL_LENET_LOSS_REL:
            raise AssertionError("etl: LeNet fused training differs from host-decoded training")
        r["captured_vs_eager"] = {
            "single": _etl_captured_vs_eager(torch, model, lambda: feed(batches[3:7]),
                                             "LeNet f32, single steps"),
            "grouped": _etl_captured_vs_eager(torch, model, lambda: feed(batches[3:9]),
                                              "LeNet f32, steps_per_execution 3", spe=3)}
        del model
    return out


def phase_etl(torch, np, kernels, card):
    """The data pipeline slice (ROADMAP A12) on the card; see the module
    docstring."""
    import importlib.util

    from deeplearning4j_tpu_torch.runtime import native

    t_phase = time.perf_counter()
    if not native.available():
        raise AssertionError("etl: the native IO library did not build or load")
    pil = importlib.util.find_spec("PIL") is not None
    jpeg = pil and native.has_jpeg()
    res = {"native": native.version(), "has_jpeg": native.has_jpeg(), "pil": pil,
           "corpus": "jpeg" if jpeg else "npy"}
    log(f"[etl] native IO library {res['native']}: JPEG decode "
        f"{'compiled in' if res['has_jpeg'] else 'absent (no jpeglib.h)'}; PIL "
        f"{'present' if pil else 'absent'}")
    why = ("PIL writes and the native library decodes JPEG" if jpeg else
           "no JPEG path on this host (" + ", ".join(
               w for w, ok in (("PIL absent", pil), ("no libjpeg in the native library",
                                                     res["has_jpeg"])) if not ok) + ")")
    shutil.rmtree(ETL_DIR, ignore_errors=True)
    root = os.path.join(ETL_DIR, "corpus")
    try:
        secs = _etl_corpus(np, root, jpeg)
        log(f"[etl] corpus: {ETL_IMAGES} images of {ETL_CLASSES} classes from numpy seed 0 as "
            + (f"{ETL_SRC_W} x {ETL_SRC_H} JPEG q85" if jpeg else
               f"{ETL_SIDE} x {ETL_SIDE} x 3 uint8 .npy") + f", written in {secs:.3f} s: {why}")
        res["corpus_s"] = secs
        kernels.reset_launches()
        res["resnet"] = _etl_resnet(torch, np, card, root)
        res["lenet"] = _etl_lenet(torch, np, card)
        res["launches"] = kernels.launches()
    finally:
        shutil.rmtree(ETL_DIR, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t_phase
    log(f"[etl] phase seconds {res['seconds']:.1f}")
    return res


# -- the training tooling slice (ROADMAP A9) ---------------------------------------

# (a) the flagship: pretraining steps on one batch (numpy seed 0 ids), then
# the fine-tune's training and held-out batches of 4 x 2048 from the same
# generator; blocks 0-5 and the embedding frozen (layer 7 is block 5)
TOOLS_PRE_STEPS, TOOLS_FT_TRAIN, TOOLS_FT_HELD, TOOLS_FT_EPOCHS = 4, 8, 2, 3
TOOLS_FREEZE_AT, TOOLS_FT_LR = 7, 1e-4
# steps of each listener-cost run (with the four listeners, without them)
TOOLS_LISTENER_STEPS = 4
# (b) ResNet-50 frozen through its stage 2 (blocks s2b0 ... s2b5), a new
# 10-way head; 2 warm-up and 8 timed captured steps over 2 batches
TOOLS_RN_FREEZE, TOOLS_RN_CLASSES, TOOLS_RN_WARM, TOOLS_RN_TIMED = "s2b5_out", 10, 2, 8
# (c1) the chaos drill: one save at iteration 4 of the warm-up (at the
# default watchdog floor), warm-up steps after it so the watchdog's latency
# average settles, then the plan over 14 batches with floor 0.3 s and k 2
# (a deadline of ~0.5 s against a 2 s delay)
TOOLS_SAVE_AT, TOOLS_WARM_AFTER_SAVE, TOOLS_CHAOS_BATCHES = 4, 16, 14
TOOLS_CHAOS_PLAN = ("device.sync:delay:nth=3,secs=2;"
                    "data.decode:raise:nth=6,exc=runtime;"
                    "data.decode:corrupt:nth=9")
TOOLS_WD_FLOOR_S, TOOLS_WD_K = 0.3, 2.0
# (c2) a batch of 1024 images: 4x the 256 whose captured step reserves ~31 GiB
TOOLS_OOM_BATCH, TOOLS_OOM_MAX_SPLIT = 1024, 8
# (c3) the listener that sends SIGTERM fires at this step of the run
TOOLS_SIGTERM_AT = 2
TOOLS_DIR = os.path.join("build", "tools")   # inside the checkout; removed after


def _ft_batches(np, n, rng):
    from deeplearning4j_tpu_torch.data.dataset import DataSet

    out = []
    for _ in range(n):
        ids = rng.integers(0, VOCAB, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int64)
        out.append(DataSet(ids, np.roll(ids, -1, axis=1)))
    return out


def _copies(torch, tree):
    from deeplearning4j_tpu_torch.models.model import tree_leaves

    return [t.detach().clone() for t in tree_leaves(tree)]


def _timed_steps(torch, model, batches):
    """`fit_batch` over ``batches``: (each step's own loss tensor, ms a
    step over the run, the card synchronised at both ends)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = []
    for b in batches:
        model.fit_batch(b)
        losses.append(model._last_score.detach().clone())
    torch.cuda.synchronize()
    return losses, (time.perf_counter() - t0) / len(batches) * 1e3


def _tools_flagship(torch, np, kernels):
    """(a) The flagship fine-tuned through `TransferLearning` under
    `EarlyStoppingTrainer` with listeners."""
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    from deeplearning4j_tpu_torch.observe.health import HealthListener
    from deeplearning4j_tpu_torch.train import (
        CollectScoresListener, DataSetLossCalculator, EarlyStoppingConfiguration,
        EarlyStoppingTrainer, FineTuneConfiguration, InMemoryModelSaver,
        MaxEpochsTerminationCondition, PerformanceListener, ScoreIterationListener,
        ScoreImprovementEpochTerminationCondition, TransferLearning)

    res = {}
    rng = np.random.default_rng(0)
    pre = _ft_batches(np, 1, rng)[0]
    train = _ft_batches(np, TOOLS_FT_TRAIN, rng)
    held = _ft_batches(np, TOOLS_FT_HELD, rng)
    base = _flagship(torch)
    base.fit_batch(pre)                           # eager warm-up, then captured
    _, full_ms = _timed_steps(torch, base, [pre] * (TOOLS_PRE_STEPS - 1))
    res["full_step_ms"] = full_ms
    tl = (TransferLearning.Builder(base)
          .fine_tune_configuration(FineTuneConfiguration(updater=Adam(TOOLS_FT_LR)))
          .set_feature_extractor(TOOLS_FREEZE_AT).build())
    del base
    gc.collect()
    torch.cuda.empty_cache()
    frozen_keys = sorted(k for k in tl._frozen if k in tl.params)
    trained_keys = sorted(k for k in tl.params if k not in tl._frozen)
    frozen0 = _copies(torch, {k: tl.params[k] for k in frozen_keys})
    trained0 = _copies(torch, {k: tl.params[k] for k in trained_keys})
    log(f"[tools] (a) fine-tune: frozen {sorted(tl._frozen)}, trained {trained_keys}; "
        f"{len(tl._trainable_leaves(tl.params))} of "
        f"{len(_copies(torch, tl.params))} leaves trained")

    # the listeners' cost, and their neutrality, from one snapshot
    tl.fit_batch(train[0])                        # the fine-tune step's capture
    snap = _full_state(torch, tl)
    # each set from the same snapshot: none, the lazy ones (a score read
    # every 4th step), a score read every step, the health check alone,
    # all four
    sets = {
        "without": lambda: (),
        "lazy": lambda: (ScoreIterationListener(4), PerformanceListener()),
        "collect": lambda: (CollectScoresListener(),),
        "health": lambda: (HealthListener(frequency=1),),
        "with": lambda: (ScoreIterationListener(4), PerformanceListener(),
                         CollectScoresListener(), HealthListener(frequency=1)),
    }
    runs = {}
    for name, make in sets.items():
        _restore_state(torch, tl, snap)
        tl.set_listeners(*make())
        losses, ms = _timed_steps(torch, tl, train[1:1 + TOOLS_LISTENER_STEPS])
        runs[name] = {"losses": losses, "ms": ms}
        if name in ("without", "with"):
            runs[name]["state"] = _full_state(torch, tl, "cpu")
    same_losses = all(torch.equal(a, b) for a, b in
                      zip(runs["with"]["losses"], runs["without"]["losses"]))
    bad = _differing(torch, runs["with"]["state"], runs["without"]["state"])
    res["listeners"] = {"ms_with": runs["with"]["ms"], "ms_without": runs["without"]["ms"],
                        "ms_by_set": {k: v["ms"] for k, v in runs.items()},
                        "identical": same_losses and not bad}
    res["ft_step_ms"] = runs["without"]["ms"]
    res["ft_tokens_per_s"] = TRAIN_BATCH * TRAIN_SEQ / res["ft_step_ms"] * 1e3
    res["full_tokens_per_s"] = TRAIN_BATCH * TRAIN_SEQ / full_ms * 1e3
    log(f"[tools] (a) {TOOLS_LISTENER_STEPS} fine-tune steps from one snapshot: "
        f"{runs['without']['ms']:.3f} ms a step without listeners, "
        f"{runs['with']['ms']:.3f} with the four; by set "
        f"{ {k: round(v['ms'], 3) for k, v in runs.items()} }; losses identical "
        f"{same_losses}, state differs at {bad or 'no leaf'}")
    if not same_losses or bad:
        raise AssertionError("tools: the listeners changed the fine-tune's bits")
    del runs
    _restore_state(torch, tl, snap)
    del snap

    # the fine-tune under early stopping, counters zeroed just before
    class CountingLoss(DataSetLossCalculator):
        """The held-out loss, with the launches its scoring makes kept apart."""
        spent: dict = {}

        def calculate_score(self, model):
            c0 = kernels.launches()
            s = super().calculate_score(model)
            for k, v in kernels.launches().items():
                self.spent[k] = self.spent.get(k, 0) + v - c0.get(k, 0)
            return s

    calc = CountingLoss(held)
    collect, perf = CollectScoresListener(), PerformanceListener(frequency=8, warmup_iterations=2)
    health = HealthListener(frequency=1)
    tl.set_listeners(ScoreIterationListener(4), perf, collect, health)
    cfg = (EarlyStoppingConfiguration.builder().score_calculator(calc)
           .epoch_termination_conditions(MaxEpochsTerminationCondition(TOOLS_FT_EPOCHS),
                                         ScoreImprovementEpochTerminationCondition(1))
           .model_saver(InMemoryModelSaver()).build())
    it0, captures0 = tl.iteration, tl.compile_stats()["jit_cache_misses"]
    mem0 = _memory_window(torch)
    kernels.reset_launches()
    t0 = time.perf_counter()
    result = EarlyStoppingTrainer(cfg, tl, train).fit()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launches()
    memory = _memory_window(torch, mem0)
    steps = tl.iteration - it0
    per_step = {k: (counts.get(k, 0) - calc.spent.get(k, 0)) / steps
                for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv")}
    res["ft"] = {
        "launches": counts, "score_launches": dict(calc.spent), "steps": steps,
        "launches_per_step": per_step, "wall_s": wall,
        "perf_listener_samples_per_s": perf.samples_per_sec(),
        "reason": result.termination_reason.value, "details": result.termination_details,
        "best_epoch": result.best_model_epoch, "best_score": result.best_model_score,
        "total_epochs": result.total_epochs,
        "scores_by_epoch": {int(k): v for k, v in result.score_vs_epoch.items()},
        "peak_reserved_gib": memory["peak_gib"], "memory": memory,
        "captures": tl.compile_stats()["jit_cache_misses"] - captures0,
        "health": {"events": list(health.events), "global_norm": health.last_global_norm,
                   "update_norm": health.last_update_norm},
    }
    ft = res["ft"]
    log(f"[tools] (a) EarlyStoppingTrainer: {result.termination_reason.value} "
        f"({result.termination_details}) after {result.total_epochs} epochs, best epoch "
        f"{result.best_model_epoch} (held-out loss {result.best_model_score:.6f}); scores "
        f"by epoch {ft['scores_by_epoch']}; {steps} steps in {wall:.2f}s (held-out "
        f"scoring included; PerformanceListener {ft['perf_listener_samples_per_s']:.2f} "
        f"samples/s); fine-tune step {res['ft_step_ms']:.3f} ms = "
        f"{res['ft_tokens_per_s']:.1f} tokens/s against the full step {full_ms:.3f} ms = "
        f"{res['full_tokens_per_s']:.1f} tokens/s (ratio "
        f"{res['ft_step_ms'] / full_ms:.3f}); peak reserved "
        f"{memory['peak_gib']:.3f} GiB; launches {counts} (held-out scoring "
        f"{calc.spent}), a training step {per_step}; health norm "
        f"{health.last_global_norm}, |dw| {health.last_update_norm}, events "
        f"{len(health.events)}")
    # layers 0 and 1 are the embedding and the positions, layer i >= 2 is
    # block i - 2: every block runs B1, the blocks after the frozen ones B2/B3
    trained_blocks = LAYERS - (TOOLS_FREEZE_AT - 1)
    want = {"flash_fwd": LAYERS, "flash_bwd_dq": trained_blocks,
            "flash_bwd_dkdv": trained_blocks}
    if per_step != {k: float(v) for k, v in want.items()}:
        raise AssertionError(f"tools: launches a fine-tune step {per_step}, want {want}")
    if health.events or not all(np.isfinite([health.last_global_norm,
                                             health.last_update_norm])):
        raise AssertionError(f"tools: health events {health.events}")
    if ft["captures"]:
        raise AssertionError(f"tools: {ft['captures']} captures during the fine-tune")
    if not all(np.isfinite([s for _, s in collect.scores])):
        raise AssertionError("tools: a non-finite fine-tune loss")
    for a, b in zip(frozen0, _copies(torch, {k: tl.params[k] for k in frozen_keys})):
        if not torch.equal(a, b):
            raise AssertionError("tools: a frozen parameter changed its bits")
    moved = sum(not torch.equal(a, b) for a, b in
                zip(trained0, _copies(torch, {k: tl.params[k] for k in trained_keys})))
    if moved != len(trained0):
        raise AssertionError(f"tools: {len(trained0) - moved} trained leaves did not move")
    again = DataSetLossCalculator(held).calculate_score(result.best_model)
    log(f"[tools] (a) the best model scored again: {again!r} against the recorded "
        f"{result.best_model_score!r}; frozen leaves {len(frozen0)} kept their bits, "
        f"{moved} trained leaves moved")
    if again != result.best_model_score:
        raise AssertionError("tools: the best model does not score its recorded score")
    ft["best_rescored"] = again
    del result
    tl.set_listeners()
    gc.collect()
    res["captured_vs_eager"] = _captured_vs_eager(torch, tl, train[:2], "flagship fine-tune",
                                                  phase="tools", host=True)
    del tl
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _rn_batches(torch, np, classes, n=2):
    from deeplearning4j_tpu_torch.data.dataset import DataSet

    rng = np.random.default_rng(0)
    return [DataSet(torch.from_numpy(rng.normal(0, 1, (RESNET_BATCH, RESNET_HW, RESNET_HW, 3))
                                     .astype(np.float32)).cuda(),
                    torch.from_numpy(np.eye(classes, dtype=np.float32)[
                        rng.integers(0, classes, RESNET_BATCH)]).cuda()) for _ in range(n)]


def _tools_resnet_frozen(torch, np, report, base):
    """(b) ResNet-50 as a frozen feature extractor through stage 2."""
    from deeplearning4j_tpu_torch.train import TransferLearning

    res = {}
    rt = (TransferLearning.GraphBuilder(base).set_feature_extractor(TOOLS_RN_FREEZE)
          .n_out_replace("output", TOOLS_RN_CLASSES).build())
    batches = _rn_batches(torch, np, TOOLS_RN_CLASSES)
    frozen = sorted(k for k in rt._frozen if k in rt.params)
    bn = sorted(k for k in rt._frozen if k in rt.net_state)
    w0 = _copies(torch, {k: rt.params[k] for k in frozen})
    s0 = _copies(torch, {k: rt.net_state[k] for k in bn})
    losses, _ = _timed_steps(torch, rt, [batches[i % 2] for i in range(TOOLS_RN_WARM)])
    timed, ms = _timed_steps(torch, rt, [batches[i % 2] for i in range(TOOLS_RN_TIMED)])
    losses = [float(x) for x in losses + timed]
    kept = all(torch.equal(a, b) for a, b in
               zip(w0, _copies(torch, {k: rt.params[k] for k in frozen})))
    stats_moved = sum(not torch.equal(a, b) for a, b in
                      zip(s0, _copies(torch, {k: rt.net_state[k] for k in bn})))
    full = report.get("resnet", {}).get("ms_per_step")
    res.update({"ms_per_step": ms, "samples_per_s": RESNET_BATCH / ms * 1e3,
                "full_ms_per_step": full, "losses": losses,
                "frozen_layers": len(frozen), "frozen_bn_stats": len(s0),
                "bn_stats_moved": stats_moved, "frozen_kept": kept})
    log(f"[tools] (b) ResNet-50 frozen through {TOOLS_RN_FREEZE} ({len(frozen)} frozen "
        f"layers), a {TOOLS_RN_CLASSES}-way head: {ms:.3f} ms a step = "
        f"{res['samples_per_s']:.1f} samples/s (batch {RESNET_BATCH}), the resnet phase's "
        f"full step {full if full is None else round(full, 3)} ms; losses "
        f"{[round(x, 4) for x in losses]}; frozen weights kept their bits {kept}; "
        f"{stats_moved} of {len(s0)} frozen BatchNorm statistics moved")
    if not kept:
        raise AssertionError("tools: a frozen ResNet weight changed its bits")
    if stats_moved != len(s0):
        raise AssertionError("tools: frozen BatchNorm statistics did not move (JAX "
                             "updates them in training mode)")
    if not np.isfinite(losses).all() or not np.mean(losses[-2:]) < np.mean(losses[:2]):
        raise AssertionError(f"tools: the frozen ResNet's loss did not fall: {losses}")
    res["captured_vs_eager"] = _captured_vs_eager(torch, rt, batches, "ResNet-50 frozen",
                                                  phase="tools", host=True)
    del rt, batches
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _tools_chaos(torch, np, model, batches, store, root):
    """(c1) The chaos drill on the card: one save, the seeded plan, the
    recovery ledger."""
    from deeplearning4j_tpu_torch.observe.health import HealthListener
    from deeplearning4j_tpu_torch.observe.metrics import registry
    from deeplearning4j_tpu_torch.runtime import faults
    from deeplearning4j_tpu_torch.train import ModelSerializer, RecoveryPolicy
    from deeplearning4j_tpu_torch.train.listeners import TrainingListener

    res = {"saves": []}
    saved = {}

    class Saver(TrainingListener):
        def iteration_done(self, m, iteration, epoch, score):
            if iteration == TOOLS_SAVE_AT:
                t0 = time.perf_counter()
                store.save(m, step=iteration)
                res["saves"].append(time.perf_counter() - t0)
                saved["state"] = _full_state(torch, m, "cpu")

    model.set_listeners(Saver(), HealthListener(frequency=1, raise_on_divergence=True))
    policy = RecoveryPolicy(store, skip_window=1,
                            quarantine_dir=os.path.join(root, "quarantine")).attach(model)
    after_rollback = {}
    real_rollback = policy._rollback

    def timed_rollback(m, exc):
        t0 = time.perf_counter()
        real_rollback(m, exc)
        after_rollback["s"] = time.perf_counter() - t0
        after_rollback["state"] = _full_state(torch, m, "cpu")
        after_rollback["captures"] = m.compile_stats()["jit_cache_misses"]

    policy._rollback = timed_rollback
    warm = TOOLS_SAVE_AT + TOOLS_WARM_AFTER_SAVE
    model.fit([batches[i % len(batches)] for i in range(warm)])
    wd = model._watchdog
    wd.floor_s, wd.k = TOOLS_WD_FLOOR_S, TOOLS_WD_K
    log(f"[tools] (c1) warm-up {warm} steps (the save at {TOOLS_SAVE_AT}: "
        f"{res['saves'][0]:.2f}s); watchdog latency average {wd.ewma * 1e3:.2f} ms, "
        f"deadline now {wd.deadline_s():.3f}s")
    reg = registry()
    families = ("dl4jtpu_watchdog_stalls_total", "dl4jtpu_recovery_events_total",
                "dl4jtpu_quarantined_batches_total")
    before = {f: reg.counter(f).snapshot() for f in families}
    captures0 = model.compile_stats()["jit_cache_misses"]
    warm_iters = model.iteration
    t0 = time.perf_counter()
    faults.arm(TOOLS_CHAOS_PLAN)
    try:
        model.fit([batches[i % len(batches)] for i in range(TOOLS_CHAOS_BATCHES)])
    finally:
        faults.disarm()
    wall = time.perf_counter() - t0
    captures = model.compile_stats()["jit_cache_misses"] - captures0
    after = {f: reg.counter(f).snapshot() for f in families}
    rb = next((e for e in policy.events if e["kind"] == "rollback"), None)
    ledger = {
        "plan": TOOLS_CHAOS_PLAN, "total_batches": TOOLS_CHAOS_BATCHES,
        "final_iteration": int(model.iteration), "final_score": model.score_value,
        "rollbacks": policy.rollbacks, "quarantined": policy.quarantined,
        "lr_scale": policy.lr_scale,
        "steps_to_recover": (rb["from_iteration"] - rb["restored_iteration"]
                             + rb["skip_window"]) if rb else None,
        "recovered_step_fraction": round((model.iteration - warm_iters)
                                         / TOOLS_CHAOS_BATCHES, 3),
        "watchdog_events": [(e["stage"], e["stalled_s"]) for e in wd.events],
        "events": [e["kind"] for e in policy.events], "wall_s": wall,
        "captures": captures, "rollback_s": after_rollback.get("s"),
        "metrics": {f: {"before": before[f], "after": after[f]} for f in families},
    }
    path = store.path_for(TOOLS_SAVE_AT)
    t0 = time.perf_counter()
    ModelSerializer.verify(path)
    ledger["verify_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = ModelSerializer.restore(path, verify=False)
    torch.cuda.synchronize()
    ledger["restore_s"] = time.perf_counter() - t0
    ledger["save_s"] = res["saves"][0]
    del back
    gc.collect()
    torch.cuda.empty_cache()
    q = policy.quarantine.entries()
    ledger["quarantine"] = [{k: r[k] for k in ("reason", "has_bytes", "shapes", "path")}
                            for r in q]
    same = bool(rb) and not _differing(torch, saved["state"], after_rollback["state"])
    ledger["rollback_bits_equal"] = same
    ledger["captures_by_rollback_end"] = (after_rollback.get("captures", captures0)
                                          - captures0)
    res["ledger"] = ledger
    log(f"[tools] (c1) recovery ledger: {json.dumps({k: v for k, v in ledger.items() if k != 'metrics'}, default=str)}")
    log(f"[tools] (c1) metric families before -> after: {ledger['metrics']}")
    if policy.rollbacks != 1 or policy.lr_scale != 0.5:
        raise AssertionError(f"tools: rollbacks {policy.rollbacks}, lr_scale "
                             f"{policy.lr_scale}")
    if policy.quarantined != 1 or len(q) != 1 or not q[0]["has_bytes"] \
            or not os.path.exists(q[0]["path"].replace(".json", ".npz")):
        raise AssertionError(f"tools: the quarantine holds {q}")
    npz = np.load(q[0]["path"].replace(".json", ".npz"))
    if npz["features"].shape != (RESNET_BATCH, RESNET_HW, RESNET_HW, 3):
        raise AssertionError(f"tools: the quarantined bytes are {npz['features'].shape}")
    if "warn" not in [e["stage"] for e in wd.events]:
        raise AssertionError(f"tools: no watchdog warn: {wd.events}")
    if not np.isfinite(model.score_value):
        raise AssertionError("tools: the chaos run ended on a non-finite loss")
    if not same:
        raise AssertionError("tools: after the rollback the live state is not the "
                             "checkpoint's, bit for bit")
    if captures:
        raise AssertionError(f"tools: {captures} graph captures in the chaos run "
                             "(a rollback must install in place)")
    for f in families:
        if sum(after[f]["series"].values()) <= sum(before[f]["series"].values()):
            raise AssertionError(f"tools: {f} did not move: {after[f]}")
    policy.detach(model)
    return res


def _tools_oom(torch, np, model, batches):
    """(c2) A real device OOM split into microbatches."""
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.observe.health import HealthListener
    from deeplearning4j_tpu_torch.train import CollectScoresListener, RecoveryPolicy

    reps = TOOLS_OOM_BATCH // RESNET_BATCH
    big = DataSet(torch.cat([batches[i % len(batches)].features for i in range(reps)]),
                  torch.cat([batches[i % len(batches)].labels for i in range(reps)]))
    collect = CollectScoresListener()
    # the policy's raising health check, without the previous-parameters
    # copy it would keep (a parameter-sized buffer that is no OOM's leak)
    model.set_listeners(collect, HealthListener(frequency=1, track_updates=False))
    policy = RecoveryPolicy(None, max_split=TOOLS_OOM_MAX_SPLIT).attach(model)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    alloc0 = torch.cuda.memory_allocated()
    graphs0 = dict(model._captured)
    it0, captures0 = model.iteration, model.compile_stats()["jit_cache_misses"]
    t0 = time.perf_counter()
    model.fit([big])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_reserved() / 2**30
    gc.collect()
    torch.cuda.empty_cache()
    alloc1 = torch.cuda.memory_allocated()
    new_inputs = sum(t.numel() * t.element_size() for k, p in model._captured.items()
                     if k not in graphs0 for t in p.inputs if t is not None)
    factor, steps = policy.split_factor, model.iteration - it0
    scores = [s for _, s in collect.scores]
    captures = model.compile_stats()["jit_cache_misses"] - captures0
    # a following batch of 256, the policy detached (its split sticks for
    # the policy's fits), replays the model's graph
    policy.detach(model)
    c0 = model.compile_stats()["jit_cache_misses"]
    model.fit([batches[0]])
    replayed = model.compile_stats()["jit_cache_misses"] == c0
    res = {"split_factor": factor, "steps": steps, "losses": scores, "wall_s": wall,
           "peak_reserved_gib": peak, "allocated_before": alloc0,
           "allocated_after": alloc1, "new_graph_input_bytes": new_inputs,
           "captures": captures, "events": [e["kind"] for e in policy.events],
           "next_step_replayed": replayed}
    log(f"[tools] (c2) fit of one batch of {TOOLS_OOM_BATCH}: split factor {factor} "
        f"({steps} steps of {TOOLS_OOM_BATCH // max(factor, 1)}), losses "
        f"{[round(s, 5) for s in scores]}, {wall:.2f}s, peak reserved {peak:.3f} GiB; "
        f"allocated {alloc0 / 2**30:.3f} GiB before, {alloc1 / 2**30:.3f} after "
        f"(new step graph inputs {new_inputs / 2**30:.3f} GiB); {captures} captures; "
        f"a batch of {RESNET_BATCH} next replayed its graph {replayed}")
    if factor not in (2, 4) or steps != factor or "oom_split" not in res["events"]:
        raise AssertionError(f"tools: OOM split {factor}, {steps} steps, {res['events']}")
    if len(scores) != steps or not np.isfinite(scores).all():
        raise AssertionError(f"tools: the split's losses {scores}")
    if abs(alloc1 - alloc0 - new_inputs) > 0.05 * alloc0:
        raise AssertionError(f"tools: allocated {alloc1} after the OOM against {alloc0} "
                             f"before (+{new_inputs} of new graph inputs)")
    if not replayed:
        raise AssertionError("tools: the batch-256 step captured again after the OOM")
    model.set_listeners()
    del big
    return res


def _tools_sigterm(torch, np, model, batches, store):
    """(c3) A real SIGTERM: the preemption checkpoint, and the resume."""
    import signal

    from deeplearning4j_tpu_torch.train import PreemptionError, PreemptionHandler
    from deeplearning4j_tpu_torch.train.listeners import TrainingListener

    handler = PreemptionHandler(store).install()
    sent = {}

    class Kill(TrainingListener):
        def iteration_done(self, m, iteration, epoch, score):
            if iteration == it0 + TOOLS_SIGTERM_AT and not sent:
                sent["at"] = iteration
                os.kill(os.getpid(), signal.SIGTERM)

    it0 = model.iteration
    model.set_listeners(Kill(), handler.listener())
    raised = False
    t0 = time.perf_counter()
    try:
        model.fit([batches[i % len(batches)] for i in range(TOOLS_SIGTERM_AT + 3)])
    except PreemptionError:
        raised = True
    finally:
        handler.uninstall()
        model.set_listeners()
    save_s = time.perf_counter() - t0
    stopped = int(model.iteration)
    entry = store.latest_valid()
    nxt = batches[TOOLS_SIGTERM_AT % len(batches)]
    model.fit_batch(nxt)
    live_loss = model._last_score.detach().clone()
    model._drop_graphs()                         # its graph pool goes before the restore
    gc.collect()
    torch.cuda.empty_cache()
    back = store.restore_latest()
    back.capture_steps = False                   # eager: the captured step's bits
    back.fit_batch(nxt)
    back_loss = back._last_score.detach().clone()
    res = {"sent_at": sent.get("at"), "raised": raised, "saved_step": entry and entry["step"],
           "stopped_at": stopped, "save_and_stop_s": save_s,
           "live_loss": float(live_loss), "restored_loss": float(back_loss),
           "identical": bool(torch.equal(live_loss, back_loss))}
    log(f"[tools] (c3) SIGTERM sent at iteration {res['sent_at']}: PreemptionError "
        f"{raised}, checkpoint step {res['saved_step']} ({save_s:.2f}s to save and stop); "
        f"the next batch's loss {res['live_loss']!r} live, {res['restored_loss']!r} "
        f"restored: identical {res['identical']}")
    # the handler runs between bytecodes: the flag is seen at the listener
    # call after the kill, or a later one
    if (not raised or entry is None or entry["step"] != stopped
            or stopped < res["sent_at"]):
        raise AssertionError(f"tools: the SIGTERM run gave {res}")
    if not res["identical"]:
        raise AssertionError("tools: the restored model does not resume bit for bit")
    del back
    return res


def phase_tools(torch, np, kernels, report):
    """The training tooling slice (ROADMAP A9) on the card; see the module
    docstring."""
    from deeplearning4j_tpu_torch.train import CheckpointStore
    from deeplearning4j_tpu_torch.zoo.resnet import ResNet50

    t_phase = time.perf_counter()
    shutil.rmtree(TOOLS_DIR, ignore_errors=True)
    os.makedirs(TOOLS_DIR)
    crash_dir = os.environ.get("DL4JTPU_CRASH_DIR")
    os.environ["DL4JTPU_CRASH_DIR"] = os.path.join(TOOLS_DIR, "crash")
    res = {}
    try:
        res.update(_tools_flagship(torch, np, kernels))
        res["phase_a_s"] = time.perf_counter() - t_phase
        base = ResNet50().init_model()
        res["frozen_resnet"] = _tools_resnet_frozen(torch, np, report, base)
        batches = _rn_batches(torch, np, RESNET_CLASSES)
        store = CheckpointStore(os.path.join(TOOLS_DIR, "ckpt"), keep_last=2)
        res["chaos"] = _tools_chaos(torch, np, base, batches, store, TOOLS_DIR)
        res["oom"] = _tools_oom(torch, np, base, batches)
        res["sigterm"] = _tools_sigterm(torch, np, base, batches, store)
        del base, batches
    finally:
        if crash_dir is None:
            os.environ.pop("DL4JTPU_CRASH_DIR", None)
        else:
            os.environ["DL4JTPU_CRASH_DIR"] = crash_dir
        shutil.rmtree(TOOLS_DIR, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"[tools] phase {res['phase_s']:.1f}s")
    return res


# -- the recurrent slice (ROADMAP A8) -------------------------------------------

# BASELINE config 3 as bench.py's bench_lstm runs it (`bench.py:737-771`)
RNN_VOCAB, RNN_HIDDEN, RNN_SEQ, RNN_TBPTT = 77, 200, 200, 50
RNN_BATCH, RNN_SPE, RNN_WARM_GROUPS, RNN_GROUPS = 1024, 8, 2, 3
RNN_F32_BATCH = 64            # BASELINE round 3's batch, for the f32 run
RNN_PROMPTS, RNN_GEN = 8, 200  # greedy streams, characters a stream
RNN_TEXT = "SURVEY.md"        # the characters the char-RNN trains on
RNN_DIR = os.path.join("build", "rnn")   # inside the checkout; removed after
RNN_DM_SHAPES = [(RNN_F32_BATCH * RNN_SEQ, RNN_HIDDEN, RNN_VOCAB),
                 (RNN_PROMPTS, RNN_HIDDEN, RNN_VOCAB)]
# f32 card against f32 CPU (`tests/test_torch_recurrent.py`'s rules): losses
# within 1e-5 of max(1, |loss|); parameters after Adam steps all within a
# tenth of the learning rate and 99.9% within 1e-5 (Adam turns summation
# noise on a near-zero gradient into a step of up to the rate); outputs
# within 1e-5 of max p
RNN_LOSS_TOL, RNN_OUT_TOL, RNN_PARAM_TOL, RNN_PARAM_SHARE = 1e-5, 1e-5, 1e-5, 0.999


def _rnn_flops_by_hand(vocab, hidden, seq, n_layers=2) -> float:
    """`bench.py:127-135` `_lstm_fwd_flops`: forward FLOPs of one example
    of the char-RNN stack, counted by hand (gate width 4H): layer 0's
    input and recurrent products, each later layer's two, the head."""
    f = seq * (2 * vocab * 4 * hidden + 2 * hidden * 4 * hidden)
    f += (n_layers - 1) * seq * (2 * hidden * 4 * hidden) * 2
    f += seq * 2 * hidden * vocab
    return float(f)


def _rnn_text_ids(np):
    """The characters of ``RNN_TEXT`` as ids: its 76 most frequent
    characters 0-75 (by count, then code point), every other one 76."""
    import collections

    with open(RNN_TEXT, encoding="utf-8") as f:
        text = f.read()
    ranked = sorted(collections.Counter(text).items(), key=lambda kv: (-kv[1], kv[0]))
    table = {c: i for i, (c, _) in enumerate(ranked[:RNN_VOCAB - 1])}
    return np.array([table.get(c, RNN_VOCAB - 1) for c in text], np.int64)


def _rnn_batches(torch, np, ids, n, batch, seed, device=None):
    """``n`` batches of ``batch`` windows of RNN_SEQ + 1 characters drawn
    from ``ids`` (numpy seed ``seed``), one-hot features and next-character
    labels made on ``device``."""
    from deeplearning4j_tpu_torch.data.dataset import DataSet

    rng = np.random.default_rng(seed)
    eye = torch.eye(RNN_VOCAB, device=device or "cuda")
    out = []
    for _ in range(n):
        starts = rng.integers(0, len(ids) - RNN_SEQ - 1, batch)
        win = torch.from_numpy(ids[starts[:, None] + np.arange(RNN_SEQ + 1)]).to(device)
        out.append(DataSet(eye[win[:, :-1]], eye[win[:, 1:]]))
    return out


def _rnn_model(torch, bf16, device=None):
    import dataclasses

    from deeplearning4j_tpu_torch.models.sequential import SequentialModel
    from deeplearning4j_tpu_torch.zoo.textgen import TextGenerationLSTM

    conf = TextGenerationLSTM(vocab_size=RNN_VOCAB, hidden=RNN_HIDDEN,
                              tbptt_length=RNN_TBPTT).conf()
    if not bf16:
        conf = dataclasses.replace(conf, bf16_compute=False)
    return SequentialModel(conf, device=device or "cuda").init()


def _rnn_train(torch, np, kernels, ids, res):
    """(a) The char-RNN at full width, bf16: groups of RNN_SPE batches."""
    from deeplearning4j_tpu_torch.observe import cost
    from deeplearning4j_tpu_torch.runtime import compile_stats

    batches = _rnn_batches(torch, np, ids, RNN_SPE, RNN_BATCH, 0)
    model = _rnn_model(torch, True)
    windows = RNN_SEQ // RNN_TBPTT
    mem0 = _memory_window(torch)
    t0 = time.perf_counter()
    model.fit(batches, steps_per_execution=RNN_SPE)         # captures
    first = model._last_score.clone()
    for _ in range(RNN_WARM_GROUPS - 1):
        model.fit(batches, steps_per_execution=RNN_SPE)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    it0, cs0 = model.iteration, compile_stats.snapshot()
    losses = []
    t0 = time.perf_counter()
    for _ in range(RNN_GROUPS):
        model.fit(batches, steps_per_execution=RNN_SPE)
        losses.append(model._last_score)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    taxes = (compile_stats.snapshot() - cs0).as_dict()
    steps = model.iteration - it0
    memory = {"captured": _memory_window(torch, mem0)}
    # one more group with any host synchronisation an error
    torch.cuda.set_sync_debug_mode("error")
    try:
        model.fit(batches, steps_per_execution=RNN_SPE)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    losses.append(model._last_score)
    prof = _profiled(torch, "rnn", lambda: model.fit(
        batches, steps_per_execution=RNN_SPE))
    window_ms = secs / steps * 1e3
    batch_ms = window_ms * windows
    hand = 3 * _rnn_flops_by_hand(RNN_VOCAB, RNN_HIDDEN, RNN_SEQ) * RNN_BATCH
    peak_f, _ = cost.peaks()
    all_losses = torch.cat([first] + losses).float().cpu().numpy()
    res.update({
        "params": model.num_params(), "compute": str(model.compute_dtype),
        "window_ms": window_ms, "batch_ms": batch_ms,
        "samples_per_s": RNN_BATCH / batch_ms * 1e3,
        "chars_per_s": RNN_BATCH * RNN_SEQ / batch_ms * 1e3,
        "flops_per_batch_by_hand": hand, "mfu": hand / (batch_ms / 1e3) / peak_f,
        "steps_timed": steps, "warm_s": warm_s, "compile_taxes": taxes,
        "losses_first_group": all_losses[:RNN_SPE * windows].tolist(),
        "losses_last_group": all_losses[-RNN_SPE * windows:].tolist(),
        "memory": memory, "profile": {k: v for k, v in prof.items()
                                      if k != "all_device_kernels_ms"},
        "graphs": model.compile_stats()["step_programs"],
    })
    log(f"[rnn] (a) char-RNN {res['params']} params, batch {RNN_BATCH} x {RNN_SEQ}, "
        f"TBPTT {RNN_TBPTT}, spe {RNN_SPE}, {res['compute']}: {window_ms:.3f} ms a "
        f"window step, {batch_ms:.3f} ms a batch, {res['samples_per_s']:.1f} samples/s, "
        f"{res['chars_per_s']:.1f} chars/s; {hand:.4e} FLOPs a batch by hand, MFU "
        f"{res['mfu']:.5f} against {peak_f / 1e12:.0f} TFLOP/s "
        f"({torch.cuda.get_device_name(0)}); device busy "
        f"{prof['device_busy_share']:.3f}; {_memory_text(memory)}; warm-up "
        f"{warm_s:.1f}s; compile taxes of the timed groups {taxes}")
    log(f"[rnn] (a) losses: first group mean {all_losses[:RNN_SPE * windows].mean():.4f}, "
        f"last group mean {all_losses[-RNN_SPE * windows:].mean():.4f}")
    if not np.all(np.isfinite(all_losses)):
        raise AssertionError("char-RNN: a loss is not finite")
    if not all_losses[-RNN_SPE * windows:].mean() < all_losses[:RNN_SPE * windows].mean():
        raise AssertionError("char-RNN: the loss did not fall")
    if steps != RNN_GROUPS * RNN_SPE * windows:
        raise AssertionError(f"char-RNN: {steps} optimizer steps in {RNN_GROUPS} "
                             f"groups, want {windows} a batch")
    if taxes.get("fresh_backend_compiles") or taxes.get("jit_cache_misses"):
        raise AssertionError(f"char-RNN: the timed groups compiled or captured: {taxes}")
    if res["graphs"] != 1:
        raise AssertionError(f"char-RNN: {res['graphs']} step graphs, want 1")
    res["captured_vs_eager"] = _captured_vs_eager(torch, model, batches[:1],
                                                  "char-RNN batch", phase="rnn")
    return model, batches


def _rnn_f32(torch, np, ids, res):
    """(b) f32 on the card against the port on the CPU from the same seed:
    2 TBPTT batches of RNN_F32_BATCH, then a variable-length masked batch."""
    from deeplearning4j_tpu_torch.convert import params_to_numpy
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.models.sequential import tree_leaves

    card, cpu = _rnn_model(torch, False), _rnn_model(torch, False, "cpu")
    lr = card.conf.updater.learning_rate
    host = _rnn_batches(torch, np, ids, 2, RNN_F32_BATCH, 1, device="cpu")
    rng = np.random.default_rng(1)
    lengths = rng.integers(RNN_TBPTT // 2, RNN_SEQ + 1, RNN_F32_BATCH)
    mask = (np.arange(RNN_SEQ)[None, :] < lengths[:, None]).astype(np.float32)
    x3 = host[0].features * torch.from_numpy(mask)[..., None]
    host.append(DataSet(x3, host[1].labels, features_mask=mask, labels_mask=mask))
    losses = {"card": [], "cpu": []}
    for b in host:
        dev = DataSet(b.features.to("cuda"), b.labels.to("cuda"),
                      labels_mask=None if b.labels_mask is None else
                      torch.from_numpy(b.labels_mask).to("cuda"),
                      features_mask=None if b.features_mask is None else
                      torch.from_numpy(b.features_mask).to("cuda"))
        card.fit_batch(dev)
        cpu.fit_batch(b)
        losses["card"].extend(card._last_score.float().cpu().numpy().tolist())
        losses["cpu"].extend(cpu._last_score.float().numpy().tolist())
    lc, lp = np.array(losses["card"]), np.array(losses["cpu"])
    loss_err = float(np.max(np.abs(lc - lp) / np.maximum(1.0, np.abs(lp))))
    a = np.concatenate([np.asarray(v).ravel() for v in tree_leaves(params_to_numpy(card))])
    b = np.concatenate([np.asarray(v).ravel() for v in tree_leaves(params_to_numpy(cpu))])
    perr = np.abs(a - b)
    share = float(np.mean(perr <= RNN_PARAM_TOL))
    # output() of the masked batch on both, and the recurrent layers'
    # zeros at its masked steps
    xm = torch.from_numpy(mask)
    out_card = card.output(x3.to("cuda"), xm.to("cuda")).cpu()
    out_cpu = cpu.output(x3, xm)
    out_err = (out_card - out_cpu).abs().max().item() / out_cpu.abs().max().item()
    acts = card.feed_forward(x3.to("cuda"), xm.to("cuda"))
    masked = xm == 0
    zeros = all(bool((h.cpu()[masked] == 0).all()) for h in acts[:2])
    head_b = card.params["layer2"]["b"].detach().float()
    bias_rows = (out_card[masked] - torch.softmax(head_b, -1).cpu()).abs().max().item()
    res.update({"losses_card": lc.tolist(), "losses_cpu": lp.tolist(),
                "loss_rel_err": loss_err, "param_max_err": float(perr.max()),
                "param_share_within": share, "output_rel_err": out_err,
                "masked_steps": int(masked.sum()), "masked_hidden_zero": zeros,
                "masked_output_vs_softmax_bias": bias_rows})
    log(f"[rnn] (b) f32, batch {RNN_F32_BATCH}, 2 batches + a masked one ("
        f"{int(masked.sum())} masked steps): {len(lc)} window losses, card - cpu "
        f"{loss_err:.3e} of max(1, |loss|) (gate {RNN_LOSS_TOL:.0e}); parameters: "
        f"max |diff| {perr.max():.3e} (gate {lr / 10:.0e}), {share:.5f} within "
        f"{RNN_PARAM_TOL:.0e} (gate {RNN_PARAM_SHARE}); masked output() card - cpu "
        f"{out_err:.3e} of max p (gate {RNN_OUT_TOL:.0e}); hidden states zero at "
        f"masked steps: {zeros}; output() there is softmax(head bias) within "
        f"{bias_rows:.2e}")
    if (loss_err > RNN_LOSS_TOL or perr.max() > lr / 10 or share < RNN_PARAM_SHARE
            or out_err > RNN_OUT_TOL or not zeros or bias_rows > 1e-6):
        raise AssertionError("f32 char-RNN on the card disagrees with the CPU")
    return card


def _rnn_stream(torch, np, kernels, model, f32_model, ids, res):
    """(c) Greedy char-by-char generation through `rnn_time_step`, and
    streamed outputs against ``output()`` of the whole sequence."""
    eye = torch.eye(RNN_VOCAB, device="cuda")
    rng = np.random.default_rng(2)
    prompts = torch.from_numpy(ids[rng.integers(0, len(ids), RNN_PROMPTS)]).to("cuda")

    def generate(m):
        m.rnn_clear_previous_state()
        tok, outs = prompts, []
        for _ in range(RNN_GEN):
            p = m.rnn_time_step(eye[tok][:, None, :])
            tok = p[:, -1].argmax(-1)
            outs.append(tok)
        return torch.stack(outs, 1)

    generate(model)                      # captures the (8, 1, 77) step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    text = generate(model)
    torch.cuda.synchronize()
    ms_char = (time.perf_counter() - t0) / RNN_GEN * 1e3
    # streamed against whole: the f32 model, one step a call
    x = eye[torch.from_numpy(ids[:RNN_SEQ]).to("cuda")][None].repeat(2, 1, 1)
    whole = f32_model.output(x)
    f32_model.rnn_clear_previous_state()
    streamed = torch.cat([f32_model.rnn_time_step(x[:, t:t + 1])
                          for t in range(RNN_SEQ)], 1)
    err = (streamed - whole).abs().max().item() / whole.abs().max().item()
    bwhole = model.output(x)
    model.rnn_clear_previous_state()
    bstream = torch.cat([model.rnn_time_step(x[:, t:t + 1]) for t in range(RNN_SEQ)], 1)
    berr = (bstream - bwhole).abs().max().item() / bwhole.abs().max().item()
    res.update({"ms_per_char": ms_char, "streamed_vs_whole_f32": err,
                "streamed_vs_whole_bf16": berr,
                "sample": text[0, :60].cpu().numpy().tolist(),
                "rnn_graphs": len(model._rnn_graphs)})
    log(f"[rnn] (c) {RNN_PROMPTS} greedy streams x {RNN_GEN} chars: {ms_char:.4f} ms "
        f"a character (a replay a call, {len(model._rnn_graphs)} graph); streamed "
        f"{RNN_SEQ} steps against output() of the sequence: f32 {err:.3e} of max p "
        f"(gate {RNN_OUT_TOL:.0e}), bf16 {berr:.3e} (information)")
    if err > RNN_OUT_TOL:
        raise AssertionError("streamed outputs differ from the whole sequence's")


def _rnn_quant(torch, np, kernels, model, ids, res, timer):
    """(d) The quantized char-RNN: its head through B5 (the rows route:
    N 77 is no multiple of 16), against the f32 model of the same
    dequantized weights."""
    import dataclasses

    from deeplearning4j_tpu_torch.models.sequential import SequentialModel
    from deeplearning4j_tpu_torch.quant import dequantize_tree, quantize

    q = quantize(model)
    ref = SequentialModel(dataclasses.replace(model.conf, bf16_compute=False),
                          device="cuda").load_params(dequantize_tree(q.params))
    x = _rnn_batches(torch, np, ids, 1, RNN_F32_BATCH, 3)[0].features
    q.output(x)                                       # first use
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    p_q = q.output(x)
    torch.cuda.synchronize()
    out_ms = (time.perf_counter() - t0) * 1e3
    out_counts = dict(kernels.launches())
    p_ref = ref.output(x)
    dp = (p_q - p_ref).abs().max().item() / p_ref.abs().max().item()
    eye = torch.eye(RNN_VOCAB, device="cuda")
    tok = torch.from_numpy(ids[:RNN_PROMPTS]).to("cuda")
    q.rnn_clear_previous_state()
    ref.rnn_clear_previous_state()
    q.rnn_time_step(eye[tok][:, None])                # captures
    ref.rnn_time_step(eye[tok][:, None])
    torch.cuda.synchronize()
    kernels.reset_launches()
    sq, sr = [], []
    for _ in range(RNN_GEN):
        pq = q.rnn_time_step(eye[tok][:, None])
        sr.append(ref.rnn_time_step(eye[tok][:, None]))
        sq.append(pq)
        tok = pq[:, -1].argmax(-1)
    torch.cuda.synchronize()
    step_counts = dict(kernels.launches())
    sq, sr = torch.cat(sq, 1), torch.cat(sr, 1)
    sdp = (sq - sr).abs().max().item() / sr.abs().max().item()
    rows = check_rows("rnn", [dm_case(torch, timer, *shape) for shape in RNN_DM_SHAPES])
    res.update({"quant": {"launches": {"dequant_matmul": out_counts.get(
                    "dequant_matmul", 0)}, "output_ms": out_ms, "max_dp_rel": dp,
                    "all_launches": out_counts},
                "quant_stream": {"launches": {"dequant_matmul": step_counts.get(
                    "dequant_matmul", 0)}, "max_dp_rel": sdp,
                    "all_launches": step_counts}})
    tol = TOL["dequant_matmul/K1024"]
    log(f"[rnn] (d) quantized output() of {tuple(x.shape[:2])}: {out_ms:.3f} ms, "
        f"launches {out_counts}; vs the f32 model of the dequantized weights "
        f"{dp:.3e} of max p; {RNN_GEN} quantized rnn_time_step calls: launches "
        f"{step_counts}, {sdp:.3e} of max p (gate {tol:.0e} each)")
    if {k: v for k, v in out_counts.items() if v} != {"dequant_matmul": 1}:
        raise AssertionError(f"quantized output(): launches {out_counts}, want 1 B5")
    if {k: v for k, v in step_counts.items() if v} != {"dequant_matmul": RNN_GEN}:
        raise AssertionError(f"quantized streaming: launches {step_counts}, want "
                             f"{RNN_GEN} B5 (one a step)")
    if dp > tol or sdp > tol:
        raise AssertionError("the quantized char-RNN disagrees with its dequantized "
                             "f32 twin")
    return rows


def _rnn_ckpt(torch, np, model, batches, res):
    """(e) write_model, restore on the card, and one more batch on both:
    the same bits."""
    from deeplearning4j_tpu_torch.train.checkpoint import ModelSerializer

    path = os.path.join(RNN_DIR, "char_rnn.zip")
    t0 = time.perf_counter()
    ModelSerializer.write_model(model, path)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = ModelSerializer.restore(path)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    same = not _differing(torch, _full_state(torch, model), _full_state(torch, back))
    model.fit_batch(batches[1])
    back.fit_batch(batches[1])
    same_loss = torch.equal(model._last_score, back._last_score)
    after = _differing(torch, _full_state(torch, model), _full_state(torch, back))
    res["ckpt"] = {"bytes": os.path.getsize(path), "write_s": write_s,
                   "restore_s": restore_s, "restored_identical": same,
                   "resumed_identical": same_loss and not after}
    log(f"[rnn] (e) zip {os.path.getsize(path)} bytes, write {write_s:.2f}s, restore "
        f"{restore_s:.2f}s; restored state identical: {same}; one more batch on "
        f"both: losses identical {same_loss}, state differs at {after or 'no leaf'}")
    if not same or not same_loss or after:
        raise AssertionError("the char-RNN zip does not resume bit for bit")


def _rnn_small(torch, np, res):
    """(f) The other recurrent layers at small widths, f32: a captured
    step against the eager one, and ``output()`` against the CPU."""
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.models.sequential import SequentialModel
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.conf import recurrent as R
    from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
    from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.updaters import Adam

    head = L.OutputLayer(n_out=3, loss="mcxent", activation="softmax")
    cases = {
        "LSTM": ([R.LSTM(n_out=32), R.LastTimeStep(), head], InputType.recurrent(8)),
        "GRU": ([R.GRU(n_out=32), R.LastTimeStep(), head], InputType.recurrent(8)),
        "SimpleRnn": ([R.SimpleRnn(n_out=32), R.LastTimeStep(), head],
                      InputType.recurrent(8)),
        "Bidirectional": ([R.Bidirectional(layer=R.LSTM(n_out=16), mode="concat"),
                           R.LastTimeStep(), head], InputType.recurrent(8)),
        "TimeDistributed": ([R.TimeDistributed(layer=L.Dense(n_out=16, activation="relu")),
                             R.GRU(n_out=16), R.LastTimeStep(), head],
                            InputType.recurrent(8)),
        "ConvLSTM2D": ([R.ConvLSTM2D(n_out=8, kernel=(3, 3), padding="same"),
                        L.GlobalPooling(), head], InputType.convolutional3d(6, 12, 12, 3)),
    }
    rng = np.random.default_rng(4)
    out = {}
    for name, (layers, itype) in cases.items():
        b = NeuralNetConfiguration.builder().seed(5).updater(Adam(1e-3)).bf16_compute(False)
        for layer in layers:
            b = b.layer(layer)
        conf = b.set_input_type(itype).build()
        shape = ((16, 24, 8) if itype.kind == "rnn" else (4,) + tuple(itype.shape))
        x = rng.normal(size=shape).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, shape[0])]
        mask = None
        if name in ("LSTM", "Bidirectional"):
            mask = (np.arange(24)[None, :] < rng.integers(6, 25, 16)[:, None]
                    ).astype(np.float32)
        card = SequentialModel(conf, device="cuda").init()
        cpu = SequentialModel(conf, device="cpu").init()
        xm = None if mask is None else torch.from_numpy(mask)
        xc = torch.from_numpy(x).to("cuda")
        oc = card.output(xc, None if xm is None else xm.to("cuda")).cpu()
        op = cpu.output(torch.from_numpy(x), xm)
        err = (oc - op).abs().max().item() / op.abs().max().item()
        dev = [DataSet(xc, torch.from_numpy(y).to("cuda"),
                       features_mask=None if xm is None else xm.to("cuda"))
               for _ in range(2)]
        card.fit_batch(dev[0])                          # captures
        cve = _captured_vs_eager(torch, card, dev[1:], name, phase="rnn")
        out[name] = {"output_rel_err": err, "captured_vs_eager": cve["identical"]}
        log(f"[rnn] (f) {name}: f32 output() card - cpu {err:.3e} of max p "
            f"(gate {RNN_OUT_TOL:.0e}); captured step == eager")
        if err > RNN_OUT_TOL:
            raise AssertionError(f"{name}: the card's output() differs from the CPU's")
    res["small"] = out


def phase_rnn(torch, np, kernels, timer):
    """The recurrent slice (ROADMAP A8) on the card; see the module
    docstring."""
    t_phase = time.perf_counter()
    shutil.rmtree(RNN_DIR, ignore_errors=True)
    os.makedirs(RNN_DIR)
    res = {}
    try:
        ids = _rnn_text_ids(np)
        res["text_chars"] = len(ids)
        model, batches = _rnn_train(torch, np, kernels, ids, res)
        res["phase_a_s"] = time.perf_counter() - t_phase
        f32 = _rnn_f32(torch, np, ids, res)
        _rnn_stream(torch, np, kernels, model, f32, ids, res)
        del f32
        res["kernel_rows"] = _rnn_quant(torch, np, kernels, model, ids, res, timer)
        _rnn_ckpt(torch, np, model, batches, res)
        del model, batches
        gc.collect()
        torch.cuda.empty_cache()
        _rnn_small(torch, np, res)
    finally:
        shutil.rmtree(RNN_DIR, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"[rnn] phase {res['phase_s']:.1f}s")
    return res


# -- data parallelism (ROADMAP A11, first part) ------------------------------------

# (a) BASELINE config 5 through bench_scaling (`bench.py:1133-1240`): the
# zoo's ResNet-50, 1000 classes, a per-card batch of 128 at 224 x 224 x 3,
# bf16, Adam 1e-3, `steps_per_execution` 16; 2 batches staged on the card
DP_BATCH, DP_BATCHES, DP_SPE, DP_GROUPS, DP_EAGER_GROUPS = 128, 2, 16, 2, 1
DP_HW, DP_CLASSES = 224, 1000
# (b) two gloo ranks on the one card: ResNet-50 in f32, 64 rows a rank, 3
# steps.  Nesterovs, not Adam: a conv bias before a BatchNorm has a zero
# exact gradient, and Adam turns its summation noise into rate-sized
# steps that differ between any two summation orders (PR 14's finding).
# Two rates.  The two ranks against the single model step at 1e-6:
# ResNet-50's f32 gradient at random init is ill-conditioned (BatchNorm's
# backward subtracts near-equal means): the same model's gradient on the
# same 128 rows through cuDNN and through PyTorch's native convolutions
# differs by 2.2% (relative L2), and two ranks' sum against the single
# model by 1.9% (on an H100 80GB HBM3).  At 1e-2 and 1e-4 that noise moved
# parameters by 0.059 and 3.7e-4 in 3 steps; at 1e-6 it stays below
# rounding of the update, so those 3 steps test the forward, the
# statistics and the update, and the gradient is held against its own
# floor below.  ZeRO and int8 share the two ranks' summed gradient with
# the replicated run, so they are held against a replicated run at 1e-2,
# whose last loss must lie farther than the JAX compression rule's 0.05
# from the 1e-6 run's (so a run that never updates fails that rule):
# ZeRO-1 and ZeRO-2 bit for bit, ZeRO-2 with 2 microbatches and int8 by
# that rule
# 2 steps a run, cut for the script's time limit (at 3 steps dp ran
# 137.6-156.8 s, its gloo ranks 63.3-67.9 s)
DP_GLOO_ROWS, DP_GLOO_STEPS = 64, 2
DP_GLOO_LR, DP_GLOO_LR_ZERO = 1e-6, 1e-2
# the first step's summed gradient against the single model's (relative
# L2 of the flat gradient) may not exceed twice the larger of two floors
# the same run measures: the single model's gradient through native
# convolutions against cuDNN's, and on its rows with the two halves
# swapped (the same function summed in other orders)
DP_GRAD_FLOOR_X = 2.0
# the JAX compression rule: within 0.05 of the exact run's score
DP_COMP_GAP = 0.05
DP_DIR = os.path.join("build", "dp")      # inside the checkout; removed after


def _dp_groups(torch, fit, batches, groups, spe):
    """``groups`` groups of ``spe`` steps over ``batches`` cycled through
    ``fit(group)``; each group's losses (on the card)."""
    out = []
    for g in range(groups):
        group = [batches[(g * spe + i) % len(batches)] for i in range(spe)]
        out.append(fit(group))
    return out


def _dp_timed(torch, model, fit, batches, warm, groups, spe, quiet=False):
    """``warm`` untimed groups, then ``groups`` timed ones (the card
    synchronised at both ends): (every loss, ms a step, what the timed
    groups captured and compiled).  ``quiet``: the timed groups run with
    any host synchronisation an error."""
    from deeplearning4j_tpu_torch.runtime import compile_stats

    losses = _dp_groups(torch, fit, batches, warm, spe)
    torch.cuda.synchronize()
    snap = compile_stats.snapshot()
    if quiet:
        torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        losses += _dp_groups(torch, fit, batches, groups, spe)
        if quiet:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode(0)
    taxes = (compile_stats.snapshot() - snap).as_dict()
    ls = torch.cat([x.reshape(-1) for x in losses]).float().cpu().numpy()
    return ls, secs / (groups * spe) * 1e3, taxes


def _dp_resnet_batches(torch, np, rows, seed=0):
    from deeplearning4j_tpu_torch.data.dataset import DataSet

    rng = np.random.default_rng(seed)
    return [DataSet(torch.from_numpy(rng.normal(0, 1, (rows, DP_HW, DP_HW, 3))
                                     .astype(np.float32)).to("cuda"),
                    torch.from_numpy(np.eye(DP_CLASSES, dtype=np.float32)[
                        rng.integers(0, DP_CLASSES, rows)]).to("cuda"))
            for _ in range(DP_BATCHES)]


def _dp_state_gap(torch, a, b) -> float:
    """Max |a - b| over the parameter and layer-state leaves of two models,
    relative to each leaf's largest element."""
    from deeplearning4j_tpu_torch.models.model import tree_leaves

    gap = 0.0
    for x, y in zip(tree_leaves(a.params) + tree_leaves(a.net_state),
                    tree_leaves(b.params) + tree_leaves(b.net_state)):
        d = (x.detach().float() - y.detach().float()).abs().max().item()
        gap = max(gap, d / max(y.detach().float().abs().max().item(), 1e-30))
    return gap


def _dp_reduce_scatter_probe(torch, rank, n) -> dict:
    """Whether this torch's NCCL takes ``reduce_scatter_tensor`` without a
    warning, and whether ``reduce_scatter_single`` (its name from torch
    2.13 on) exists: the ZeRO step all-reduces instead (`parallel/
    zero.py`)."""
    import warnings

    import torch.distributed as dist

    x = torch.arange(4 * n, dtype=torch.float32, device="cuda")
    out = torch.empty(4, dtype=torch.float32, device="cuda")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        dist.reduce_scatter_tensor(out, x)
    return {"torch": torch.__version__, "warnings": [str(w.message) for w in caught],
            "right": bool(torch.equal(out, x[rank * 4:(rank + 1) * 4] * n)),
            "has_reduce_scatter_single": hasattr(dist, "reduce_scatter_single")}


def _dp_rank_nccl():
    """(a) and (c) on one NCCL rank a visible card; see the module
    docstring."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.models.model import tree_leaves
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    from deeplearning4j_tpu_torch.runtime import distributed, kernels
    from deeplearning4j_tpu_torch.zoo.resnet import ResNet50

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, n = distributed.process_index(), distributed.process_count()
    res = {"rank": rank, "world": n, "backend": distributed.backend_name(),
           "card": torch.cuda.get_device_name(), "device": str(distributed.device()),
           "reduce_scatter": _dp_reduce_scatter_probe(torch, rank, n)}
    batches = _dp_resnet_batches(torch, np, DP_BATCH, seed=rank)

    def fit_of(model):
        def fit(group):
            model.fit(group, steps_per_execution=len(group))
            return model._last_score.reshape(-1)
        return fit

    # the undistributed model and the world's replica from the same seed:
    # two captured steps each on the same batches
    base = ResNet50().init_model()
    dp = ResNet50().init_model()
    pw = ParallelWrapper(dp)
    lb, ld = [], []
    for b in batches:
        base.fit_batch(b)
        pw.fit([b])
        lb.append(base.score_value)
        ld.append(dp.score_value)
    gap = _dp_state_gap(torch, dp, base)
    res["world_of_one"] = {"base_losses": lb, "dp_losses": ld, "state_gap": gap}
    # each model's memory measured alone: the replica's graph is captured
    # again in its warm-up group
    dp._drop_graphs()
    # the undistributed model: captured, then eager
    mem0 = _memory_window(torch)
    b_loss, b_ms, b_tax = _dp_timed(torch, base, fit_of(base), batches, 1, DP_GROUPS,
                                    DP_SPE)
    mem = {"base_captured": _memory_window(torch, mem0)}
    base.capture_steps = False
    _, b_eager_ms, _ = _dp_timed(torch, base, fit_of(base), batches, 0, DP_EAGER_GROUPS,
                                 DP_SPE)
    del base
    gc.collect()
    torch.cuda.empty_cache()
    # the data-parallel model: captured (no host sync in the timed groups),
    # eager, then 2 captured against 2 eager steps from one snapshot
    mem0 = _memory_window(torch)
    def fit_pw(group):
        pw.fit(group, steps_per_execution=len(group))
        return dp._last_score.reshape(-1)

    d_loss, d_ms, d_tax = _dp_timed(torch, dp, fit_pw, batches, 1, DP_GROUPS, DP_SPE,
                                    quiet=True)
    mem["dp_captured"] = _memory_window(torch, mem0)
    dp.capture_steps = False
    _, d_eager_ms, _ = _dp_timed(torch, dp, fit_of(dp), batches, 0, DP_EAGER_GROUPS, DP_SPE)
    dp.capture_steps = True
    res["captured_vs_eager"] = _captured_vs_eager(torch, dp, batches, "ResNet-50 DP",
                                                  phase=f"dp/rank{rank}", host=True)

    def group():
        fit_of(dp)(batches * (DP_SPE // len(batches)))

    prof = _profiled(torch, f"dp_resnet_rank{rank}", group)
    nccl = [(ms, c) for k, ms, c in prof["all_device_kernels_ms"] if "nccl" in k.lower()]
    nccl, prof["nccl_launches"] = sum(m for m, _ in nccl), sum(c for _, c in nccl)
    prof["nccl_device_ms"] = nccl
    prof["nccl_share_of_device"] = nccl / max(prof["device_busy_s"] * 1e3, 1e-9)
    prof.pop("all_device_kernels_ms")
    # every rank fed its own rows: the replicas stay equal only if each
    # step applied the same exchanged gradient and global statistics
    res["digest"] = _dp_digest(torch, tree_leaves(dp.params) + tree_leaves(dp.net_state))
    res["resnet"] = {
        "ms_per_step": d_ms, "samples_per_s": DP_BATCH / d_ms * 1e3,
        "eager_ms_per_step": d_eager_ms, "eager_samples_per_s": DP_BATCH / d_eager_ms * 1e3,
        "base_ms_per_step": b_ms, "base_samples_per_s": DP_BATCH / b_ms * 1e3,
        "base_eager_ms_per_step": b_eager_ms, "memory": mem, "timed_taxes": d_tax,
        "base_timed_taxes": b_tax, "first_group_mean": float(d_loss[:DP_SPE].mean()),
        "last_group_mean": float(d_loss[-DP_SPE:].mean()),
        "base_first_group_mean": float(b_loss[:DP_SPE].mean()),
        "finite": bool(np.isfinite(d_loss).all() and np.isfinite(b_loss).all()),
        "profile": prof}
    del dp, pw, batches
    gc.collect()
    torch.cuda.empty_cache()
    res["flagship"] = _dp_flagship(torch, np, kernels)
    return res


def _dp_flagship(torch, np, kernels):
    """(c) The flagship through `ParallelWrapper` on this rank: B1-B3
    launches a step, captured against eager, tokens/s beside the
    undistributed step."""
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper

    batch = _train_batch(np)
    base = _flagship(torch)
    for _ in range(TRAIN_WARMUP):
        base.fit_batch(batch)
    _, base_ms = _timed_steps(torch, base, [batch] * TRAIN_STEPS)
    del base
    gc.collect()
    torch.cuda.empty_cache()
    model = _flagship(torch)
    pw = ParallelWrapper(model)
    for _ in range(TRAIN_WARMUP):
        pw.fit([batch])
    torch.cuda.synchronize()
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = []
    for _ in range(TRAIN_STEPS):
        pw.fit([batch])
        losses.append(model._last_score.detach().clone())
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
    counts = kernels.launches()
    cve = _captured_vs_eager(torch, model, [batch, batch], "flagship DP", phase="dp",
                             host=True)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    out = {"ms_per_step": ms, "tokens_per_s": tokens / ms * 1e3,
           "base_ms_per_step": base_ms, "base_tokens_per_s": tokens / base_ms * 1e3,
           "losses": [float(x) for x in losses], "launches": counts,
           "steps": TRAIN_STEPS, "captured_vs_eager": cve,
           "graphs": model.compile_stats()["step_programs"]}
    del model, pw
    gc.collect()
    torch.cuda.empty_cache()
    return out


class _native_convolutions:
    """PyTorch's own CUDA convolutions instead of cuDNN's inside the port's
    convolution windows (`ops/conv.py` `_exact`), for a second summation
    order of the same function."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        import contextlib

        from deeplearning4j_tpu_torch.ops import conv

        torch = self.torch
        self.conv, self.real = conv, conv._exact

        @contextlib.contextmanager
        def native(device):
            with torch.backends.cudnn.flags(enabled=False):
                yield

        conv._exact = native
        return self

    def __exit__(self, *exc):
        self.conv._exact = self.real
        return False


def _dp_digest(torch, tensors) -> str:
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _dp_rank_gloo(zip_path):
    """(b) on one of two gloo ranks sharing the card; see the module
    docstring."""
    import dataclasses

    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.models.computation_graph import GraphModel
    from deeplearning4j_tpu_torch.models.model import tree_leaves
    from deeplearning4j_tpu_torch.nn.updaters import Nesterovs, state_leaves
    from deeplearning4j_tpu_torch.parallel import ParallelConfig, distribute
    from deeplearning4j_tpu_torch.parallel.zero import opt_state_bytes_per_replica
    from deeplearning4j_tpu_torch.runtime import distributed
    from deeplearning4j_tpu_torch.train.checkpoint import ModelSerializer
    from deeplearning4j_tpu_torch.zoo.resnet import ResNet50

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, n = distributed.process_index(), distributed.process_count()
    conf0 = dataclasses.replace(ResNet50().conf(), bf16_compute=False)
    conf = dataclasses.replace(conf0, updater=Nesterovs(DP_GLOO_LR, 0.9))
    rng = np.random.default_rng(1)
    rows = DP_GLOO_ROWS * n
    host = [(rng.normal(0, 1, (rows, DP_HW, DP_HW, 3)).astype(np.float32),
             np.eye(DP_CLASSES, dtype=np.float32)[rng.integers(0, DP_CLASSES, rows)])
            for _ in range(DP_GLOO_STEPS)]
    mine = [DataSet(torch.from_numpy(x[rank * DP_GLOO_ROWS:(rank + 1) * DP_GLOO_ROWS]).to("cuda"),
                    torch.from_numpy(y[rank * DP_GLOO_ROWS:(rank + 1) * DP_GLOO_ROWS]).to("cuda"))
            for x, y in host]
    res = {"rank": rank, "backend": distributed.backend_name()}

    def run(cfg, lr, grads=False):
        """3 steps of a fresh replica at rate ``lr``: (model, losses, ms of
        the first step, ms a step after it, the first step's summed
        gradient)."""
        m = GraphModel(dataclasses.replace(conf0, updater=Nesterovs(lr, 0.9)),
                       device="cuda").init()
        distribute(m, ParallelConfig(**cfg))
        flat = None
        if grads:
            # the exchange alone, before any update: the world's summed
            # gradient of the first batch
            _, g, *_ = m._dp_grads(m._step_program(), m.params,
                                   m._batch_arrays(m._as_batch(mine[0])), m._step_keys(0))
            flat = torch.cat([x.reshape(-1) for x in g])
        times, losses = [], []
        for b in mine:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m.fit_batch(b)
            losses.append(m.score_value)
            times.append((time.perf_counter() - t0) * 1e3)
        return m, losses, times[0], statistics.mean(times[1:]), flat

    def state(m):
        return tree_leaves(m.params) + tree_leaves(m.net_state)

    def entry(m, losses, first_ms, ms):
        return {"losses": losses, "ms_per_step": ms, "first_step_ms": first_ms,
                "opt_bytes": opt_state_bytes_per_replica(m.opt_state),
                "digest": _dp_digest(torch, state(m))}

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    # the replicated run at each rate; the 1e-6 one is held against the
    # single model below, the 1e-2 one against ZeRO and int8
    rep, losses, first_ms, ms, dp_grad = run({}, DP_GLOO_LR, grads=True)
    res["replicated"] = entry(rep, losses, first_ms, ms)
    res["replicated"]["capture"] = rep.capture_steps
    ref = [t.detach().clone() for t in state(rep)]
    del rep
    free()
    p0 = [t.detach().clone() for t in tree_leaves(
        GraphModel(conf0, device="cuda").init().params)]
    rep, losses, first_ms, ms, _ = run({}, DP_GLOO_LR_ZERO)
    res["replicated_lr2"] = entry(rep, losses, first_ms, ms)
    step_ref = torch.cat([(a.detach() - b).reshape(-1)
                          for a, b in zip(tree_leaves(rep.params), p0)])
    del rep
    free()

    def held(m, ref, rtol=2e-4, atol=2e-5):
        """Elements of m's parameters and layer state outside rtol / atol of
        ``ref``, and the largest relative gap."""
        bad, worst = 0, 0.0
        for x, y in zip(state(m), ref):
            d = (x.detach() - y).abs()
            bad += int((d > atol + rtol * y.abs()).sum().item())
            worst = max(worst, (d / (y.abs() + atol)).max().item())
        return bad, worst

    for tag, cfg in (("zero1", dict(zero=1)), ("zero2", dict(zero=2)),
                     ("zero2_accum2", dict(zero=2, grad_accum=2)),
                     ("int8", dict(grad_compression="int8"))):
        m, losses, first_ms, ms, _ = run(cfg, DP_GLOO_LR_ZERO)
        res[tag] = entry(m, losses, first_ms, ms)
        step = torch.cat([(a.detach() - b).reshape(-1)
                          for a, b in zip(tree_leaves(m.params), p0)])
        # the parameters' change against the replicated run's at 1e-2
        res[tag]["step_rel_l2"] = ((step - step_ref).norm() / step_ref.norm()).item()
        del step
        if tag == "zero1":
            ModelSerializer.write_model_distributed(m, zip_path)
            full = m._zero_placement.gather_state(m.opt_state)
            res[tag]["opt_digest"] = _dp_digest(
                torch, [t for t in state_leaves(full) if isinstance(t, torch.Tensor)])
            res[tag]["iteration"] = m.iteration
        del m
        free()
    if rank == 0:
        # the single model on the concatenation of the ranks' rows: its
        # first gradient against the ranks' sum, and the gradient's own
        # rounding floors
        single = GraphModel(conf, device="cuda").init()
        x0, y0 = (torch.from_numpy(a).to("cuda") for a in host[0])
        h = DP_GLOO_ROWS

        def grad(x, y):
            b = single._as_batch(DataSet(x, y))
            _, g, *_ = single._grad_step(single.params, single.net_state,
                                         *single._batch_arrays(b), single._layer_keys(0))
            return torch.cat([t.reshape(-1) for t in g])

        def rel(a, b):
            return ((a - b).norm() / b.norm()).item()

        g = grad(x0, y0)
        grad_rel = rel(dp_grad, g)
        swapped = rel(grad(torch.cat([x0[h:], x0[:h]]), torch.cat([y0[h:], y0[:h]])), g)
        with _native_convolutions(torch):
            native = rel(grad(x0, y0), g)
        del g, x0, y0
        losses = []
        for x, y in host:
            single.fit_batch(DataSet(torch.from_numpy(x).to("cuda"), torch.from_numpy(y).to("cuda")))
            losses.append(single.score_value)
        bad, worst = held(single, ref)
        res["single"] = {"losses": losses, "outside_tol": bad, "worst_rel": worst,
                         "grad_rel_l2": grad_rel, "floor_swapped": swapped,
                         "floor_native": native,
                         "max_abs": max((a.detach() - b).abs().max().item() for a, b in zip(
                             tree_leaves(single.params) + tree_leaves(single.net_state), ref))}
        del single
    return res


def phase_dp(torch, np, kernels):
    """Data parallelism (ROADMAP A11, first part) on the card; see the
    module docstring."""
    from deeplearning4j_tpu_torch.models.model import tree_leaves
    from deeplearning4j_tpu_torch.nn.updaters import state_leaves
    from deeplearning4j_tpu_torch.runtime import distributed
    from deeplearning4j_tpu_torch.train.checkpoint import ModelSerializer

    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    shutil.rmtree(DP_DIR, ignore_errors=True)
    os.makedirs(DP_DIR)
    zip_path = os.path.join(DP_DIR, "zero1.zip")
    # nothing of an earlier phase may hold the card's memory meanwhile
    gc.collect()
    torch.cuda.empty_cache()
    res = {"cards": cards}
    try:
        t0 = time.perf_counter()
        nccl = distributed.spawn(_dp_rank_nccl, cards, timeout=900)
        res["nccl_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        gloo = distributed.spawn(_dp_rank_gloo, 2, zip_path, backend="gloo", timeout=600)
        res["gloo_s"] = time.perf_counter() - t0
        restored = ModelSerializer.restore(zip_path, device="cuda")
        res["zip_bytes"] = os.path.getsize(zip_path)
        res["zip_digest"] = _dp_digest(torch, tree_leaves(restored.params)
                                       + tree_leaves(restored.net_state))
        res["zip_opt_digest"] = _dp_digest(torch, [
            t for t in state_leaves(restored.opt_state) if isinstance(t, torch.Tensor)])
        res["zip_iteration"] = restored.iteration
        del restored
    finally:
        shutil.rmtree(DP_DIR, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    res["nccl"], res["gloo"] = nccl, gloo
    a = nccl[0]
    rn, fl = a["resnet"], a["flagship"]
    # the kernels line reads the flagship's counts under "dp/flagship"
    res["flagship"] = fl
    log(f"[dp] {cards} card(s) visible: {cards} NCCL rank(s), one a card "
        f"({a['card']}); the numbers below are rank 0's")
    log(f"[dp] (a) NCCL reduce_scatter_tensor on torch {a['reduce_scatter']['torch']}: "
        f"right {a['reduce_scatter']['right']}, warnings "
        f"{a['reduce_scatter']['warnings']}; reduce_scatter_single exists: "
        f"{a['reduce_scatter']['has_reduce_scatter_single']}")
    w1 = a["world_of_one"]
    if cards == 1:
        log(f"[dp] (a) world of one against the undistributed ResNet-50: losses "
            f"{w1['dp_losses']} against {w1['base_losses']}; parameters and BatchNorm "
            f"state max gap {w1['state_gap']:.3e} of each leaf's largest element")
    else:
        log(f"[dp] (a) world of {cards}: rank 0's first losses {w1['dp_losses']}; "
            f"samples/s of the world {sum(r['resnet']['samples_per_s'] for r in nccl):.1f} "
            f"(each rank {DP_BATCH} rows a step, its own); the ranks' parameters and "
            f"BatchNorm state bit-identical after the timed groups: "
            f"{len({r['digest'] for r in nccl}) == 1}")
    log(f"[dp] (a) ResNet-50 bf16 at {DP_BATCH} a rank, steps_per_execution {DP_SPE}: "
        f"DP captured {rn['ms_per_step']:.3f} ms a step = {rn['samples_per_s']:.1f} "
        f"samples/s a rank, eager {rn['eager_ms_per_step']:.3f} ms; undistributed "
        f"captured {rn['base_ms_per_step']:.3f} ms = {rn['base_samples_per_s']:.1f} "
        f"samples/s, eager {rn['base_eager_ms_per_step']:.3f} ms; memory (GiB) "
        f"{_memory_text(rn['memory'])}; timed groups' compile taxes {rn['timed_taxes']}")
    log(f"[dp] (a) losses: first group mean {rn['first_group_mean']:.5f}, last "
        f"{rn['last_group_mean']:.5f}; NCCL kernels {rn['profile']['nccl_device_ms']:.3f} "
        f"ms in {rn['profile']['nccl_launches']} launches = "
        f"{rn['profile']['nccl_share_of_device']:.4f} of the profiled group's device "
        f"time (busy {rn['profile']['device_busy_share']:.3f}"
        + ("; a world of one's in-place all-reduce launches no kernel)" if cards == 1
           else ")"))
    log(f"[dp] (c) flagship DP {fl['ms_per_step']:.2f} ms a step = "
        f"{fl['tokens_per_s']:.1f} tokens/s against undistributed "
        f"{fl['base_ms_per_step']:.2f} ms = {fl['base_tokens_per_s']:.1f}; launches "
        f"in {fl['steps']} steps {fl['launches']}")
    g0, g1 = gloo
    log(f"[dp] (b) two gloo ranks on one card, ResNet-50 f32, {DP_GLOO_ROWS} rows a "
        f"rank: replicated losses {g0['replicated']['losses']} "
        f"({g0['replicated']['first_step_ms']:.1f} ms the first step, "
        f"{g0['replicated']['ms_per_step']:.1f} a step after); the first step's summed "
        f"gradient against the single model's: relative L2 "
        f"{g0['single']['grad_rel_l2']:.3e} (the single model's own: halves swapped "
        f"{g0['single']['floor_swapped']:.3e}, native convolutions "
        f"{g0['single']['floor_native']:.3e}); single model on the "
        f"{2 * DP_GLOO_ROWS}-row concatenation {g0['single']['losses']}, "
        f"{g0['single']['outside_tol']} elements outside rtol 2e-4 / atol 2e-5 "
        f"(max |d| {g0['single']['max_abs']:.3e}); ranks bit-identical: "
        f"{g0['replicated']['digest'] == g1['replicated']['digest']}")
    r2 = g0["replicated_lr2"]
    log(f"[dp] (b) at rate {DP_GLOO_LR_ZERO}: replicated losses {r2['losses']} "
        f"({r2['ms_per_step']:.1f} ms a step; the last one "
        f"{r2['losses'][-1] - g0['replicated']['losses'][-1]:+.5f} from the rate "
        f"{DP_GLOO_LR} run's), ranks bit-identical: "
        f"{r2['digest'] == g1['replicated_lr2']['digest']}")
    for tag in ("zero1", "zero2", "zero2_accum2", "int8"):
        log(f"[dp] (b) {tag}: losses {g0[tag]['losses']}, bit-identical to the "
            f"replicated run: {g0[tag]['digest'] == r2['digest']}, the parameters' "
            f"change against the replicated run's: relative L2 "
            f"{g0[tag]['step_rel_l2']:.3e}, optimizer state {g0[tag]['opt_bytes']} bytes "
            f"a rank against {r2['opt_bytes']}, {g0[tag]['ms_per_step']:.1f} ms a step")
    log(f"[dp] (b) write_model_distributed: {res['zip_bytes']} bytes; restored state "
        f"equals rank 1's: {res['zip_digest'] == g1['zero1']['digest']}, optimizer "
        f"{res['zip_opt_digest'] == g1['zero1']['opt_digest']}")
    res["seconds"] = time.perf_counter() - t_phase
    log(f"[dp] phase {res['seconds']:.1f}s (NCCL ranks {res['nccl_s']:.1f}s, gloo "
        f"ranks {res['gloo_s']:.1f}s)")

    # gates
    for r in nccl:
        if r["backend"] != "nccl":
            raise AssertionError(f"dp: rank {r['rank']} runs {r['backend']}, not NCCL")
        if not r["captured_vs_eager"]["identical"] or not r["flagship"]["captured_vs_eager"]["identical"]:
            raise AssertionError("dp: a captured DP step is not the eager step")
        rr = r["resnet"]
        if not rr["finite"] or not rr["last_group_mean"] < rr["first_group_mean"]:
            raise AssertionError(f"dp: ResNet-50 losses not finite or not falling: {rr}")
        taxes = rr["timed_taxes"]
        if taxes.get("jit_cache_misses", 0) or taxes.get("fresh_backend_compiles", 0):
            raise AssertionError(f"dp: a capture or an nvcc run in a timed group: {taxes}")
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv"):
            got = r["flagship"]["launches"].get(name, 0)
            if got != LAYERS * TRAIN_STEPS:
                raise AssertionError(f"dp: {name} launched {got} times in {TRAIN_STEPS} "
                                     f"DP steps, want {LAYERS * TRAIN_STEPS}")
    if cards == 1:
        # every weight of a world of one is an exact 1.0: f32 rounding at most
        if w1["state_gap"] > 1e-6 or not np.allclose(w1["dp_losses"], w1["base_losses"],
                                                      rtol=1e-6, atol=0):
            raise AssertionError(f"dp: the world of one is not the undistributed step: {w1}")
    elif len({r["digest"] for r in nccl}) != 1:
        raise AssertionError("dp: the NCCL ranks' replicas differ after the timed groups")
    for tag in ("replicated", "replicated_lr2"):
        if g0[tag]["digest"] != g1[tag]["digest"]:
            raise AssertionError(f"dp: the two gloo ranks' replicas differ ({tag})")
    if g0["replicated"]["capture"]:
        raise AssertionError("dp: a gloo world's model would capture its steps")
    single = g0["single"]
    floor = max(single["floor_swapped"], single["floor_native"])
    if not single["grad_rel_l2"] <= DP_GRAD_FLOOR_X * floor:
        raise AssertionError(f"dp: the two ranks' summed gradient is not the single "
                             f"model's: {single}")
    if single["outside_tol"] or not np.allclose(g0["replicated"]["losses"], single["losses"],
                                                rtol=2e-4, atol=2e-5):
        raise AssertionError(f"dp: two ranks are not the single model: {single}")
    r2 = g0["replicated_lr2"]
    if not abs(r2["losses"][-1] - g0["replicated"]["losses"][-1]) > DP_COMP_GAP:
        raise AssertionError(f"dp: at rate {DP_GLOO_LR_ZERO} the last loss moved no more "
                             f"than {DP_COMP_GAP}: the compression rule would not tell a "
                             f"run that never updates")
    for tag in ("zero1", "zero2"):
        if g0[tag]["digest"] != r2["digest"] or g1[tag]["digest"] != r2["digest"]:
            raise AssertionError(f"dp: {tag} is not the replicated run bit for bit: "
                                 f"{g0[tag]}")
    for tag in ("zero1", "zero2", "zero2_accum2"):
        if not g0[tag]["opt_bytes"] < r2["opt_bytes"]:
            raise AssertionError(f"dp: {tag} holds no less optimizer state a rank")
    for tag in ("zero2_accum2", "int8"):
        if not (np.isfinite(g0[tag]["losses"]).all()
                and abs(g0[tag]["losses"][-1] - r2["losses"][-1]) < DP_COMP_GAP):
            raise AssertionError(f"dp: {tag} not within {DP_COMP_GAP} of the exact run's "
                                 f"last loss: {g0[tag]}")
    if (res["zip_digest"] != g1["zero1"]["digest"]
            or res["zip_opt_digest"] != g1["zero1"]["opt_digest"]
            or res["zip_iteration"] != g1["zero1"]["iteration"]):
        raise AssertionError("dp: the distributed zip does not restore rank 1's state")
    return res

# -- model parallelism inside the step (ROADMAP A11 items 1, 3 and 4) -----------------

# the f32 parity steps: Sgd, not Adam (Adam turns the summation noise of a
# near-zero gradient element into a rate-sized step), at a rate that moves
# the parameters well past their rounding in 2 steps
MP_LR, MP_PARITY_STEPS = 1e-2, 2
# the MoE flagship's (EP, C27): at 1e-2 one f32 Sgd step lifts its loss
# from 29.3 to 86.9, out of the linear regime, where a GEMM's summation
# order (C27's ranks run 2 of the 4 rows) moves the next step's routing
# and with it the change (4.8 relative L2 on the card at 1e-2)
MP_MOE_LR = 1e-4
# C27 (data=n) steps once: with 43% of its choices dropped, a slot's
# position counts every earlier choice of its expert, so one choice
# flipped by a GEMM's summation order in the second step's forward
# shifts every later slot (0.70 relative L2 after 2 steps at 1e-4 on the
# card; 1e-4 on the CPU at 8 layers, 2.5e-6 after one step)
MP_C27_STEPS = 1
# C27's and ResNet-50's f32 gradients are ill-conditioned, so their
# change is held to MP_FLOOR_X times the larger of the undistributed
# model's own floors (PR 19's rule, `DP_GRAD_FLOOR_X`), or to
# MP_STEP_REL when that is larger.  A floor is the undistributed model's
# change against the same model's with one summation order of the same
# function changed: for the MoE flagship cuBLASLt's GEMMs at the same
# vocabulary chunking, or chunks of 4096 with cuBLAS (its residual
# stream grows ~1.5-2x a MoE layer, PR 15, so its f32 gradient carries
# far more rounding than the plain flagship's); for ResNet-50 its rows'
# halves swapped, or PyTorch's native convolutions (PR 19's floors).
# C27's change is also held to MP_C27_BOUND, whatever its floors: a
# gradient counted twice reads 1.0, one missing a rank's share 0.5 or
# more at n = 2
MP_FLOOR_X = 2.0
MP_C27_BOUND = 0.1
# the parameters' change (after - before, flattened) against the
# undistributed model's change: relative L2.  The distributed step sums
# the same products in other orders (a vocabulary shard's chunks, the
# ring's online softmax, a time block's GEMMs): f32 noise of ~1e-6 of a
# gradient, far below this; a gradient counted twice or missing a
# rank's share reads ~0.3 or more
MP_STEP_REL = 1e-3
# output() against the undistributed model's, relative to its max
MP_OUT_REL = 1e-4
# C27's forward inside the step's scopes (each rank its rows, routed in
# the global batch) against the undistributed one: a near-tie of two
# experts' probabilities can flip a choice between two summation orders
# of the router's input, and that token's output moves (on one card in
# PR 20: 2 differences among the last MoE layer's 16,384 (token,
# choice) pairs, none in the others; a difference is an expert id or a
# keep flag that differs); routing the rank's rows alone moves a large
# share (30 and 48 of 128 on the CPU).  So a layer may differ in at most
# MP_C27_ROUTES of its pairs, and the forward is held to MP_STEP_REL
# relative L2 (a flipped token moves its max gap, not this)
MP_C27_ROUTES = 1e-3
# (d) ResNet-50 over the model axis: 8 rows (gloo carries each
# convolution's channel gather through the host), 2 steps, Nesterovs at
# PR 19's 1e-6
MP_RESNET_ROWS, MP_RESNET_STEPS, MP_RESNET_LR = 8, 2, 1e-6
# the bf16 runs: warm-up and timed steps (the eager gloo steps take 1-2 s)
MP_WARMUP, MP_STEPS = 1, 2
# (a), (b), (f) and (g): the flagship at 4 of its 8 blocks, cut for the
# script's time limit (at 8 blocks mp ran 254.6-305.4 s and the whole
# command 1,199.8 s; C27 keeps 8)
MP_LAYERS = 4
# (c) EP's MoE flagship: 4 of its 8 blocks (at 8, its 537M expert
# parameters broadcast through gloo at distribute took most of (c)'s
# 57 s on two ranks sharing one H100 80GB HBM3); C27 keeps all 8
MP_EP_LAYERS = 4
MP_DIR = os.path.join("build", "mp")      # inside the checkout; removed after
# (f) the pipeline's microbatches a batch: 4 x 2048 ids in 4 microbatches
# of one row, so each stage runs B1-B3 at BH 8, T 2048
MP_PP_MICRO = 4


def _mp_flat(torch, leaves):
    return torch.cat([t.detach().float().reshape(-1) for t in leaves])


class _blas_library:
    """cuBLAS's library ``name`` ("cublaslt") for the GEMMs inside, for a
    second summation order of the same function; cuBLAS after."""

    def __init__(self, torch, name):
        self.torch, self.name = torch, name

    def __enter__(self):
        self.torch.backends.cuda.preferred_blas_library(self.name)
        return self

    def __exit__(self, *exc):
        self.torch.backends.cuda.preferred_blas_library("cublas")
        return False


def _moe_routes(torch, model, ids):
    """Each MoE layer's routing of ``ids`` (within a step's global batch
    under a data-parallel scope): (expert ids (N, k), kept (N * k,)),
    its input from `feed_forward` routed again; and the last layer's
    activation in f32 (`output()`'s, for the chunked head)."""
    from deeplearning4j_tpu_torch.parallel.expert import global_route, router_probs

    acts = model.feed_forward(ids)
    out = []
    with torch.no_grad():
        for i, layer in enumerate(model.conf.layers):
            if type(layer).__name__ == "MoELayer":
                x = acts[i - 1]
                probs = router_probs(x.reshape(-1, x.shape[-1]).float(),
                                     model.params[layer.name]["router"])
                _, _, idx, _, kept = global_route(probs, layer._cfg())
                out.append((idx, kept))
    last = acts[-1].float()
    del acts
    return out, last


def _mp_conf(bf16, seq_parallel="none", moe=0, sgd=None, layers=MP_LAYERS):
    """The flagship's (or the MoE flagship's) configuration: bf16 with
    its Adam, or f32 with Sgd ``sgd``; ``layers`` blocks."""
    import dataclasses

    from deeplearning4j_tpu_torch.nn.updaters import Sgd
    from deeplearning4j_tpu_torch.zoo.transformer import TransformerEncoder

    conf = TransformerEncoder(
        vocab_size=VOCAB, d_model=D_MODEL, n_heads=HEADS, n_layers=layers,
        causal=True, chunked_vocab_loss=True, vocab_chunk=8192, seed=123,
        seq_parallel=seq_parallel, moe_experts=moe, moe_top_k=MOE_TOP_K,
        bf16_compute=bf16).conf()
    return conf if sgd is None else dataclasses.replace(conf, updater=Sgd(sgd))


def _mp_rank(zip_path):
    """Every mode of the mp phase on this rank; see the module docstring."""
    import contextlib
    import dataclasses

    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
    from deeplearning4j_tpu_torch.models.computation_graph import GraphModel
    from deeplearning4j_tpu_torch.models.model import tree_leaves
    from deeplearning4j_tpu_torch.models.sequential import SequentialModel
    from deeplearning4j_tpu_torch.nn.updaters import Nesterovs
    from deeplearning4j_tpu_torch.parallel import ParallelConfig, collectives, distribute
    from deeplearning4j_tpu_torch.parallel.context import DataParallelContext, dp_scope
    from deeplearning4j_tpu_torch.parallel.data_parallel import local_rows
    from deeplearning4j_tpu_torch.runtime import compile_stats, distributed, kernels
    from deeplearning4j_tpu_torch.train.checkpoint import ModelSerializer
    from deeplearning4j_tpu_torch.zoo.resnet import ResNet50

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, n = distributed.process_index(), distributed.process_count()
    nccl = distributed.backend_name() == "nccl"
    res = {"rank": rank, "world": n, "backend": distributed.backend_name(),
           "card": torch.cuda.get_device_name()}
    ids = _train_batch(np)
    batch = DataSet(torch.from_numpy(ids.features).to("cuda"),
                    torch.from_numpy(ids.labels).to("cuda"))
    probe = batch.features[:QUANT_BATCH]

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def rows(m, b):
        return DataSet(local_rows(m, b.features), local_rows(m, b.labels))

    def replicated_digest(m):
        sp = m._shard_placement
        leaves = tree_leaves(m.params)
        keep = [t for i, t in enumerate(leaves) if sp is None or sp.splits[i] is None]
        return _dp_digest(torch, keep + tree_leaves(m.net_state))

    def build(conf, graph=False):
        return (GraphModel if graph else SequentialModel)(conf, device="cuda").init()

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    refs = {}

    def parity(conf, cfg, steps=MP_PARITY_STEPS, graph=False, batches=None, floors=(),
               moe=False):
        """``steps`` steps of the undistributed model (rank 0) and of the
        distributed one from the same weights: losses, the change's
        relative L2, output() and the replicas' digest.  ``floors``:
        (name, configuration or None, batches or None, context) of each
        of the undistributed model's own floors of the change
        (`MP_FLOOR_X`).  ``moe``: before the steps, each MoE layer's
        routing and the forward's output on the first batch's rows, the
        distributed model's inside its step's scopes (global routing),
        in place of output().  A configuration's undistributed run (no
        floors, the default batches) is made once and kept for the
        next call with the same configuration object."""
        batches = batches or [batch] * steps
        out = {}
        cached = refs.get(id(conf)) if not (floors or moe or graph) else None
        if rank == 0 and cached is not None:
            _, ref_losses, d0, o0 = cached
            out["floors"], out["floor_rel_l2"] = {}, 0.0
        elif rank == 0:
            m0 = build(conf, graph)
            p0 = _mp_flat(torch, tree_leaves(m0.params))
            if moe:
                routes0, o0 = _moe_routes(torch, m0, batches[0].features)
            ref_losses = []
            for b in batches:
                m0.fit_batch(b)
                ref_losses.append(m0.score_value)
            d0 = _mp_flat(torch, tree_leaves(m0.params)) - p0
            if not moe:
                o0 = None if graph else m0.output(probe).float()
            del m0
            free()
            out["floors"] = {}
            for name, fconf, fbatches, ctx in floors:
                with ctx():
                    m1 = build(fconf or conf, graph)
                    for b in fbatches or batches:
                        m1.fit_batch(b)
                    d1 = _mp_flat(torch, tree_leaves(m1.params)) - p0
                out["floors"][name] = rel(d1, d0)
                del m1, d1
                free()
            out["floor_rel_l2"] = max(out["floors"].values(), default=0.0)
            del p0
            free()
            if not (floors or moe or graph) and steps == MP_PARITY_STEPS:
                # the entry keeps conf alive: no later configuration
                # can take its id and find this run
                refs[id(conf)] = (conf, ref_losses, d0, o0)
        distributed.barrier()
        m = build(conf, graph)
        distribute(m, ParallelConfig(**cfg))
        p = _mp_flat(torch, tree_leaves(m.full_params()))
        if moe:
            bs = m._batch_sharding
            with m.mesh_scope(), dp_scope(DataParallelContext(bs.rank, bs.n)):
                routes, o = _moe_routes(torch, m, local_rows(m, batches[0].features))
                # the ranks' rows in global order
                routes = [tuple(collectives.gather(t, 0, "data") for t in r) for r in routes]
                o = collectives.gather(o, 0, "data")
        losses = []
        for b in batches:
            if graph:
                m.fit_batch(MultiDataSet((local_rows(m, b.features),),
                                         (local_rows(m, b.labels),)))
            else:
                m.fit_batch(rows(m, b))
            losses.append(m.score_value)
        d = _mp_flat(torch, tree_leaves(m.full_params())) - p
        if not moe and cfg.get("pipe", 1) > 1:
            # the pipeline splits the batch into microbatches: the probe's
            # rows of the whole batch's output()
            o = m.output(batch.features)[:QUANT_BATCH].float()
        elif not moe:
            o = None if graph else m.output(probe).float()
        out.update(losses=losses, digest=replicated_digest(m))
        out["change"] = d if cfg.get("pipe", 1) > 1 else None
        if rank == 0:
            out["ref_losses"] = ref_losses
            out["step_rel_l2"] = rel(d, d0)
            if o is not None:
                out["out_rel"] = ((o - o0).abs().max() / o0.abs().max()).item()
            if moe:
                out["out_rel_l2"] = rel(o, o0)
                out["pairs"] = routes0[0][1].numel()
                # each MoE layer's dropped share, and the (token, choice)
                # pairs routed to another expert or kept otherwise
                out["drop"] = [1.0 - k.float().mean().item() for _, k in routes]
                out["drop_ref"] = [1.0 - k.float().mean().item() for _, k in routes0]
                out["route_diffs"] = [int((g != g0).sum() + (k != k0).sum())
                                      for (g, k), (g0, k0) in zip(routes, routes0)]
                del routes0
            del d0, o0
        del p, d, o
        return m, out

    def pp_parts():
        """(f) the flagship's blocks over pipe=n, GPipe and 1F1B, and (g)
        the planner; see the module docstring."""
        t0 = time.perf_counter()
        pcfg = dict(data=1, pipe=n, microbatches=MP_PP_MICRO)
        for sched in ("gpipe", "1f1b"):
            m, res[sched] = parity(f32, dict(pcfg, schedule=sched))
            del m
            free()
        gp, ob = res["gpipe"].pop("change"), res["1f1b"].pop("change")
        res["1f1b"]["vs_gpipe_rel_l2"] = rel(ob, gp)
        del gp, ob
        free()
        for sched in ("gpipe", "1f1b"):
            res[sched]["speed"] = speed(bf16, dict(pcfg, schedule=sched))
        res["gpipe"]["seconds"] = time.perf_counter() - t0
        # (g) the planner on the card: priced without a launch, then auto
        t0 = time.perf_counter()
        from deeplearning4j_tpu_torch.parallel import PlanError, plan

        pm = build(bf16)
        digest0, it0 = _dp_digest(torch, tree_leaves(pm.params)), pm.iteration
        before, snap = kernels.launches(), compile_stats.snapshot()
        torch.cuda.synchronize()
        report = plan(pm, n_devices=n, batch=(ids.features, ids.labels))
        torch.cuda.synchronize()
        out = {"launched": {k: v - before.get(k, 0) for k, v in kernels.launches().items()
                            if v != before.get(k, 0)},
               "taxes": (compile_stats.snapshot() - snap).as_dict(),
               "unchanged": (_dp_digest(torch, tree_leaves(pm.params)) == digest0
                             and pm.iteration == it0 and pm.opt_state is None),
               "summary": report.summary(), "pick": report.pick_candidate().label(),
               "pick_width": report.pick_candidate().devices_used,
               "flops": report.base["flops"], "bytes": report.base["bytes_accessed"],
               "plan_seconds": report.plan_seconds,
               "candidates": [c.as_dict() for c in report.candidates]}
        del pm
        free()
        am = build(bf16)
        try:
            distribute(am, auto=True, batch=(ids.features, ids.labels))
            out["auto"] = {"installed": dict(am._mesh.shape)}
        except PlanError as e:
            out["auto"] = {"raised": str(e)}
        del am
        free()
        out["seconds"] = time.perf_counter() - t0
        res["plan"] = out

    def speed(conf, cfg, base=None):
        """bf16 steps of the distributed model (or of the undistributed
        one, ``cfg`` None, on rank 0 alone): ms a step, tokens/s, peak
        memory, launches, the timed steps' compile taxes."""
        mem0 = _memory_window(torch)
        m = build(conf)
        if cfg is not None:
            distribute(m, ParallelConfig(**cfg))
        b = rows(m, batch) if cfg is not None else batch
        for _ in range(MP_WARMUP):
            m.fit_batch(b)
        torch.cuda.synchronize()
        snap = compile_stats.snapshot()
        kernels.reset_launches()
        quiet = nccl and cfg is not None
        if quiet:
            torch.cuda.set_sync_debug_mode("error")
        try:
            losses, ms = _timed_steps(torch, m, [b] * MP_STEPS)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        counts = kernels.launches()
        tokens = TRAIN_BATCH * TRAIN_SEQ
        out = {"ms_per_step": ms, "tokens_per_s": tokens / ms * 1e3,
               "launches": counts, "steps": MP_STEPS,
               "losses": [float(x) for x in losses],
               "taxes": (compile_stats.snapshot() - snap).as_dict(),
               "capture": m.capture_steps}
        del m, b
        out["memory"] = _memory_window(torch, mem0)
        free()
        return out

    def baseline(conf):
        out = speed(conf, None) if rank == 0 else None
        distributed.barrier()
        return out

    t0 = time.perf_counter()
    # (a) TP: the flagship with model=n, and its zip
    f32 = _mp_conf(False, sgd=MP_LR)
    m, res["tp"] = parity(f32, dict(data=1, model=n))
    ModelSerializer.write_model(m, zip_path)
    if rank == 0:
        full = _mp_flat(torch, tree_leaves(m.full_params()))
        back = ModelSerializer.restore(zip_path, device="cuda")
        res["tp"]["zip_identical"] = bool(torch.equal(
            _mp_flat(torch, tree_leaves(back.params)), full))
        del back, full
    else:
        m.full_params()                 # the gather is a collective
    del m
    free()
    bf16 = _mp_conf(None)
    res["flagship_base"] = baseline(bf16)
    res["tp"]["speed"] = speed(bf16, dict(data=1, model=n))
    res["tp"]["seconds"] = time.perf_counter() - t0
    # (b) SP: Ulysses and ring at 4 x 2048 ids
    for mode in ("ulysses", "ring"):
        t0 = time.perf_counter()
        m, res[mode] = parity(_mp_conf(False, mode, sgd=MP_LR), dict(data=1, seq=n))
        del m
        free()
        res[mode]["speed"] = speed(_mp_conf(None, mode), dict(data=1, seq=n))
        res[mode]["seconds"] = time.perf_counter() - t0
    # (c) EP: the MoE flagship with expert=n
    t0 = time.perf_counter()
    m, res["ep"] = parity(_mp_conf(False, moe=MOE_EXPERTS, sgd=MP_MOE_LR,
                                   layers=MP_EP_LAYERS),
                          dict(data=1, expert=n))
    del m
    free()
    moe16 = _mp_conf(None, moe=MOE_EXPERTS, layers=MP_EP_LAYERS)
    res["moe_base"] = baseline(moe16)
    res["ep"]["speed"] = speed(moe16, dict(data=1, expert=n))
    res["ep"]["seconds"] = time.perf_counter() - t0
    # (d) ResNet-50 with model=n, f32
    t0 = time.perf_counter()
    rconf = dataclasses.replace(ResNet50().conf(), bf16_compute=False,
                                updater=Nesterovs(MP_RESNET_LR, 0.9))
    rng = np.random.default_rng(5)
    rb = [DataSet(torch.from_numpy(rng.normal(0, 1, (MP_RESNET_ROWS, DP_HW, DP_HW, 3))
                                   .astype(np.float32)).to("cuda"),
                  torch.from_numpy(np.eye(DP_CLASSES, dtype=np.float32)[
                      rng.integers(0, DP_CLASSES, MP_RESNET_ROWS)]).to("cuda"))
          for _ in range(MP_RESNET_STEPS)]
    h = MP_RESNET_ROWS // 2
    swapped = [DataSet(torch.cat([b.features[h:], b.features[:h]]),
                       torch.cat([b.labels[h:], b.labels[:h]])) for b in rb]
    m, res["resnet"] = parity(rconf, dict(data=1, model=n), graph=True, batches=rb, floors=(
        ("halves swapped", None, swapped, contextlib.nullcontext),
        ("native convolutions", None, None, lambda: _native_convolutions(torch))))
    res["resnet"]["splits"] = sum(s is not None for s in m._shard_placement.splits)
    del m, rb, swapped
    free()
    res["resnet"]["seconds"] = time.perf_counter() - t0
    # (e) C27: the MoE flagship with data=n against the concatenated rows
    t0 = time.perf_counter()
    c27 = _mp_conf(False, moe=MOE_EXPERTS, sgd=MP_MOE_LR, layers=LAYERS)
    chunk4096 = dataclasses.replace(c27, layers=tuple(
        dataclasses.replace(l, chunk=4096)
        if type(l).__name__ == "ChunkedSoftmaxOutputLayer" else l for l in c27.layers))
    m, res["c27"] = parity(c27, dict(data=n), steps=MP_C27_STEPS, moe=True, floors=(
        ("cuBLASLt", None, None, lambda: _blas_library(torch, "cublaslt")),
        ("chunks of 4096", chunk4096, None, contextlib.nullcontext)))
    del m
    free()
    res["c27"]["seconds"] = time.perf_counter() - t0
    pp_parts()
    return res


def phase_mp(torch, np, kernels, timer):
    """Model parallelism inside the step (ROADMAP A11 items 1, 3 and 4) on
    the card; see the module docstring."""
    t_phase = time.perf_counter()
    from deeplearning4j_tpu_torch.runtime import distributed

    cards = torch.cuda.device_count()
    n = 2 if cards < 4 else 4
    backend = "gloo" if cards == 1 else None
    shutil.rmtree(MP_DIR, ignore_errors=True)
    os.makedirs(MP_DIR)
    gc.collect()
    torch.cuda.empty_cache()
    try:
        world = distributed.spawn(_mp_rank, n, os.path.join(MP_DIR, "tp.zip"),
                                  backend=backend, timeout=900)
    finally:
        shutil.rmtree(MP_DIR, ignore_errors=True)
    r0 = world[0]
    res = {"cards": cards, "n": n, "backend": r0["backend"], "world": world}
    # each mode's launches a rank, for the kernels line (rank 0's)
    for mode in ("tp", "ulysses", "ring", "ep"):
        res[mode] = {"launches": r0[mode]["speed"]["launches"]}
    for mode in ("gpipe", "1f1b"):
        res[mode] = {"launches": r0[mode]["speed"]["launches"]}
    # B1-B3 at Ulysses' shape and at the pipeline's microbatch shape
    # against their plain versions
    rows = []
    for bh in sorted({TRAIN_BATCH * HEADS // n, TRAIN_BATCH * HEADS // MP_PP_MICRO}):
        rows += [flash_case(torch, timer, TRAIN_SEQ, torch.bfloat16, bh=bh)]
        rows += flash_bwd_cases(torch, timer, TRAIN_SEQ, torch.bfloat16, bh=bh)
    res["kernel_rows"] = check_rows("mp", rows)
    smi = nvidia_smi()
    base, mbase = r0["flagship_base"], r0["moe_base"]
    log(f"[mp] {n} ranks ({r0['backend']}, {cards} card(s) visible) on {smi}")
    for mode, what, b in (("tp", f"TP model={n}", base), ("ulysses", f"SP seq={n} Ulysses", base),
                          ("ring", f"SP seq={n} ring", base), ("ep", f"EP expert={n}", mbase)):
        e, sp = r0[mode], r0[mode]["speed"]
        lr = MP_MOE_LR if mode == "ep" else MP_LR
        log(f"[mp] ({mode}) {what}: f32 Sgd {lr} losses {e['losses']} against "
            f"{e['ref_losses']}; change relative L2 {e['step_rel_l2']:.3e}; output() "
            f"max gap {e['out_rel']:.3e} of max |p|; replicated leaves bit-identical "
            f"across ranks: {len({w[mode]['digest'] for w in world}) == 1}")
        log(f"[mp] ({mode}) bf16 {sp['ms_per_step']:.2f} ms a step = "
            f"{sp['tokens_per_s']:.1f} tokens/s a rank against undistributed "
            f"{b['ms_per_step']:.2f} ms = {b['tokens_per_s']:.1f} tokens/s; peak "
            f"reserved {sp['memory']['peak_gib']:.3f} GiB a rank against "
            f"{b['memory']['peak_gib']:.3f}; launches in {sp['steps']} steps "
            f"{sp['launches']}; timed steps' taxes {sp['taxes']}; captured "
            f"{sp['capture']}; {e['seconds']:.1f}s ({smi})")
    tp = r0["tp"]
    log(f"[mp] (a) write_model of the TP model restored undistributed on the card "
        f"equals the gathered parameters: {tp['zip_identical']}")
    def floors(e):
        return {k: float("%.3e" % v) for k, v in e["floors"].items()}

    def limit(e):
        return max(MP_STEP_REL, MP_FLOOR_X * e.get("floor_rel_l2", 0.0))

    rn = r0["resnet"]
    log(f"[mp] (d) ResNet-50 model={n} f32 ({rn['splits']} leaves split): losses "
        f"{rn['losses']} against {rn['ref_losses']}; change relative L2 "
        f"{rn['step_rel_l2']:.3e} (the undistributed model's own floors {floors(rn)}; "
        f"limit {limit(rn):.3e}, headroom {1 - rn['step_rel_l2'] / limit(rn):.1%}); "
        f"replicas bit-identical {len({w['resnet']['digest'] for w in world}) == 1}; "
        f"{rn['seconds']:.1f}s")
    c = r0["c27"]
    log(f"[mp] (e) C27 MoE data={n}: losses {c['losses']} against {c['ref_losses']} on "
        f"the concatenated rows; change relative L2 {c['step_rel_l2']:.3e} (the "
        f"undistributed model's own floors {floors(c)}; limit {limit(c):.3e}, headroom "
        f"{1 - c['step_rel_l2'] / limit(c):.1%}; bound {MP_C27_BOUND}); the step's "
        f"forward (global routing) {c['out_rel_l2']:.3e} relative L2 (max gap "
        f"{c['out_rel']:.3e} of max |p|) from the undistributed one's; (token, choice) "
        f"pairs routed otherwise by layer {c['route_diffs']} of {c['pairs']}; dropped share by layer {['%.5f' % x for x in c['drop']]} "
        f"against {['%.5f' % x for x in c['drop_ref']]}; {c['seconds']:.1f}s")
    m_stage = MP_LAYERS // n
    pp_want = {"flash_fwd": 2 * m_stage * MP_PP_MICRO * MP_STEPS,
               "flash_bwd_dq": m_stage * MP_PP_MICRO * MP_STEPS,
               "flash_bwd_dkdv": m_stage * MP_PP_MICRO * MP_STEPS}
    for mode in ("gpipe", "1f1b"):
        e, sp = r0[mode], r0[mode]["speed"]
        log(f"[mp] (f) PP pipe={n} {mode}, {MP_PP_MICRO} microbatches: f32 Sgd {MP_LR} "
            f"losses {e['losses']} against {e['ref_losses']}; change relative L2 "
            f"{e['step_rel_l2']:.3e}; output() max gap {e['out_rel']:.3e} of max |p|; "
            f"leaves bit-identical across ranks: "
            f"{len({w[mode]['digest'] for w in world}) == 1}")
        log(f"[mp] (f) {mode} bf16 {sp['ms_per_step']:.2f} ms a step = "
            f"{sp['tokens_per_s']:.1f} tokens/s a rank against undistributed "
            f"{base['ms_per_step']:.2f} ms = {base['tokens_per_s']:.1f} tokens/s; peak "
            f"reserved {sp['memory']['peak_gib']:.3f} GiB a rank against "
            f"{base['memory']['peak_gib']:.3f}; launches in {sp['steps']} steps "
            f"{sp['launches']} (want {pp_want}); timed steps' taxes {sp['taxes']}; "
            f"captured {sp['capture']} ({smi})")
    ob = r0["1f1b"]
    log(f"[mp] (f) 1F1B against GPipe: losses {ob['losses']} against "
        f"{r0['gpipe']['losses']}; parameters' change relative L2 "
        f"{ob['vs_gpipe_rel_l2']:.3e}; (f) {r0['gpipe']['seconds']:.1f}s")
    pl = r0["plan"]
    measured = {f"data=1 pipe={n} zero=0": r0["gpipe"]["speed"]["ms_per_step"],
                "data=1 zero=0": base["ms_per_step"]}
    log(f"[mp] (g) plan() of the bf16 flagship over {n} ranks at {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} ids in {pl['plan_seconds'] * 1e3:.1f} ms: {pl['flops']:.4e} FLOPs, "
        f"{pl['bytes']:.4e} bytes a step; launched {pl['launched']}; taxes "
        f"{pl['taxes']}; model unchanged {pl['unchanged']}; pick {pl['pick']} "
        f"({pl['pick_width']} ranks)")
    for line in pl["summary"].splitlines():
        log(f"[mp] (g) {line}")
    hop = None
    for cand in pl["candidates"]:
        if cand["label"] in measured and cand["predicted_step_seconds"] is not None:
            pred = cand["predicted_step_seconds"]
            log(f"[mp] (g) {cand['label']}: predicted {pred * 1e3:.3f} ms, measured "
                f"{measured[cand['label']]:.3f} ms (bf16 gpipe for pipe={n})")
            if cand["pipe"] > 1:
                priced = pred - cand["terms"]["hop_penalty_seconds"]
                hop = (measured[cand["label"]] / 1e3 - priced) / (cand["devices_used"] - 1)
    log(f"[mp] (g) per-hop seconds measured on this world (pipe={n} step over its "
        f"priced terms, per extra rank): {hop} ({smi})")
    log(f"[mp] (g) distribute(auto=True) in the world of {n}: {pl['auto']}; "
        f"{pl['seconds']:.1f}s")
    res["pp"] = {"hop_seconds": hop, "pp_want": pp_want}
    res["seconds"] = time.perf_counter() - t_phase
    log(f"[mp] phase {res['seconds']:.1f}s")

    # gates
    for mode in ("tp", "ulysses", "ring", "ep", "c27"):
        e = r0[mode]
        if not np.allclose(e["losses"], e["ref_losses"], rtol=2e-4, atol=0):
            raise AssertionError(f"mp ({mode}): f32 losses {e['losses']} are not the "
                                 f"undistributed model's {e['ref_losses']}")
        if not e["step_rel_l2"] <= limit(e):
            raise AssertionError(f"mp ({mode}): the parameters' change is "
                                 f"{e['step_rel_l2']:.3e} from the undistributed one's "
                                 f"(limit {limit(e):.3e})")
        if mode != "c27" and not e["out_rel"] <= MP_OUT_REL:
            raise AssertionError(f"mp ({mode}): output() {e['out_rel']:.3e} from the "
                                 "undistributed model's")
        if len({w[mode]["digest"] for w in world}) != 1:
            raise AssertionError(f"mp ({mode}): replicated leaves differ across ranks")
    for mode in ("tp", "ulysses", "ring", "ep"):
        sp = r0[mode]["speed"]
        want = (0 if mode == "ring" else MP_EP_LAYERS if mode == "ep" else MP_LAYERS) * MP_STEPS
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv"):
            for w in world:
                got = w[mode]["speed"]["launches"].get(name, 0)
                if got != want:
                    raise AssertionError(f"mp ({mode}): rank {w['rank']} launched {name} "
                                         f"{got} times in {MP_STEPS} steps, want {want}")
        if not np.isfinite(sp["losses"]).all():
            raise AssertionError(f"mp ({mode}): bf16 losses not finite: {sp['losses']}")
        if r0["backend"] == "nccl":
            taxes = sp["taxes"]
            if not sp["capture"] or taxes.get("jit_cache_misses", 0) or \
                    taxes.get("fresh_backend_compiles", 0):
                raise AssertionError(f"mp ({mode}): a capture or nvcc run in the timed "
                                     f"NCCL steps, or no capture: {sp}")
    if not tp["zip_identical"]:
        raise AssertionError("mp (a): the TP zip does not restore the gathered parameters")
    if not (np.isfinite(rn["losses"]).all()
            and np.allclose(rn["losses"], rn["ref_losses"], rtol=2e-4, atol=0)):
        raise AssertionError(f"mp (d): ResNet-50 losses {rn['losses']} are not the "
                             f"undistributed model's {rn['ref_losses']}")
    if len({w["resnet"]["digest"] for w in world}) != 1:
        raise AssertionError("mp (d): ResNet-50's replicated leaves differ across ranks")
    if not rn["step_rel_l2"] <= limit(rn):
        raise AssertionError(f"mp (d): ResNet-50's change is {rn['step_rel_l2']:.3e} from "
                             f"the undistributed one's (limit {limit(rn):.3e})")
    if not c["step_rel_l2"] <= MP_C27_BOUND:
        raise AssertionError(f"mp (e): the change is {c['step_rel_l2']:.3e} from the "
                             f"undistributed one's (bound {MP_C27_BOUND})")
    if not (c["out_rel_l2"] <= MP_STEP_REL
            and max(c["route_diffs"]) <= MP_C27_ROUTES * c["pairs"]):
        raise AssertionError(f"mp (e): the step's forward is {c['out_rel_l2']:.3e} from the "
                             f"undistributed one's, pairs routed otherwise by layer "
                             f"{c['route_diffs']} of {c['pairs']}")
    if not np.allclose(c["drop"], c["drop_ref"], rtol=0, atol=1e-3):
        raise AssertionError(f"mp (e): dropped shares {c['drop']} are not the "
                             f"undistributed model's {c['drop_ref']}")
    for mode in ("gpipe", "1f1b"):
        e, sp = r0[mode], r0[mode]["speed"]
        if not np.allclose(e["losses"], e["ref_losses"], rtol=2e-4, atol=0):
            raise AssertionError(f"mp (f) {mode}: f32 losses {e['losses']} are not the "
                                 f"undistributed model's {e['ref_losses']}")
        if not (e["step_rel_l2"] <= MP_STEP_REL and e["out_rel"] <= MP_OUT_REL):
            raise AssertionError(f"mp (f) {mode}: change {e['step_rel_l2']:.3e}, output() "
                                 f"{e['out_rel']:.3e} from the undistributed model's")
        if len({w[mode]["digest"] for w in world}) != 1:
            raise AssertionError(f"mp (f) {mode}: the leaves differ across ranks")
        for w in world:
            got = {k: w[mode]["speed"]["launches"].get(k, 0) for k in pp_want}
            if got != pp_want:
                raise AssertionError(f"mp (f) {mode}: rank {w['rank']} launched {got} in "
                                     f"{MP_STEPS} steps, want {pp_want}")
        if not np.isfinite(sp["losses"]).all():
            raise AssertionError(f"mp (f) {mode}: bf16 losses not finite: {sp['losses']}")
        if r0["backend"] == "nccl":
            taxes = sp["taxes"]
            if not sp["capture"] or taxes.get("jit_cache_misses", 0) or \
                    taxes.get("fresh_backend_compiles", 0):
                raise AssertionError(f"mp (f) {mode}: a capture or nvcc run in the timed "
                                     f"NCCL steps, or no capture: {sp}")
    if not (np.allclose(ob["losses"], r0["gpipe"]["losses"], rtol=2e-4, atol=0)
            and ob["vs_gpipe_rel_l2"] <= MP_STEP_REL):
        raise AssertionError(f"mp (f): 1F1B is not GPipe: losses {ob['losses']} against "
                             f"{r0['gpipe']['losses']}, change {ob['vs_gpipe_rel_l2']:.3e}")
    for w in world:
        p = w["plan"]
        if p["launched"] or p["taxes"].get("backend_compiles", 0) or \
                p["taxes"].get("jit_cache_misses", 0) or not p["unchanged"]:
            raise AssertionError(f"mp (g): rank {w['rank']}'s plan() launched {p['launched']}"
                                 f", taxes {p['taxes']}, model unchanged {p['unchanged']}")
        if p["pick_width"] == n:
            if "installed" not in p["auto"]:
                raise AssertionError(f"mp (g): the pick spans the world but "
                                     f"distribute(auto=True) did not install it: {p['auto']}")
        elif "ROADMAP C28" not in p["auto"].get("raised", ""):
            raise AssertionError(f"mp (g): a pick of {p['pick_width']} ranks in a world of "
                                 f"{n} must raise C28's PlanError: {p['auto']}")
    return res


# -- SameDiff and the TF importer (ROADMAP A13, first part) ---------------------

# BASELINE config 4: bench.py bench_bert's frozen BERT-base classifier
SD_VOCAB, SD_D, SD_HEADS, SD_LAYERS = 30522, 768, 12, 12
SD_SEQ, SD_BATCH, SD_CLASSES, SD_SEED = 128, 32, 2, 4
SD_LR = 2e-5
# captured steps timed after the parity check, and eager steps beside them
SD_STEPS, SD_EAGER = 6, 2
# (b) the code-built BERT: Adam rate, steps a compute, and its task's ids
SD_CODE_LR, SD_CODE_STEPS, SD_CODE_IDS = 1e-4, 8, 16
# (c) the zips: BERT-base widths with 2 of the 12 layers (deflate is
# single-threaded zlib: ~17 MB/s on the card's host)
SD_CKPT_LAYERS = 2
SD_DIR = os.path.join("build", "samediff")   # inside the checkout; removed after
# (d) examples/finetune_imported.py's loop graph
SD_LOOP_B, SD_LOOP_D, SD_LOOP_K, SD_LOOP_TRIPS, SD_LOOP_STEPS = 16, 8, 3, 4, 6
SD_ROW_TOL = 1e-4          # card f32 logits against the CPU, of max |logit|
SD_LOSS_TOL = 1e-4         # the same rows' loss, relative
SD_LOOP_TOL = 1e-5         # (d)'s losses against the CPU, relative
FLASH_NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv")


def _bert_words():
    """bench.py bench_bert's SST-2-style word list and its WordPiece vocab."""
    words = ["the", "movie", "was", "great", "terrible", "plot", "acting",
             "boring", "brilliant", "slow", "fun", "a", "it", "felt",
             "script", "ending"]
    vocab = {"[PAD]": 0, "[UNK]": 1, "[CLS]": 2, "[SEP]": 3, "[MASK]": 4,
             **{t: i + 5 for i, t in enumerate(words)}}
    return words, vocab


def _bert_feeds(np, batch, seq, n_batches):
    """bench_bert's batches: sentences of its word list through the
    port's BertWordPieceTokenizer and BertIterator."""
    from deeplearning4j_tpu_torch.nlp import BertIterator, BertWordPieceTokenizer

    words, vocab = _bert_words()
    tok = BertWordPieceTokenizer(vocab)
    rng = np.random.default_rng(2)
    n_sent = batch * n_batches
    sentences = [" ".join(rng.choice(words, rng.integers(6, seq // 2)))
                 for _ in range(n_sent)]
    it = BertIterator(tok, sentences, rng.integers(0, SD_CLASSES, n_sent),
                      num_classes=SD_CLASSES, batch_size=batch, max_len=seq)
    return [{"ids": b.features.astype(np.int32), "labels": b.labels} for b in it]


def _sd_attach_loss(sd, lr, bf16):
    from deeplearning4j_tpu_torch.autodiff import TrainingConfig
    from deeplearning4j_tpu_torch.nn.updaters import Adam

    labels = sd.placeholder("labels")
    sd.set_loss(sd.loss.softmax_cross_entropy(sd["logits"], labels, name="loss"))
    sd.set_training_config(TrainingConfig(updater=Adam(lr), bf16_compute=bf16))


def _sd_snapshot(torch, sd):
    from deeplearning4j_tpu_torch.nn.updaters import state_leaves

    return {"values": {n: sd._values[n].clone() for n in sd._trainable},
            "opt": [x.clone() if isinstance(x, torch.Tensor) else x
                    for x in state_leaves(sd._opt_state)],
            "stream": sd._stream.state_dict()}


def _sd_restore(sd, snap):
    """``snap`` written into the live tensors in place (the step graphs
    stay valid)."""
    from deeplearning4j_tpu_torch.nn.updaters import load_state_leaves

    for n, t in snap["values"].items():
        sd._values[n].copy_(t)
    sd._opt_state = load_state_leaves(sd._opt_state, snap["opt"])
    sd._stream.load_state_dict(snap["stream"])


def _sd_differing(torch, a: dict, b: dict) -> list:
    bad = [n for n in a["values"] if not torch.equal(a["values"][n], b["values"][n])]
    bad += [f"opt[{i}]" for i, (x, y) in enumerate(zip(a["opt"], b["opt"]))
            if not (torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y)]
    return bad


@contextlib.contextmanager
def _flash_routes():
    """Counts, by kernel and dtype, the q, k, v that reach B1 and B2/B3
    inside the block: bf16 ones run the wgmma kernels, f32 ones the split
    kernels, and the launch counters do not tell the two apart."""
    from deeplearning4j_tpu_torch.ops import flash_attention as fa

    seen: dict = {}
    fwd, bwd = fa._flash_fwd_kernel, fa._flash_bwd_kernel

    def note(name, *xs):
        key = f"{name}/" + ",".join(str(x.dtype).removeprefix("torch.") for x in xs)
        seen[key] = seen.get(key, 0) + 1

    def fwd_seen(q, k, v, causal):
        note("flash_fwd", q, k, v)
        return fwd(q, k, v, causal)

    def bwd_seen(q, k, v, out, lse, g, causal):
        note("flash_bwd", q, k, v)
        return bwd(q, k, v, out, lse, g, causal)

    fa._flash_fwd_kernel, fa._flash_bwd_kernel = fwd_seen, bwd_seen
    try:
        yield seen
    finally:
        fa._flash_fwd_kernel, fa._flash_bwd_kernel = fwd, bwd


def _sd_captured_vs_eager(torch, sd, feeds, n, tag, routes=None):
    """From one state (after a first, capturing, step): ``n`` captured
    steps, then the same ``n`` steps eagerly from the restored state;
    losses, trainables and Adam state must agree bit for bit.  In the
    eager steps the q, k, v that reach B1-B3 must be ``routes``
    (`_flash_routes`' counts; none when it is None)."""
    sd.capture_steps = True
    sd.fit_batch(feeds[0])
    snap = _sd_snapshot(torch, sd)
    captured = [sd.fit_batch(feeds[i % len(feeds)]) for i in range(1, n + 1)]
    after_captured = _sd_snapshot(torch, sd)
    graphs = len(sd._captured)
    _sd_restore(sd, snap)
    sd.capture_steps = False
    with _flash_routes() as seen:
        eager = [sd.fit_batch(feeds[i % len(feeds)]) for i in range(1, n + 1)]
        torch.cuda.synchronize()
    sd.capture_steps = True
    diff = _sd_differing(torch, after_captured, _sd_snapshot(torch, sd))
    if captured != eager or diff or graphs != 1 or seen != (routes or {}):
        raise AssertionError(f"[samediff] {tag}: captured {captured} against eager "
                             f"{eager}; differing {diff[:8]}; {graphs} step graphs; "
                             f"B1-B3 inputs {seen}, want {routes or {}}")
    log(f"[samediff] {tag}: {n} captured steps == {n} eager steps bit for bit "
        f"(losses {captured}, trainables and Adam state); 1 step graph; the eager "
        f"steps' B1-B3 inputs by dtype {seen}")
    return captured


def _sd_timed(torch, sd, feeds, n, start=0):
    """ms a step over ``n`` steps queued back to back, and their losses."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = [sd.fit_batch(feeds[(start + i) % len(feeds)], sync=False) for i in range(n)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n * 1e3
    return ms, [float(x) for x in out]


def _bert_flops(layers, seq, d, classes, batch):
    """bench.py bench_bert's forward count, times three (forward and
    backward), times the batch: one training step's FLOPs."""
    return 3.0 * float(layers * (24 * seq * d * d + 4 * seq * seq * d)
                       + 2 * d * classes) * batch


def _sd_config4(torch, np, kernels):
    """(a) BASELINE config 4 at full width through the port's writer,
    codec, importer and SameDiff, bf16 compute."""
    from deeplearning4j_tpu_torch.autodiff.ops_registry import get_op
    from deeplearning4j_tpu_torch.modelimport._tf import wire
    from deeplearning4j_tpu_torch.modelimport._tf.synthetic import (
        build_bert_classifier_graphdef,
    )
    from deeplearning4j_tpu_torch.modelimport.tensorflow import import_graph

    res = {}
    kw = dict(vocab=SD_VOCAB, d_model=SD_D, n_layers=SD_LAYERS, n_heads=SD_HEADS,
              seq_len=SD_SEQ, n_classes=SD_CLASSES, seed=SD_SEED)
    start = _memory_window(torch)
    t0 = time.perf_counter()
    raw = build_bert_classifier_graphdef(batch=SD_BATCH, **kw)
    res["write_s"] = time.perf_counter() - t0
    res["graph_mb"] = len(raw) / 1e6
    t0 = time.perf_counter()
    wire.GraphDef().ParseFromString(raw)
    res["parse_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sd = import_graph(raw, trainable=True, device="cuda")
    torch.cuda.synchronize()
    res["import_s"] = time.perf_counter() - t0
    n_params = sum(sd._values[n].numel() for n in sd._trainable)
    log(f"[samediff] config 4: graph {res['graph_mb']:.1f} MB written in "
        f"{res['write_s']:.2f}s, parsed in {res['parse_s']:.2f}s, imported (parse "
        f"included) in {res['import_s']:.2f}s; {len(sd._trainable)} trainables, "
        f"{n_params} parameters on the card")
    feeds = _bert_feeds(np, SD_BATCH, SD_SEQ, 4)

    # f32 rows 0-1 of the untrained graph on the card (TF32 off) against
    # the port's CPU output() of the batch-2 graph of the same seed
    ids, labels = feeds[0]["ids"], feeds[0]["labels"]
    card = sd.output({"ids": ids}, "logits")[:2]
    card_loss = float(get_op("softmax_cross_entropy")(
        card, torch.as_tensor(labels[:2], device="cuda")))
    raw2 = build_bert_classifier_graphdef(batch=2, **kw)
    cpu = import_graph(raw2, trainable=True, device="cpu")
    del raw2
    _sd_attach_loss(cpu, SD_LR, False)
    cpu_logits, cpu_loss = cpu.output({"ids": ids[:2], "labels": labels[:2]},
                                      "logits", "loss")
    del cpu
    err = (card.cpu() - cpu_logits).abs().max().item() / cpu_logits.abs().max().item()
    loss_err = abs(card_loss - float(cpu_loss)) / abs(float(cpu_loss))
    res["cpu_rows"] = {"logit_rel_err": err, "loss_rel_err": loss_err,
                       "card_loss": card_loss, "cpu_loss": float(cpu_loss)}
    log(f"[samediff] config 4 f32 rows 0-1 on the card against the CPU's batch-2 "
        f"graph: logits {err:.3e} of max |logit| (tol {SD_ROW_TOL:.0e}), loss "
        f"{card_loss:.7f} vs {float(cpu_loss):.7f} ({loss_err:.3e} relative, tol "
        f"{SD_LOSS_TOL:.0e})")
    if not (err <= SD_ROW_TOL and loss_err <= SD_LOSS_TOL):
        raise AssertionError(f"[samediff] config 4 rows disagree with the CPU: {res['cpu_rows']}")

    _sd_attach_loss(sd, SD_LR, True)
    kernels.reset_launches()
    parity = _sd_captured_vs_eager(torch, sd, feeds, 2, "config 4 (bf16)")
    ms, losses = _sd_timed(torch, sd, feeds, SD_STEPS, start=3)
    sd.capture_steps = False
    eager_ms, eager_losses = _sd_timed(torch, sd, feeds, SD_EAGER, start=3 + SD_STEPS)
    sd.capture_steps = True
    res["launches"] = launches = kernels.launches()
    res["memory"] = {"train": _memory_window(torch, start)}
    flops = _bert_flops(SD_LAYERS, SD_SEQ, SD_D, SD_CLASSES, SD_BATCH)
    res.update(ms=ms, eager_ms=eager_ms, samples_per_s=SD_BATCH / ms * 1e3,
               flops_per_step=flops, mfu=flops / (ms / 1e3) / PEAK_OPS["bf16"],
               losses=parity + losses + eager_losses, graphs=len(sd._captured))
    log(f"[samediff] config 4: {ms:.2f} ms a captured step, {eager_ms:.2f} ms eager; "
        f"{res['samples_per_s']:.1f} samples/s; {flops:.4e} FLOPs a step "
        f"(3 x bench.py's forward count x {SD_BATCH}); MFU {res['mfu']:.4f} of the "
        f"bf16 peak; losses {res['losses']}; {_memory_text(res['memory'])}; "
        f"launches {launches}")
    if not all(np.isfinite(res["losses"])):
        raise AssertionError(f"[samediff] config 4: non-finite loss {res['losses']}")
    if any(launches.get(n, 0) for n in FLASH_NAMES + (
            "paged_attention_fwd", "paged_attention_fwd_int8", "dequant_matmul")):
        raise AssertionError(f"[samediff] config 4 has no attention op, yet kernels "
                             f"launched: {launches}")
    del sd
    return res


def _code_bert(np, device, layers, vocab, bf16, seed=7):
    """A BERT classifier built in code at config 4's widths: each block
    `multi_head_dot_product_attention` over (B, T, H, D / H), layer norm,
    gelu MLP; the [CLS] position's vector to the head."""
    from deeplearning4j_tpu_torch.autodiff import SameDiff

    rng = np.random.default_rng(seed)
    b, t, d, h = SD_BATCH, SD_SEQ, SD_D, SD_HEADS
    sd = SameDiff(seed=seed, device=device)

    def w(name, *shape):
        return sd.var(name, rng.normal(0, 0.02, shape).astype(np.float32))

    def zeros(name, *shape):
        return sd.var(name, np.zeros(shape, np.float32))

    def ones(name, *shape):
        return sd.var(name, np.ones(shape, np.float32))

    ids = sd.placeholder("ids")
    x = sd.math.gather(w("emb", vocab, d), ids, axis=0) + w("pos", 1, t, d)
    for i in range(layers):
        p = f"l{i}"
        x2 = x.reshape((b * t, d))
        q, k, v = ((x2 @ w(f"{p}/w{n}", d, d) + zeros(f"{p}/b{n}", d)).reshape(
            (b, t, h, d // h)) for n in "qkv")
        a = sd.nn.multi_head_dot_product_attention(q, k, v, causal=False)
        a = a.reshape((b * t, d)) @ w(f"{p}/wo", d, d) + zeros(f"{p}/bo", d)
        x = sd.nn.layer_norm(x + a.reshape((b, t, d)), ones(f"{p}/g1", d),
                             zeros(f"{p}/e1", d), epsilon=1e-12)
        up = sd.nn.gelu(x.reshape((b * t, d)) @ w(f"{p}/w1", d, 4 * d)
                        + zeros(f"{p}/b1", 4 * d))
        down = up @ w(f"{p}/w2", 4 * d, d) + zeros(f"{p}/b2", d)
        x = sd.nn.layer_norm(x + down.reshape((b, t, d)), ones(f"{p}/g2", d),
                             zeros(f"{p}/e2", d), epsilon=1e-12)
    cls = sd.math.gather(x, sd.constant("cls_index", np.int32(0)), axis=1)
    sd.apply("identity", cls @ w("wc", d, SD_CLASSES) + zeros("bc", SD_CLASSES),
             name="logits")
    _sd_attach_loss(sd, SD_CODE_LR, bf16)
    return sd


def _code_feeds(np, n):
    """The code-built BERT's task: token ids out of a few, the label
    whether the first token's id is even."""
    rng = np.random.default_rng(11)
    out = []
    for _ in range(n):
        ids = rng.integers(0, SD_CODE_IDS, (SD_BATCH, SD_SEQ)).astype(np.int32)
        out.append({"ids": ids, "labels": np.eye(SD_CLASSES, dtype=np.float32)[ids[:, 0] % 2]})
    return out


def _sd_code(torch, np, kernels, timer):
    """(b) the code-built BERT through B1-B3, bf16 then f32."""
    res = {"kernel_rows": []}
    feeds = _code_feeds(np, 2)
    for kind, bf16 in (("bf16", True), ("f32", False)):
        start = _memory_window(torch)
        sd = _code_bert(np, "cuda", SD_LAYERS, SD_VOCAB, bf16)
        kernels.reset_launches()
        out = sd.output({"ids": feeds[0]["ids"]}, "logits")
        torch.cuda.synchronize()
        out_launches = kernels.launches()
        if (out_launches.get("flash_fwd", 0) != SD_LAYERS
                or out_launches.get("flash_bwd_dq", 0) or out_launches.get("flash_bwd_dkdv", 0)
                or not torch.isfinite(out).all()):
            raise AssertionError(f"[samediff] code-built {kind} output(): launches "
                                 f"{out_launches} (want {SD_LAYERS} flash_fwd and no backward)")
        dt = "bfloat16" if bf16 else "float32"
        parity = _sd_captured_vs_eager(
            torch, sd, feeds, 2, f"code-built BERT ({kind})",
            routes={f"{n}/{dt},{dt},{dt}": 2 * SD_LAYERS for n in ("flash_fwd", "flash_bwd")})
        kernels.reset_launches()
        ms, losses = _sd_timed(torch, sd, feeds, SD_CODE_STEPS, start=3)
        launches = kernels.launches()
        memory = _memory_window(torch, start)
        losses = parity + losses
        want = {n: SD_LAYERS * SD_CODE_STEPS for n in FLASH_NAMES}
        got = {n: launches.get(n, 0) for n in FLASH_NAMES}
        # 4-step windows: both alternating batches in each
        first, last = float(np.mean(losses[:4])), float(np.mean(losses[-4:]))
        res[kind] = {"ms": ms, "losses": losses, "launches": launches,
                     "output_launches": out_launches, "memory": memory,
                     "samples_per_s": SD_BATCH / ms * 1e3}
        log(f"[samediff] code-built BERT {kind}: {ms:.2f} ms a captured step, "
            f"{res[kind]['samples_per_s']:.1f} samples/s; losses {losses}; launches "
            f"over {SD_CODE_STEPS} steps {got}; output() {out_launches}; "
            f"{_memory_text({'train': memory})}")
        if got != want:
            raise AssertionError(f"[samediff] code-built {kind}: launches {got}, want {want}")
        if not (all(np.isfinite(losses)) and last < first):
            raise AssertionError(f"[samediff] code-built {kind}: the loss did not fall: {losses}")
        del sd, out
    for dtype in (torch.bfloat16, torch.float32):
        res["kernel_rows"].append(flash_case(torch, timer, SD_SEQ, dtype, causal=False,
                                             bh=SD_BATCH * SD_HEADS, d=SD_D // SD_HEADS))
        res["kernel_rows"] += flash_bwd_cases(torch, timer, SD_SEQ, dtype, causal=False,
                                              d=SD_D // SD_HEADS, bh=SD_BATCH * SD_HEADS)
    check_rows("samediff", res["kernel_rows"])
    return res


def _sd_resumed(torch, sd, path, feed, tag, kind):
    """``sd``, saved to ``path`` as a ``kind`` zip, steps on; the zip,
    loaded on the card, must be of that kind and give the same next
    step's loss, trainables and Adam state bit for bit.  Returns the
    load's seconds and the step's loss."""
    import zipfile

    from deeplearning4j_tpu_torch.autodiff import SameDiff

    with zipfile.ZipFile(path) as zf:
        names = set(zf.namelist())
    entry = {"plain": "graph.json", "source-backed": "import_manifest.json"}[kind]
    if entry not in names:
        raise AssertionError(f"[samediff] zip {tag}: not a {kind} zip: {sorted(names)}")
    want = sd.fit_batch(feed)
    want_state = _sd_snapshot(torch, sd)
    t0 = time.perf_counter()
    back = SameDiff.load(path, "cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    got = back.fit_batch(feed)
    diff = _sd_differing(torch, want_state, _sd_snapshot(torch, back))
    log(f"[samediff] zip {tag} ({kind}): {os.path.getsize(path)} bytes, loaded in "
        f"{load_s:.2f}s; the next step {got!r} vs never saved {want!r}; differing {diff[:8]}")
    if got != want or diff:
        raise AssertionError(f"[samediff] zip {tag}: the resumed step differs")
    return load_s, got


def _sd_zips(torch, np):
    """(c) save and load on the card: the imported graph at BERT-base
    widths with 2 layers and the code-built BERT cut to 2 blocks, neither
    with control flow, so both plain zips, as the JAX package writes
    them.  Each steps, is saved, steps on (`_sd_resumed`).  The two saves
    run in two threads: their deflate is single-threaded zlib, which
    releases the interpreter lock."""
    from concurrent.futures import ThreadPoolExecutor

    from deeplearning4j_tpu_torch.modelimport._tf.synthetic import (
        build_bert_classifier_graphdef,
    )
    from deeplearning4j_tpu_torch.modelimport.tensorflow import import_graph

    os.makedirs(SD_DIR, exist_ok=True)
    try:
        raw = build_bert_classifier_graphdef(
            vocab=SD_VOCAB, d_model=SD_D, n_layers=SD_CKPT_LAYERS, n_heads=SD_HEADS,
            seq_len=SD_SEQ, batch=SD_BATCH, n_classes=SD_CLASSES, seed=SD_SEED)
        imported = import_graph(raw, trainable=True, device="cuda")
        _sd_attach_loss(imported, SD_LR, True)
        cases = [
            ("imported", f"imported BERT-base widths, {SD_CKPT_LAYERS} layers", imported,
             _bert_feeds(np, SD_BATCH, SD_SEQ, 2)),
            ("code", f"code-built BERT, {SD_CKPT_LAYERS} blocks",
             _code_bert(np, "cuda", SD_CKPT_LAYERS, SD_VOCAB, True), _code_feeds(np, 2))]
        for _, _, sd, feeds in cases:
            sd.fit_batch(feeds[0])
        torch.cuda.synchronize()

        def save(key, sd):
            path = os.path.join(SD_DIR, f"{key}.zip")
            t0 = time.perf_counter()
            sd.save(path)
            return path, time.perf_counter() - t0

        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(cases)) as pool:
            futures = [pool.submit(save, key, sd) for key, _, sd, _ in cases]
            saved = [f.result() for f in futures]
        res = {"saves_wall_s": time.perf_counter() - t0}
        for (key, tag, sd, feeds), (path, save_s) in zip(cases, saved):
            size = os.path.getsize(path)
            log(f"[samediff] zip {tag}: {size} bytes saved in {save_s:.2f}s (both zips' "
                f"saves side by side: {res['saves_wall_s']:.2f}s)")
            load_s, got = _sd_resumed(torch, sd, path, feeds[1], tag, "plain")
            res[key] = {"bytes": size, "save_s": save_s, "load_s": load_s, "loss": got}
        del cases, imported
    finally:
        shutil.rmtree(SD_DIR, ignore_errors=True)
    return res


def _loop_graph(np, seed=0) -> bytes:
    """examples/finetune_imported.py's frozen graph, written by the port's
    writer: x -> [V1 while frame: h = tanh(h @ W_loop), 4 trips] ->
    logits = h @ W_head."""
    from deeplearning4j_tpu_torch.modelimport._tf.synthetic import FrozenGraphWriter

    rng = np.random.default_rng(seed)
    w = FrozenGraphWriter()
    INT, FLT = {"T": 3}, {"T": 1}
    x = w.placeholder("x", np.float32, [None, SD_LOOP_D])
    w_loop = w.const("W_loop", (rng.normal(size=(SD_LOOP_D, SD_LOOP_D)) * 0.4)
                     .astype(np.float32))
    w_head = w.const("W_head", (rng.normal(size=(SD_LOOP_D, SD_LOOP_K)) * 0.4)
                     .astype(np.float32))
    i0 = w.const("i0", np.asarray(0, np.int32))
    n = w.const("n_trips", np.asarray(SD_LOOP_TRIPS, np.int32))
    one = w.const("one", np.asarray(1, np.int32))
    ei = w.node("Enter", "rec/enter_i", [i0], types=INT, frame_name="rec", is_constant=False)
    eh = w.node("Enter", "rec/enter_h", [x], types=FLT, frame_name="rec", is_constant=False)
    ew = w.node("Enter", "rec/enter_W", [w_loop], types=FLT, frame_name="rec",
                is_constant=True)
    en = w.node("Enter", "rec/enter_n", [n], types=INT, frame_name="rec", is_constant=True)
    e1 = w.node("Enter", "rec/enter_one", [one], types=INT, frame_name="rec",
                is_constant=True)
    mi = w.node("Merge", "rec/merge_i", [ei, "rec/next_i"], types=INT, N=2)
    mh = w.node("Merge", "rec/merge_h", [eh, "rec/next_h"], types=FLT, N=2)
    less = w.node("Less", "rec/less", [mi, en], types=INT)
    lc = w.node("LoopCond", "rec/cond", [less])
    si = w.node("Switch", "rec/switch_i", [mi, lc], types=INT)
    sh = w.node("Switch", "rec/switch_h", [mh, lc], types=FLT)
    inc = w.node("AddV2", "rec/inc", [f"{si}:1", e1], types=INT)
    mm = w.node("MatMul", "rec/matmul", [f"{sh}:1", ew], types=FLT,
                transpose_a=False, transpose_b=False)
    th = w.node("Tanh", "rec/tanh", [mm], types=FLT)
    w.node("NextIteration", "rec/next_i", [inc], types=INT)
    w.node("NextIteration", "rec/next_h", [th], types=FLT)
    w.node("Exit", "rec/exit_h", [sh], types=FLT)
    w.matmul("rec/exit_h", w_head, name="head")
    w.node("Identity", "logits", ["head"], types=FLT)
    return w.serialize()


def _sd_loop(torch, np):
    """(d) the imported V1 loop fine-tuned on the card against the same
    steps on the CPU; then its source-backed zip, which its control flow
    calls for, resumed on the card."""
    from deeplearning4j_tpu_torch.modelimport.tensorflow import import_graph

    raw = _loop_graph(np)
    rng = np.random.default_rng(1)
    y_idx = rng.integers(0, SD_LOOP_K, SD_LOOP_B)
    x = (rng.normal(0, 1, (SD_LOOP_B, SD_LOOP_D)) + 1.2 * y_idx[:, None]).astype(np.float32)
    feed = {"x": x, "labels": np.eye(SD_LOOP_K, dtype=np.float32)[y_idx]}
    runs = {}
    for device in ("cuda", "cpu"):
        sd = import_graph(raw, trainable=True, device=device)
        (wnode,) = [op for op in sd._ops if op.op == "_while"]
        if not (wnode.attrs["max_trip"] == SD_LOOP_TRIPS and wnode.attrs["exact_trip"]
                and "W_loop" in sd._trainable):
            raise AssertionError(f"[samediff] loop import on {device}: {wnode.attrs}, "
                                 f"trainables {sorted(sd._trainable)}")
        _sd_attach_loss(sd, 5e-2, False)
        w0 = sd.get_value("W_loop")
        losses = [sd.fit_batch(feed) for _ in range(SD_LOOP_STEPS)]
        runs[device] = {"losses": losses,
                        "moved": float(np.abs(sd.get_value("W_loop") - w0).max()),
                        "graphs": len(sd._captured)}
        if device == "cuda":
            card_sd = sd
    os.makedirs(SD_DIR, exist_ok=True)
    try:
        path = os.path.join(SD_DIR, "loop.zip")
        t0 = time.perf_counter()
        card_sd.save(path)
        zip_res = {"bytes": os.path.getsize(path), "save_s": time.perf_counter() - t0}
        zip_res["load_s"], zip_res["loss"] = _sd_resumed(
            torch, card_sd, path, feed, "imported V1 loop", "source-backed")
    finally:
        shutil.rmtree(SD_DIR, ignore_errors=True)
    card, cpu = runs["cuda"], runs["cpu"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(card["losses"], cpu["losses"]))
    log(f"[samediff] imported V1 loop (max_trip {SD_LOOP_TRIPS}, exact): card losses "
        f"{card['losses']} ({card['graphs']} step graph), CPU {cpu['losses']}; "
        f"{rel:.3e} relative (tol {SD_LOOP_TOL:.0e}); the in-loop weight moved "
        f"{card['moved']:.4f}")
    if not (rel <= SD_LOOP_TOL and card["moved"] > 1e-4 and card["graphs"] == 1
            and card["losses"][-1] < card["losses"][0]):
        raise AssertionError(f"[samediff] imported loop: {runs}")
    return {"runs": runs, "rel_err": rel, "zip": zip_res}


def phase_samediff(torch, np, kernels, timer):
    """SameDiff and the TF importer (ROADMAP A13, first part): (a)
    config 4, (b) the code-built BERT through B1-B3, (c) the zips, (d)
    the imported loop."""
    res = {"config4": _sd_config4(torch, np, kernels)}
    res["code"] = _sd_code(torch, np, kernels, timer)
    res["kernel_rows"] = res["code"].pop("kernel_rows")
    res["zips"] = _sd_zips(torch, np)
    res["loop"] = _sd_loop(torch, np)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma list out of {PHASES + EXTRA_PHASES}")
    ap.add_argument("--package-root", default=None,
                    help="run the port found in this checkout (another commit "
                         "unpacked with git archive) instead of this one")
    args = ap.parse_args(argv)
    forced = os.environ.get("DL4JTPU_QUANT_KERNEL", "").strip().lower()
    if forced not in ("", "auto"):
        print(f"chip_smoke: DL4JTPU_QUANT_KERNEL={forced!r}: the quantized products "
              "run kernel B5 on the card; unset it (or set auto)", file=sys.stderr)
        return 2
    phases = [p for p in args.phases.split(",") if p]
    if any(p not in PHASES + EXTRA_PHASES for p in phases):
        ap.error(f"unknown phase in {phases}")
    if args.package_root is not None:
        root = os.path.abspath(args.package_root)
        if not os.path.isdir(os.path.join(root, "deeplearning4j_tpu_torch")):
            ap.error(f"no deeplearning4j_tpu_torch package under {root}")
        sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "measures the GPU and has no CPU mode", file=sys.stderr)
        return 2
    import numpy as np

    from deeplearning4j_tpu_torch.runtime import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log(smi)
    log(f"[identity] {kind}; torch {torch.__version__}; CUDA {torch.version.cuda}; "
        f"capability {torch.cuda.get_device_capability(0)}; python {sys.version.split()[0]}")
    report = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
              "package": os.path.dirname(os.path.dirname(os.path.abspath(kernels.__file__)))}
    log(f"[identity] port under test: {report['package']}")

    t0 = time.perf_counter()
    paths = kernels.build_all()
    report["build_s"] = time.perf_counter() - t0
    log(f"[build] {len(paths)} libraries in {report['build_s']:.1f}s")
    serialized = []
    for stem, path in paths.items():
        logf = path.with_suffix(".log")
        if logf.exists():
            for line in logf.read_text(errors="replace").splitlines():
                if ("registers" in line or "spill" in line
                        or "warning" in line.lower() or "Performance Loss" in line):
                    log(f"[build] {stem}: {line.strip()}")
                if "wgmma.mma_async instructions are serialized" in line:
                    serialized.append(f"{stem}: {line.strip()}")
    if serialized:   # every product would wait for the one before it
        raise AssertionError("ptxas serialised the wgmma pipeline:\n" + "\n".join(serialized))
    if args.package_root is None:
        report["sass"] = check_sass(paths)
    else:   # another tree's kernels, compared, not held to this tree's SASS
        log("[build] SASS checks skipped: --package-root runs another tree's port")

    timer = Timer(torch)
    report["phase_s"] = phase_s = {}
    clock = [time.perf_counter()]

    def done(name):
        now = time.perf_counter()
        phase_s[name] = now - clock[0]
        clock[0] = now
        log(f"[time] {name}: {phase_s[name]:.1f}s")

    rows = []
    if "kernels" in phases:
        rows, report["flash_attention_layout"], report["timer_floor"] = phase_kernels(
            torch, timer)
        report["flash_fwd_fault"] = flash_fwd_fault_case(torch)
        done("kernels")
    elif "paged" in phases:
        rows, report["timer_floor"] = phase_paged(torch, timer)
        done("paged")
    if "stages" in phases:
        report["stages"] = stages_case(torch, timer)
        done("stages")
    report["kernel_phase"] = rows
    if "train" in phases:
        report["train"] = phase_train(torch, np, kernels)
        done("train")
    if "train_f32" in phases:
        report["train_f32"] = phase_train(torch, np, kernels, f32=True)
        done("train_f32")
    if "lenet" in phases:
        report["lenet"] = phase_lenet(torch, np, kernels, timer)
        rows = rows + report["lenet"]["kernel_rows"]
        done("lenet")
    if "serve" in phases:
        report["serve"] = phase_serve(torch, np, kernels)
        done("serve")
    if "server" in phases:
        report["server"] = phase_server(torch, np, kernels)
        done("server")
    if "fleet" in phases:
        report["fleet"] = phase_fleet(torch, np, kernels, report)
        done("fleet")
    if "spec" in phases:
        report["spec"] = phase_spec(torch, np, kernels)
        done("spec")
    if "profile" in phases:
        report["profile"] = phase_profile(torch, np)
        done("profile")
    refs = None
    if "parity" in phases:
        report["parity"], refs = phase_parity(torch, np, kernels)
        done("parity")
    if "int8" in phases:
        report["int8"], _ = phase_parity(torch, np, kernels, kv_dtype="int8",
                                         gate=0.9, refs=refs)
        done("int8")
    if "quant" in phases:
        report["quant"] = phase_quant(torch, np, kernels, timer)
        rows = rows + report["quant"]["kernel_rows"]
        done("quant")
    if "qserve" in phases:
        report["qserve"] = phase_qserve(torch, np, kernels, report, timer)
        rows = rows + report["qserve"]["kernel_rows"]
        done("qserve")
    if "ckpt" in phases:
        report["ckpt"] = phase_ckpt(torch, np, kernels)
        done("ckpt")
    if "attn" in phases:
        report["attn"] = phase_attn(torch, np, kernels, timer)
        rows = rows + report["attn"]["kernel_rows"]
        done("attn")
    if "resnet" in phases:
        report["resnet"] = phase_resnet(torch, np, kernels, timer)
        rows = rows + report["resnet"]["kernel_rows"]
        done("resnet")
    if "etl" in phases:
        report["etl"] = phase_etl(torch, np, kernels, smi)
        done("etl")
    if "tools" in phases:
        report["tools"] = phase_tools(torch, np, kernels, report)
        done("tools")
    if "rnn" in phases:
        report["rnn"] = phase_rnn(torch, np, kernels, timer)
        rows = rows + report["rnn"]["kernel_rows"]
        done("rnn")
    if "dp" in phases:
        report["dp"] = phase_dp(torch, np, kernels)
        done("dp")
    if "mp" in phases:
        report["mp"] = phase_mp(torch, np, kernels, timer)
        rows = rows + report["mp"]["kernel_rows"]
        done("mp")
    if "samediff" in phases:
        report["samediff"] = phase_samediff(torch, np, kernels, timer)
        rows = rows + report["samediff"]["kernel_rows"]
        done("samediff")

    entries = []
    def row(name, dtype="bf16", t=None, shape=None, causal=True, mix=None, among=None):
        """The first of ``among`` (every phase's rows by default) that matches."""
        return next((r for r in (rows if among is None else among)
                     if r["name"] == name and r["dtype"] == dtype
                     and (t is None or r["shape"][1] == t)
                     and (shape is None or r["shape"] == shape)
                     and r.get("causal", True) == causal
                     and r.get("mix") == mix), None)

    dh = D_MODEL // HEADS
    train_bhtd = [TRAIN_BATCH * HEADS, TRAIN_SEQ, dh]
    # each main-path row with the path whose measured run counted its
    # launches (counters zeroed just before that run, read just after)
    main_rows = [
        (row("flash_fwd", shape=train_bhtd), "train"),
        (row("flash_fwd", shape=[HEADS, SERVE_LENGTHS[0], dh]), "serve"),  # the long prefill
        (row("flash_fwd", dtype="f32", shape=[QUANT_BATCH * HEADS, QUANT_SEQ, dh]), "quant"),
        (row("flash_bwd_dq", shape=train_bhtd), "train"),
        (row("flash_bwd_dkdv", shape=train_bhtd), "train"),
        # f32 training (bf16_compute=False)
        (row("flash_fwd", dtype="f32", shape=train_bhtd), "train_f32"),
        (row("flash_bwd_dq", dtype="f32", shape=train_bhtd), "train_f32"),
        (row("flash_bwd_dkdv", dtype="f32", shape=train_bhtd), "train_f32"),
        (row("paged_attention_fwd", dtype="f32", mix="serve"), "serve"),
        # the serving plane: /v1/generate's decode steps, /v1/infer's batches
        (row("paged_attention_fwd", dtype="f32", mix="serve"), "server"),
        (row("flash_fwd", shape=[INFER_BATCH * HEADS, INFER_SEQ, dh]), "server/infer"),
        # the fleet: r0's prefills and r1's decode steps; routed batches
        (row("flash_fwd", shape=[HEADS, SERVE_LENGTHS[0], dh]), "fleet"),
        (row("paged_attention_fwd", dtype="f32", mix="serve"), "fleet"),
        (row("flash_fwd", shape=[INFER_BATCH * HEADS, INFER_SEQ, dh]), "fleet/infer"),
        # the verify's B4 on pseudo-slots
        (row("paged_attention_chunk", dtype="f32", mix="verify"), "spec"),
        (row("paged_attention_chunk_int8", dtype="int8", mix="verify"), "spec/int8"),
        (row("paged_attention_fwd_int8", dtype="int8", mix="serve"), "int8"),
        # the W1 product of the quantized flagship
        (row("dequant_matmul", dtype="int8",
             shape=[QUANT_BATCH * QUANT_SEQ, D_MODEL, 4 * D_MODEL]), "quant"),
        # the quantized engine: the long prompt's f32 prefill, B5's rows
        # route at the decode step's products and head, and at the verify's
        (row("flash_fwd", dtype="f32", shape=[HEADS, SERVE_LENGTHS[0], dh]), "qserve"),
    ] + [(row("dequant_matmul", dtype="int8", shape=[m, k, n]),
          "qserve" if m == ENGINE["slots"] else "qserve/spec")
         for m, k, n in [(8, D_MODEL, 4 * D_MODEL)] + DM_SERVE_SHAPES] + [
        # quantized LeNet's Dense and head over the evaluation batches, and
        # the entry's 8 images
        (row("dequant_matmul", dtype="int8", shape=[m, k, n]),
         "lenet/entry" if m == 8 else "lenet") for m, k, n in LENET_DM_SHAPES] + [
        # the attention slice: the MoE flagship's training steps, the masked
        # classifier's unmasked output() and its quantized masked output()
        (row("flash_fwd", shape=train_bhtd), "attn/moe"),
        (row("flash_bwd_dq", shape=train_bhtd), "attn/moe"),
        (row("flash_bwd_dkdv", shape=train_bhtd), "attn/moe"),
        (row("flash_fwd", shape=[CLS_BATCH * CLS_HEADS, CLS_SEQ, CLS_D // CLS_HEADS],
             causal=False), "attn/cls/unmasked"),
        # the MoE flagship's output() of 2 x 2048 ids; the classifier's f32
        # rows run alone (the longest row's shape; every length is checked)
        (row("flash_fwd", shape=[QUANT_BATCH * HEADS, TRAIN_SEQ, dh]), "attn/moe/output"),
        (row("flash_fwd", dtype="f32", causal=False, shape=[
            CLS_HEADS, max(report.get("attn", {}).get("cls", {}).get("alone", {})
                           .get("lengths", [0])), CLS_D // CLS_HEADS]), "attn/cls/alone"),
    ] + [(row("dequant_matmul", dtype="int8", shape=[m, k, n]), "attn/cls/quant")
         for m, k, n in CLS_DM_SHAPES] + [
        # the ResNet-50 slice: the quantized graph's head, and the
        # AttentionVertex graph's output() in bf16 and f32
        (row("dequant_matmul", dtype="int8", shape=list(RESNET_DM_SHAPE)), "resnet/quant"),
        (row("flash_fwd", causal=False, shape=[AV_BATCH * AV_HEADS, AV_SEQ, AV_D // AV_HEADS]),
         "resnet/attn/bf16"),
        (row("flash_fwd", dtype="f32", causal=False,
             shape=[AV_BATCH * AV_HEADS, AV_SEQ, AV_D // AV_HEADS]),
         "resnet/attn/f32"),
        # the training tooling slice: the flagship's fine-tune under early
        # stopping (its frozen prefix launches no backward kernel)
        (row("flash_fwd", shape=train_bhtd), "tools/ft"),
        (row("flash_bwd_dq", shape=train_bhtd), "tools/ft"),
        (row("flash_bwd_dkdv", shape=train_bhtd), "tools/ft"),
        # the recurrent slice: the quantized char-RNN's head over 64 x 200
        # characters (output()) and over 8 streams a step (rnn_time_step)
        (row("dequant_matmul", dtype="int8", shape=list(RNN_DM_SHAPES[0])), "rnn/quant"),
        (row("dequant_matmul", dtype="int8", shape=list(RNN_DM_SHAPES[1])),
         "rnn/quant_stream"),
        # data parallelism: the flagship through ParallelWrapper on each
        # NCCL rank (rank 0's counts)
        (row("flash_fwd", shape=train_bhtd), "dp/flagship"),
        (row("flash_bwd_dq", shape=train_bhtd), "dp/flagship"),
        (row("flash_bwd_dkdv", shape=train_bhtd), "dp/flagship"),
        # model parallelism: the flagship's blocks under model=n and the MoE
        # flagship's under expert=n (whole heads, the training shape), and
        # Ulysses' local attention on B x H / n heads of the whole sequence
        # (rank 0's counts; ring attention launches none)
        (row("flash_fwd", shape=train_bhtd), "mp/tp"),
        (row("flash_bwd_dq", shape=train_bhtd), "mp/tp"),
        (row("flash_bwd_dkdv", shape=train_bhtd), "mp/tp"),
        (row("flash_fwd", shape=train_bhtd), "mp/ep"),
        (row("flash_bwd_dq", shape=train_bhtd), "mp/ep"),
        (row("flash_bwd_dkdv", shape=train_bhtd), "mp/ep"),
    ] + [(row(name, shape=[TRAIN_BATCH * HEADS // report.get("mp", {}).get("n", 2),
                           TRAIN_SEQ, dh]), "mp/ulysses")
         for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv")] + [
        # pipeline parallelism: each stage's blocks a microbatch at a time
        # (rank 0's counts)
        (row(name, shape=[TRAIN_BATCH * HEADS // MP_PP_MICRO, TRAIN_SEQ, dh]), path)
        for path in ("mp/gpipe", "mp/1f1b")
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv")] + [
        # SameDiff: the code-built BERT's multi_head_dot_product_attention
        # ops, B1 forward and B2 / B3 backward, in bf16 and f32 steps, with
        # the samediff phase's own rows (attn and resnet time the same shape)
        (row(name, dtype=kind, causal=False,
             shape=[SD_BATCH * SD_HEADS, SD_SEQ, SD_D // SD_HEADS],
             among=report.get("samediff", {}).get("kernel_rows", [])), f"samediff/code/{kind}")
        for kind in ("bf16", "f32") for name in FLASH_NAMES]
    sources = {
        "flash_fwd": ("deeplearning4j_tpu_torch/csrc/flash_fwd.cu",
                      "deeplearning4j_tpu/ops/flash_attention.py:35"),
        "flash_bwd_dq": ("deeplearning4j_tpu_torch/csrc/flash_bwd.cu",
                         "deeplearning4j_tpu/ops/flash_attention.py:141"),
        "flash_bwd_dkdv": ("deeplearning4j_tpu_torch/csrc/flash_bwd.cu",
                           "deeplearning4j_tpu/ops/flash_attention.py:189"),
        "paged_attention_fwd": ("deeplearning4j_tpu_torch/csrc/paged_attention.cu",
                                "deeplearning4j_tpu/ops/paged_attention.py:121"),
        "paged_attention_fwd_int8": ("deeplearning4j_tpu_torch/csrc/paged_attention.cu",
                                     "deeplearning4j_tpu/ops/paged_attention.py:121"),
        "paged_attention_chunk": ("deeplearning4j_tpu_torch/csrc/paged_attention.cu",
                                  "deeplearning4j_tpu/ops/paged_attention.py:121"),
        "paged_attention_chunk_int8": ("deeplearning4j_tpu_torch/csrc/paged_attention.cu",
                                       "deeplearning4j_tpu/ops/paged_attention.py:121"),
        "dequant_matmul": ("deeplearning4j_tpu_torch/csrc/dequant_matmul.cu",
                           "deeplearning4j_tpu/ops/dequant_matmul.py:146"),
    }
    designs = {   # the kernels redesigned for Hopper
        "flash_fwd_wgmma": "warp-specialised: a TMA producer warpgroup keeps a 3-stage "
                           "K/V mbarrier ring full; 2 consumer warpgroups x 64 query "
                           "rows run S by wgmma m64n128k16 from shared memory and P V "
                           "with P in registers, taking turns on named barriers "
                           "(ping-pong)",
        "flash_fwd_split": "f32 at f32 accuracy on bf16 wgmma: a pre-pass splits "
                           "Q * scale, K, V into bf16 hi/lo parts; the bf16 "
                           "kernel's TMA producer, ping-pong consumers and 2-stage "
                           "ring of 64-key tiles; S and P V each as three part "
                           "products (hi hi, hi lo, lo hi), P split in registers",
        "dequant_matmul_wgmma": "x split into bf16 hi/lo parts by a pre-pass; TMA "
                                "4-stage ring of x parts and int8 q; 3 converter "
                                "warps widen q to bf16 in shared memory; 2 consumer "
                                "warpgroups run wgmma m64n128k16 a part, each K "
                                "slab's sum added to f32 registers",
        "flash_bwd_dq_wgmma": "wgmma bf16 -> f32, 2 warpgroups x 64 query rows, "
                              "cp.async ring of 2 K/V stages",
        "flash_bwd_dkdv_wgmma": "wgmma bf16 -> f32, 2 warpgroups x 64 key rows, "
                                "cp.async ring of 2 Q/g stages",
        "flash_bwd_dq_split": "f32 at f32 accuracy on bf16 wgmma: the dQ call's pre-pass "
                              "splits Q * scale, K, V, g into bf16 hi/lo parts and "
                              "computes delta with the same split; 2 warpgroups x 64 "
                              "query rows, a 3-stage TMA ring of 32-key K/V part tiles "
                              "refilled by the last warp to release a stage; S and dP "
                              "as three m64n32k16 part products from shared memory, dS "
                              "split in registers, dQ += dS K as three part products, "
                              "each tile's sum added in f32 registers",
        "flash_bwd_dkdv_split": "f32 at f32 accuracy on bf16 wgmma: the dQ call's split "
                                "parts and delta; 2 warpgroups x 64 key rows, a 3-stage "
                                "TMA ring of 32-query Q/g part tiles; S^T and dP^T as "
                                "three m64n32k16 part products, P^T and dS^T split in "
                                "registers, dV += P^T g and dK += dS^T Q as three part "
                                "products, each column block's sum added in f32 registers",
        "paged_attention_fwd": B4_DESIGN,
        "paged_attention_fwd_int8": B4_DESIGN,
        "paged_attention_chunk": B4_DESIGN + "; the verify's chunk as S x C pseudo-slots, "
                                 "each slot's table row repeated C times",
    }
    for r, path in main_rows:
        if r is None:
            continue
        name = r["name"]
        src, replaces = sources[name]
        ran = report
        for part in path.split("/"):          # "spec/int8": a run inside a phase
            ran = ran.get(part, {})
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": ran.get("launches", {}).get(name, 0),
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "path": path, "dtype": r["dtype"], "shape": r["shape"],
        }
        design = designs.get(r.get("kernel", name))
        if design is not None:
            entry["kernel"] = r.get("kernel", name)
            entry["design"] = design
        entries.append(entry)
    if "int8" in report and report["int8"]["launches"].get("paged_attention_fwd_int8", 0) <= 0:
        raise AssertionError("the int8 engine never launched the int8 kernel")

    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
