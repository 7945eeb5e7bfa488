#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py [--seed N]

Phases, each printing its own lines; any failure raises and the script
exits non-zero without the final `ok` line. Each step or request "under
torch.profiler" is captured after a pad of spin kernels and counted from
the end of the pad (profiled_spans), since the profiler can lose events
at the start of a capture:

  1. device   the card's name, torch/CUDA versions, nvidia-smi's name and
              power limit; TF32 as torch leaves it (the port's Executor
              turns cuDNN's off, phase 26).
  2. build    compiles the CUDA kernels from paddle_tpu_torch/csrc, one nvcc
              per source, all started together; prints ptxas's registers
              and shared memory.
  3. kernel   gru_fwd (csrc/gru_fwd.cu) against gru_fwd_plain on the card,
              on x from the full-width artifact's lookup_table + mul for a
              ragged request: forward and reverse, f32 and bf16; errors
              beside their tolerances, both times (the bf16 one beside its
              time before the redesign), the kernel's bound, and how the
              card takes the bf16 kernel (CTAs an SM, batch groups,
              sub-tiles a group). Then small shapes whose H does not divide
              into the f32 kernel's column slices, and the bf16 kernel's own
              edges (GRU_TC_EDGE: T=1, H=100 and 301, B=3 and 40, a row
              masked at every step, more sub-tiles than groups, W past
              shared memory); bf16 outputs the same bits in two runs.
  4. slice    the NMT beam-search artifact at bench.py run_infer's widths
              (V=30000, H=512, S=50, beam 4, max_len 32), seeded weights,
              bf16 amp: 3 requests of 128 ragged sentences through
              load_inference_model + Executor.run; shapes, ranges, score
              order, and 2 gru_fwd launches per request; then one more
              request under torch.profiler: device busy share and device
              time by kernel.
  5. parity   the same program at a small width, card (kernel) against
              CPU (plain versions): f32, then bf16 amp.
  6. train    bench.py's NMT training program (artifacts/nmt_train_wmt:
              V=30000, emb = hidden = 512, lengths 50, B=256, bf16 amp):
              its startup program on the card, then a warm-up step on one
              ragged batch of 256 pairs, recording the inputs the step
              hands each training kernel.
  7. kernels  gru_fwd at the step's B=256 and gru_bwd (csrc/gru_bwd.cu),
              then attn_fwd, attn_bwd_step and attn_phase2
              (csrc/bahdanau_attn.cu) against their plain versions on the
              card: on the warm-up step's own inputs, in bf16 and in f32,
              then on seeded inputs at the main path's shapes and at edge
              shapes (gru_bwd also at GRU_TC_EDGE, where T=1 holds dW to
              exactly 0), where each output must also lie above its
              tolerance (an output left at zero fails); errors beside their
              tolerances, kernel, plain and bound times (the bf16 GRU
              kernels' beside their times before the redesign), the GRU
              kernels' outputs the same bits in two runs. attn_fwd in bf16
              runs on staged rows of the valid positions (attn_fwd_path),
              attn_bwd_step on a cluster of CTAs a row that splits the
              row's listed positions (attn_bwd_path, attn_bwd_cluster),
              attn_phase2 on a walk over the nonzero terms (in both io
              dtypes): each also at ATTN_ROW_EDGE (a non-prefix
              mask, a fully masked row, S=300 streamed through the ring)
              and attn_bwd_step at ATTN_BWD_EDGE (rows with dctx = 0, lists
              that split unevenly over the ranks, a single valid position;
              ddp and dsc exactly 0 where they are 0), each first design
              held and timed beside it; B5 and B7 timed with the wrapper
              and on the device (a CUDA graph's replay) at the step's own
              inputs, B7 and B6 the same bits in two runs; B6 held and
              timed over the step's 50 calls (one graph's replay of the
              50, and from Python), its first design on the same 50, the
              bound over live rows, the t = 0 and t = 49 calls on their
              own with B6's phases by its timed instance
              (attn_bwd_step_phase_us); B5's and B6's host floors (the
              call on B=1, S=1).
  8. steps    3 timed training steps on the same batch with the launch
              counts set to 0 just before: finite, falling losses, median
              ms per step, target tokens/s, exact launches per step (every
              attn_fwd and attn_bwd_step on the bulk-copy path); then one
              more step under
              torch.profiler.
  9. parity   the small training program (artifacts/nmt_train_small), card
              against CPU from the same state and feeds: losses and the
              state after 2 Adam steps, f32 then bf16 amp.
  10. lstm    bench.py's lstm program (V=30000, emb 128, H=512, T=100,
              B=128, bf16; Adam(2e-3), L2Decay(8e-4), global-norm clip 25),
              built by the port's own layer DSL and optimizer front end:
              its startup program on the card, then a warm-up step on
              bench.py's feed, recording the LSTM kernels' inputs.
  11. kernels lstm_fwd and lstm_bwd (csrc/lstm_fwd.cu, csrc/lstm_bwd.cu)
              against their plain versions on the card: the warm-up step's
              inputs (forward, forward reversed, backward; bf16 and f32),
              then seeded inputs with a ragged mask at the main path's
              shapes and at edge shapes, then both at the bf16 kernels'
              own edge shapes (T=1, H=100 with a row masked at every step,
              more row tiles than groups, W past shared memory); errors
              beside their tolerances, an output left at zero failing, the
              backward's dx and dW the same bits in two runs, kernel,
              plain, bound and cuDNN (torch.nn.LSTM, the yardstick) times,
              each beside its time before the redesign.
  12. steps   3 timed LSTM training steps with the launch counts set to 0
              just before: finite, falling losses, exactly 2 lstm_fwd and
              2 lstm_bwd launches a step, median ms per step, tokens/s,
              peak memory; then one more step under torch.profiler.
  13. parity  the same program at a small width (V=64, emb 32, H=384, T=6,
              B=8), card against CPU: losses and the state after 2 Adam
              steps, f32 then bf16 amp.
  14. tfm     bench.py's transformer LM (the `all` sweep's row: dim 2048,
              32 heads of D=64, 8 layers, FFN 8192, T=1024, vocab 32000,
              B=8, causal, bf16; Adam(3e-4)), built by the port's own front
              end: its startup program on the card, then a warm-up step on
              bench.py's feed, recording the flash kernels' inputs; the
              parameter count and the peak memory.
  15. kernels flash_fwd, flash_bwd_dkv and flash_bwd_dq (csrc/flash_attn.cu)
              against their plain versions on the card: the warm-up step's
              inputs of layers 0 and 7, then seeded inputs at ragged T
              (1 to 1024, within one tile of 64 and 128), H=1 and odd,
              causal and not, D=64 and 128, bf16 and f32, and the backward
              on packed q, k, v views and a strided dO, the forward on
              the packed views and at the main shape, bf16 and f32, causal
              and full; the same bits in two runs of every kernel at the
              main shape and an edge shape; kernel, plain and bound times,
              the forward's beside its time before the redesign, and
              scaled_dot_product_attention's (the yardstick) beside the
              forward and the backward pair.
  16. steps   3 timed transformer training steps with the launch counts set
              to 0 just before: finite, falling losses, exactly 8 launches
              of each flash kernel a step and no attention routed to the
              plain formula, median ms per step, tokens/s,
              peak memory; then one more step under torch.profiler, and
              the step's flash time, forward and backward.
  17. parity  a small transformer program (dim 128, 2 heads of D=64, 2
              layers, T=200, vocab 512, B=4), card against CPU from one
              startup state: losses and the state after 2 Adam steps, f32
              then bf16 amp.
  18. resnet  bench.py's ResNet-50 training program (resnet_imagenet depth
              50, NHWC 224x224x3, 1000 classes, Momentum(0.1, 0.9), B=128,
              bf16), built by the port's own front end, in the slice's
              configuration: fused_conv_dot_max_n = 128·56·56 and
              fused_conv_pallas, so each of its 36 fused_conv_bn ops runs
              the hand-written kernel; its startup program on the card,
              then a warm-up step on bench.py's feed, recording the
              kernel's inputs; the parameter count and the peak memory.
  19. kernels fused_conv_bn (csrc/fused_conv_bn.cu, its statistics summed
              in the same launch) against its plain version on the card:
              the warm-up step's own inputs at each of its shapes (bf16; f32
              on two of them), then seeded edge cases (N not a multiple of
              the row tile, N below one tile, Cin 64 and 96, Cout 192, the
              prologue and ReLU on and off, a stride-2 view, W too large to
              stay in shared memory); y beyond one bf16 ulp, s and sq, every
              output nonzero, the same bits in two runs; kernel (with the
              wrapper, and its device time alone from a CUDA graph's
              replay), plain, bound and torch.matmul (the yardstick) times,
              summed over a step beside the time before the redesign.
  20. steps   3 timed ResNet-50 training steps with the launch counts set
              to 0 just before: finite, falling losses, exactly 36 kernel
              launches a step and no input copied, median ms
              per step, images/s, the share of the bf16 peak for bench.py's
              3 × 8.2 GFLOP an image, peak memory; one more step under
              torch.profiler; then, as context, the same step on the
              default route (each 1x1 conv a cuDNN conv).
  21. parity  the full-width step's own bn_stats and batch_norm calls with
              bn_bf16_stats on (the default), card against CPU: batch and
              running statistics, batch_norm's output, and what each would
              read left at zero; then the small ResNet-50 program of
              tests/test_torch_resnet.py (64x64, B=4, 10 classes, lr 1e-5),
              card against CPU from one startup state: losses, gradients,
              velocities, parameters and BN running statistics after 2
              Momentum steps, f32 then bf16 (its statistics squared in
              f32); as context, bf16 with the default bn_bf16_stats, and
              moved images on the CPU.
  22. nmt     bench.py's NMT training program (V=30000, emb = hidden = 512,
              S = T = 50, B=256, Adam(5e-4), bf16), built by the port's own
              front end (its main and startup equal to
              artifacts/nmt_train_wmt/), with the whole-sequence decoder
              (fused_attention_seq_fwd/_bwd on): its startup on the card, the
              parameter count, then a warm-up step on bench.py's
              RandomState(0) feed, recording B9's and B10's inputs.
  23. kernels decoder_seq_fwd and decoder_seq_bwd (csrc/decoder_seq.cu)
              against their plain versions on the card: the warm-up step's
              inputs (bf16 and f32), then seeded inputs with ragged source
              and target masks and a row with no target step, at the main
              path's shapes (with a misplaced rounding that the bf16 bound
              must catch) and at edge shapes (T=1, the bf16 backward's batch
              groups at B=64 and 65), each output beside what it would read
              left at zero; the bf16 forward's route and plan and the
              backward's plan at each shape; the same bits in two runs of
              both; the bf16 forward's four phases by its timed instance
              and its first design held and timed beside it; the
              backward's post-walk d(enc_proj)/dv pass (decoder_seq_dep, on
              B7's walk with t newest first) against its plain version on
              the walk's own dsc, the same bits in two runs, its time
              beside the pass it replaced; kernel, plain and bound times.
  24. steps   3 timed steps with the launch counts set to 0 just before:
              finite, falling losses, exactly 1 decoder_seq_fwd (on the
              route seq_fwd_route gives the main shape), 1 decoder_seq_bwd,
              1 decoder_seq_dep, 2 gru_fwd, 2 gru_bwd and no per-step
              attention launch a step, median ms per step, target tokens/s,
              peak memory, one profiled step; then, as context, 3 steps of
              the per-step route (the seq flags off).
  25. parity  the same program at the small width (V=64, emb 32, H=128, T=6,
              B=8), card against CPU with the seq flags on: losses and the
              state after 2 Adam steps, f32 then bf16 amp.
  26. tf32    torch's TF32 defaults restored, an Executor made for the card,
              an f32 conv2d program: its output within 1e-5 of float64's
              largest, where cuDNN with TF32 lies about 3e-4 away.
  27. int8   quant_matmul (csrc/quant_matmul.cu, B12) against its plain
              version (float64) on the card, tolerance 0, each call on the
              route quant_kernels.kernel_route names: the site shapes of the
              transformer and MLP requests and M in {1, 8, 17, 64, 65, 127,
              8193} x K in {32, 48, 8192} x N in {24, 256, 1000} on the
              wgmma route, K=40 on the kept mma.sync route; each shape with
              K % 16 == 0 also on the kept route (equal, timed beside, not
              counted); every value -128 then 127 at the
              largest K, the same bits in two runs on each route; kernel,
              bound, plain and torch._int_mm (the yardstick,
              with the weight column-major as cuBLASLt's int8 kernels want
              it and row-major as it lies) times, summed over a request.
  28. serve   bench.py's transformer LM at the `all` sweep's row, is_test,
              built by the port's front end from --seed: saved, loaded,
              calibrated in bf16 on the JAX `quant` command's 8 synthetic
              samples (B=4), converted (49 sites), saved, loaded (sidecar
              checked), then 3 requests of B=8 x 1024 tokens in bf16 with
              the launch counts set to 0 just before: exactly 49 quant_matmul
              launches a request, all on the wgmma route, and no attention routed to the plain
              formula, ms, tokens/s, peak memory, a profiled
              request (busy share, B12's share); logits bit-identical to the
              same program with quant_matmul sent to its plain version; the
              fp artifact in bf16 as context. A request ends with its logits
              on the card, fetched as tensors (their 1 GB copy to pageable
              host memory would outweigh the request's own work).
  29. mlp     bench.py's serving_quant MLP (512-1024-1024-128, B=8) through
              the same recipe: rel_delta <= 0.05 on the RandomState(99)
              feed, 3 launches a request, all on the wgmma route; a stale
              program and a tampered
              scale raise QuantMetaError at load.
  30. parity  a small quantized transformer (dim 64, 2 layers, T=16, vocab
              128) and the MLP, card against CPU, f32 then bf16: calibration
              ranges, payload digests, and the CPU's artifact served on both,
              each quantized op's output within what its row's differing
              activation codes can move it.
  31. routing the `flash_attention` op's routing rule on the card: a
              cross-attention program (12 queries over 20 keys, D=64) and
              the transformer LM at a head dim of 32, which the flash
              kernels do not take, card against CPU (f32, then bf16), each
              attention call routed to the plain formula and counted.
  32. loop    bench.py's train_loop row (16 features, fc 256 tanh, fc 1,
              square_error_cost, SGD(0.01), B=64, 60 steps from --seed)
              through the port's Trainer in four modes: sync
              (log_interval=1), async (log_interval=60), scan (async with
              scan_window=8: one step captured as a CUDA graph, replayed)
              and async_traced (obs.trace armed); pass 0 warms up (and
              captures), pass 1 is timed: steps/s, host syncs and dispatches
              a step, the host-blocked fraction (the hostSync timer over the
              wall), scan's captures and replays. bench.py's assertions
              (bench.py:1020-1041): async fences less often than sync; scan
              dispatches less often than async, fences no more often than
              async nor than once a window; the parameters are the same
              bits in all four; and the traced run's counters equal
              async's, its spans lie on >= 2 threads and validate; the
              async pass again under torch.cuda.set_sync_debug_mode('warn'),
              its reported syncs counted.
  33. trainer bench.py's ResNet-50 (phase 18's program, B11 route) through
              the port's Trainer: 512 (img, label) samples from --seed ->
              data.batch -> DataFeeder -> DevicePrefetcher (depth 2), 2
              passes of 4 batches with CheckpointConfig(epoch_interval=1,
              step_interval=3, background=True), ms a step by pass; first
              a batch pinned twice (the caching host allocator's growth,
              then a cached block), two card steps from one state (the
              same bits or not, the share that differs);
              36 B11 launches a step; a fresh Trainer resumes from the
              last pass's mid-pass checkpoint and must end on the
              uninterrupted run's bits (within RESUME_REL_L2 if the two
              steps differed); checkpoint snapshot and commit times; ms a
              step at prefetch depth 2 and 0, and of the bare prefetched
              Executor.run loop, in turns, beside phase 20's Executor.run
              step; a batch's DataFeeder and pinning times;
              a profiled pass: busy share, the
              host-to-device copies' stream and their overlap with kernels.
  34. infer   ResNet-50 inference (A6a) from phase 33's weights, bound by
              name into bench.py run_infer's eval-mode NHWC program: saved,
              loaded, 3 timed requests of B=128 in bf16 (ms, images/s, no
              B11 launch, one more under torch.profiler), held to the
              artifact run in f32; the graft
              entry's NCHW program (B=8, f32) and a small eval program
              (64x64, B=4, f32 and bf16), card against CPU.
  35. window  the LSTM classifier (phase 10's program, B=128, T=100, bf16)
              through the port's Trainer from one saved state, in turns:
              the per-step async loop over 10 batches (its parameters also
              taken at step 8), scan_window=4 over 8 batches (the first step
              eager, the second captured, then replays), scan_window=4 over
              10 (a ragged tail of 2 on the same graph), the per-step loop
              and the ragged window again (the same bits as their first
              turns), then one profiled pass of each: ms a step, dispatches,
              host syncs, peak memory (allocated and reserved), the
              capture's seconds and its graph's pool, the busy share and the
              multi-tensor copies' device time; B1 and B2 launches a step
              (2 + 2) by the wrappers' counters in every run, and by the
              window's profile, which must agree; the windows' parameters
              the per-step loop's bits (the first that differs named).
  36. window  the same for the NMT step on the per-step attention route
              (phase 22's program with the seq flags off, B=256, S=T=50,
              bf16, fixed-length LoDArrays: one feed signature, one
              capture): B3, B4 (2 + 2), B5, B6 (50 + 50) and B7 (1).
  37. window  the same for ResNet-50 (phase 18's program, B=128, B11 route):
              B11 36 a step.
  38. random  a small program drawing gaussian_random in its main program
              (random_seed set): scan_window=4 against the per-step loop,
              the same costs and parameters; then one window of phase 35's
              captured step under torch.cuda.set_sync_debug_mode('error').
  39. window  the same for the transformer LM (phase 14's program, dim
              2048, 8 layers, T=1024, B=8, bf16): B8's three flash kernels
              8 + 8 + 8 a step, their TMA tensor maps encoded on the host at
              capture; its batches are dense token tensors with no LoD, so
              the ragged run is only the window's ragged tail (10 batches in
              windows of 4).
  40. window  the same for the NMT step on the whole-sequence decoder
              (phase 22's program with the seq flags on, B=256, S=T=50,
              bf16; ragged lengths 10-50 in one capacity): B3, B4 (2 + 2), B9
              and B10 (1 + 1, cooperative launches), B10's post-walk pass on
              B7's attn_dep_kernel (counted) and attn_dv_kernel (in the
              profile) 1 each, no per-step attention launch.
  41. sent    understand_sentiment's stacked_lstm_net at full width (vocab
              30000, emb 128, hid 512, 3 layers; B=128 ragged reviews of
              16-128 tokens from --seed, max_len 128; bf16, Adam(0.002)),
              built by the port's front end: startup, a warm-up step
              recording B1's and B2's inputs, then the per-layer build and
              the stacked_lstm op from one state (parameters bound by role),
              two steps each in f32 (held to rtol 1e-5, atol 1e-6) and bf16
              (printed).
  42. kernels lstm_fwd and lstm_bwd against their plain versions on the
              warm-up step's own ragged inputs of each layer (bf16 and f32),
              then on seeded inputs at its shapes with ragged lengths; the
              layer-1 times: kernel, plain, bound and cuDNN's.
  43. steps   3 timed sentiment steps with the launch counts set to 0 just
              before: finite losses, one below the first, exactly 3 lstm_fwd and 3
              lstm_bwd launches a step by the counters and by the profile,
              median ms a step, valid tokens/s, peak memory, busy share, and
              B1's and B2's device time against the rest of the step.
  44. window  the sentiment step through the Trainer, as phases 35-37, with
              ragged reviews: B1 and B2 3 + 3 a step.
  45. book    tests/book/'s understand_sentiment (hid 32, 2 layers, max_len
              128), word2vec and recommender_system (its is_sparse tables on
              SelectedRows gradients and lazy Adam) in f32: 3 steps card
              against CPU from one state, then each trained on the card by
              its reference test's recipe to its threshold, on the loaders'
              synthetic data (tests/fixtures/data holds too few samples for
              a batch); B1 and B2 (their f32 kernels) 2 + 2 a sentiment step.
  46. srl     label_semantic_roles at the reference book's widths
              (tests/book/test_label_semantic_roles.py's db_lstm: eight
              feature embeddings of 32, fc 512 tanh, a bi-GRU of H=512, the
              emission fc, linear_chain_crf; B=128 ragged conll05
              sentences, bf16, Adam(0.01)) built by the port's front end:
              startup and a warm-up step recording B3's and B4's calls;
              both against gru_fwd_plain and gru_bwd_plain on the step's
              own inputs, forward and reversed, bf16 and f32, kernel,
              plain and bound times; the f32 kernels also at the book's
              H=32 (seeded, T=20, B=16).
  47. steps   3 timed SRL steps with the launch counts set to 0 just
              before: finite losses, exactly 2 gru_fwd and 2 gru_bwd a step
              by the counters and by the profile, median ms a step, valid
              tokens/s, busy share, peak memory; the CRF alone (forward and
              its gradient, an eager loop over T <= 19, on the step's own
              inputs) against the step's host and device time; then
              crf_decoding on the for-test clone, its tags against the
              CPU's Viterbi on the card's emissions exactly, and the clone
              run on the CPU from the card's state (its share of equal
              tags printed).
  48. images  resnet_cifar10(32) and vgg(16) at B=128, 3x32x32, Adam(1e-3),
              bf16: 3 timed steps each, images/s, busy share, peak memory;
              vgg's train-mode dropout keeping a share within 4 sigma of
              0.5 of its nonzero inputs on the card; then vgg through the
              Trainer, per-step against scan_window=4 from one state and
              one seed (program.random_seed: the generator registered with
              the graph draws each step's masks), the same bits.
  49. book    tests/book/'s image_classification (resnet_cifar10(20) and
              vgg(11), B=32, 3 passes x 25 steps over _augment's crops and
              flips of the synthetic cifar) and label_semantic_roles (word
              dim 16, H=32, B=16, 320 steps, chunk F1 over 4 test batches)
              in f32: 3 steps card against CPU from one state (vgg's two
              dropouts fed one host mask through dropout_apply, patched in
              this script only), then each trained on the card to its
              reference test's threshold; B3 and B4 (their f32 kernels)
              2 + 2 an SRL step.
  50. serve   phase 28's int8 transformer artifact (kept on disk, not
              quantized again) behind the port's HTTP server in bf16:
              ServingEngine(quantize='int8') with batch buckets 1-8, a
              MicroBatcher(max_batch_size=8), make_server on 127.0.0.1; 4
              client threads post 12 /predict requests of 1, 2, 3, 5 and 8
              rows x 1024 tokens (npz replies); B12 and B8-forward launches
              a request by the wrappers' counters (49 and 8), p50/p99
              latency, rows/s, the coalesced engine calls and bucket
              signatures, /healthz, /stats and /metrics (each line parsed),
              one 8-row request under torch.profiler; every answer the same
              bits as engine.predict(bucketed=False) on the card.
  51. gen     bench.py's serving_gen (K=4, T=32, 8 slots, 48 requests,
              hidden 3072, f32, thresholds from RandomState(7)) built by
              the port's front end: batch mode through engine.predict in
              FIFO groups of 8, then continuous mode through
              ContinuousScheduler.submit, every request the same ids,
              scores and lengths; the pool step captured once at warmup,
              replayed a step, one host sync a step (and POOL_SYNC_STEPS
              steps alone under set_sync_debug_mode('warn')); effective
              tokens/s, first-token p50/p99, occupancy, the replay's host
              and device ms and device events, the capture's seconds and
              pool; one streamed /generate against the batch answer.
  52. v3      bench.py's serving_gen_v3 (K=2, T=32, 8 slots, 48 requests of
              its shared-prefix trace from the port's fleetctl.traces,
              prefix 3 x 4096, context memory 256, its chain-control draft,
              draft_k 4): three passes over one engine, v2 mode (no cache,
              no draft), the fp prefix cache with the draft, the int8 cache
              with the draft, each closed loop then open loop; the fp pass
              v2 mode's bits in both loops, int8 ids and lengths equal with
              scores within 0.5; propose and verify each captured once at
              warmup and replayed every round, one host sync a round;
              tokens accepted a slot a round, effective tokens/s,
              first-token p50/p99 (hits against misses), hit rates.
  53. tiny    tests/test_gen_serving.py's tiny decoder (f32): continuous
              answers card against CPU (ids exact, scores within 1e-5).
  54. disagg  `python -m paddle_tpu_torch serve --disaggregate
              --prefill_replicas 1 --decode_replicas 1` over phase 52's
              target (a router and two replica processes sharing the
              card): the trace's 48 requests buffered, then streamed by 8
              clients, each the bits of an in-process scheduler on the card;
              then with --handoff_quant int8 (ids equal, scores within
              0.05, fewer bytes a handoff); pt_handoff_* bytes and seconds
              from the router's /metrics, first-token p50/p99, tokens/s;
              SIGTERM exits 0.
  55. fleet   `python -m paddle_tpu_torch serve --replicas 2 --standby 1
              --quant int8` over bench.py's serving_quant MLP (int8 by
              quant.convert), 16 closed-loop clients of 8-row requests,
              every answer the bits of an in-process engine on the card; one
              replica SIGKILLed under load: no non-retryable error, the
              breaker-trip and admission times, requests/s before the kill
              and after the standby's admission, B12's launches a request
              by a replica's own /stats counters; `fleetctl status`, then
              `fleetctl rollout` to a second artifact under the same load
              with no failed request; SIGTERM exits 0. Each spawned process
              writes its output under LOG_DIR (the output directory that
              a run on the card hands back), whose tails are printed if
              the phase fails.
  56. remat   bench.py's transformer row (phase 14's program) under
              memory_optimize: no remat, then `full`, `dots` and
              `dots_no_batch`, each from the same startup state, a warm-up
              and 3 timed steps: ms a step, tokens/s, peak memory, flash
              launches a step (16 flash_fwd under each policy: the
              recompute runs the forward again), the losses and every
              parameter the plain step's bits (torch.equal; the plain step
              run twice to show it is the same bits run to run); `full` and
              `dots` below the plain step's peak.
  57. window  the same row through run_window (scan_window=4) under
              `full`: losses and parameters the per-step remat loop's bits,
              one capture and 3 replays, 16 flash_fwd a step, its peak and
              the graph's pool beside the window's without remat. Then two
              BatchNorm programs under each policy, 2 steps each from one
              startup state: resnet_cifar10(32) (conv2d + batch_norm) at
              B=128 and ResNet-50 on the B11 route (fused_conv_bn, bn_stats,
              bn_apply) at 64x64, B=16, both bf16: the plain step run twice,
              each policy's losses and whole scope (the running statistics,
              parameters and optimizer state) the plain step's bits, the
              running statistics moved, B11's launches a step doubled (its
              forward recomputed).
  58. ops     every op the slice adds (the activations, the elementwise
              family, the reductions on each axis, the shape ops, cast,
              the norm clips, increment, argmax, the comparisons and
              logical ops, cross_entropy with hard and soft labels,
              softmax_with_cross_entropy with soft labels, huber_loss,
              sequence_conv) on [128 x 1024] inputs, dense and ragged, card
              against CPU, outputs and input gradients, f32 and bf16 amp;
              truncated_gaussian_random held to its law; conv2d_transpose
              at B=128, 256 -> 128 channels, 16x16 -> 32x32, 4x4, stride 2,
              in f32 (TF32 off) and bf16 against float64 on the card.
  59. nets    networks.py at the sentiment phase's widths (f32): the
              book's convolution_net (two sequence_conv_pool, 512
              filters), bidirectional_lstm and bidirectional_gru
              classifiers at hidden 512, 3 steps card against CPU, B1-B4
              launches a step; img_conv_group and glu forward card against
              CPU.
  60. rg_lstm the v1 rnn.py classifier at bench.py's lstm widths (vocab
              30000, emb 128, hidden 512, B=128, T=100, bf16, Adam +
              L2Decay + global-norm clip): two RecurrentGroups whose step
              is an LSTM cell built from layers, trained through the
              port's Trainer: the per-step loop timed (and one step under
              torch.profiler), the fused path (lstm_benchmark_net, B1/B2)
              timed beside it, then scan_window=2 (4 before PR 23): one
              eager step, one capture, one replay, the per-step loop's bits.
  61. control a NestedRecurrentGroup over 64 documents of up to 8
              sentences of up to 32 words (hidden 512, f32, 2 SGD steps)
              card against CPU; a While card against CPU, and a While and
              a cond inside a captured window raising
              ControlFlowCaptureError; a cond training step in which only
              the taken branch's weights move.
  62. optim   every new optimizer, schedule and clip, ModelAverage,
              ParamAttr(learning_rate), the per-parameter clips,
              StaticPruningHook and the SelectedRows branches, 5 steps of
              a small program each, card against CPU in f32.
  63. seqops  the 10 sequence op types the slice adds, card against CPU:
              outputs (layouts exact) and input gradients, f32.
  64. ctc     a CTC acoustic model at DeepSpeech2's widths (B3/B4 in
              f32), through the Trainer and a window.
  65. ssd     an SSD300 head on VOC's classes and detection_output.
  66. ctr     a Criteo-shaped CTR model on a 1e6-column sparse slot.
  67. misc    the cost and misc ops, card against CPU.
  68. pipe    bench.py's pipeline grid (bench.py:1716-1860) on the
              transformer row (dim 2048, 8 layers, B=8, T=1024, bf16,
              Adam): one startup, its state restored for each cell;
              gpipe with K in {1, 2, 4} stages and M in {4, 8}
              micro-batches, 1f1b at K=4, M=8; after 2 steps every cell's
              parameters are K=1's bits at its M; ms a step, t(K,M)/t(1,M)
              (on one card the staging's overhead, not the bubble), the
              analytic bubble, peak memory and B8's launches a step (8·M
              of each kernel, 8·M more forwards under 1f1b); 1f1b's peak
              below gpipe's.
  69. pwin    the pipeline (K=2, M=4) through Trainer(scan_window=4): the
              per-step loop's bits, one capture and 3 replays; then the
              staged step's ticks under set_sync_debug_mode("error").
  70. dp      ParallelExecutor on bench.py's lstm row: (a) 2 ranks (this
              script again with --dp_rank, logging to
              chiprun_out/chip_smoke_logs/dp_rank*.log) over gloo on the
              one card, 64 rows each, 3 steps: the ranks' bits equal, B1
              and B2 twice a rank step, within the bf16 bound of one
              process on the 128 rows; (b) world size 1 over NCCL, plain
              and ZeRO-1: the plain Executor's bits; (c) (a)'s sharded
              checkpoint loads at world size 1 with (a)'s bits, and 2 more
              steps stay within the bound of (a)'s.
  71. sp      Ulysses (B8's bits, one launch of each kernel) and ring
              attention at the transformer's attention shape, sp of size 1
              over NCCL.
  72. the paths JSON line (phases 32-71's readings), the kernels JSON
      line, then the device JSON line last.

Weights are made with numpy from --seed at the shapes the program
declares (normal / sqrt(fan_in)): for the inference artifact written as
params.npz beside a copy of the committed program.json/meta.json, for the
small training programs over their startups' state; the full-width
training programs and the quantized ones start from their own startup
programs. The quantized phases write their artifacts to a temporary
directory (the fp transformer's params.npz is 1.9 GB) and delete it.
Nothing is downloaded and nothing of the JAX package is needed.
"""

from __future__ import annotations

import argparse
import atexit
import concurrent.futures
import gc
import io
import itertools
import json
import math
import os
import queue
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published dense peaks (NVIDIA data sheet), at a 700 W limit
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# kernel-against-plain tolerances on h. f32: the same f32 arithmetic
# summed in another order (warp shuffles vs a BLAS GEMM) over 50 steps.
# bf16: h and rh are rounded to bf16 at the same places on both sides, but
# a sum that lands near a rounding boundary may round one bf16 ulp apart
# (2^-8 relative, ~4e-3 just below 1). So bf16 is held to one ulp near 1
# and to the share of h_seq's elements that differ. A rounding in the
# wrong place moves h by no more than a sound flip does, but in many more
# elements: phase 3 prints, beside the kernel's share, the share of the
# recurrence rounded to bf16 only at its output, and fails unless the
# bound tells the two apart.
TOL = {torch.float32: 1e-4, torch.bfloat16: 4e-3}
BF16_MAX_DIFFERING = 0.05
# phase 5, card against CPU. f32: scores within 1e-4, ids and lengths
# equal. bf16: encoder state and decoder h0 within one ulp near 1 and a
# share of differing elements (the bounds of tests/test_torch_nmt_infer.py,
# where the port is held to the JAX package). The beams are not held to
# each other: bf16 scores near -200 have a 1.0 ulp, so candidates tie and
# one rounding flip sends a beam elsewhere, where it may find an EOS the
# other does not (the JAX package's beams drift from the port's the same
# way). So a beam that both find must score within two ulps, and at least
# 10% of the beams must be found by both; a decoder computing another
# function shares no 32-token beam with the plain one.
SLICE_SCORE_TOL = 1e-4
BF16_SLICE_MAX_DIFFERING = {"encoder state": 0.02, "decoder h0": 0.10}
BF16_SCORE_ULPS = 2
BF16_MIN_SHARED_BEAMS = 0.10
# (T, B, H) beyond the main path's: on a 132-SM card these take 1, 4 and
# 16 hidden units per CTA in the f32 kernel, the last two with a partly
# empty last CTA
EDGE_SHAPES = [(3, 1, 100), (5, 3, 301), (4, 5, 1100)]
# (T, B, H) beyond those for the bf16 kernels' partition (16 units by
# 32-row sub-tiles), each with a row masked at every step: T=1 (where the
# backward's dW is exactly 0: h_prev and rh are 0); H=100, not a whole
# group of 16 units, at B=3; H=301 at B=40, a partial second sub-tile;
# B=520, more sub-tiles than the card holds batch groups beside 32 unit
# groups, so a CTA walks several; H=2400, whose W slice does not fit shared
# memory (or leaves the card too few CTAs) and is read through L1. f32
# where its kernels take H (their W slices in shared memory: not at 2400)
GRU_TC_EDGE = [(1, 3, 100), (4, 40, 301), (4, 520, 512), (3, 2, 2400)]
GRU_F32_MAX_H = 1100


_OPEN_PHASE = {"n": None, "t0": 0.0}


def phase(n, name):
    """Ends the open phase (its seconds on a line of their own), then opens
    phase n."""
    end_phase()
    _OPEN_PHASE.update(n=n, t0=time.perf_counter())
    print(f"[phase {n}] {name}", flush=True)


def end_phase():
    if _OPEN_PHASE["n"] is not None:
        print(f"[phase {_OPEN_PHASE['n']}] {time.perf_counter() - _OPEN_PHASE['t0']:.1f} s",
              flush=True)
        _OPEN_PHASE["n"] = None


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg):
    if not cond:
        fail(msg)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def write_params(src_dir, dst_dir, seed):
    """Copy an artifact's program.json/meta.json and write seeded weights."""
    os.makedirs(dst_dir, exist_ok=True)
    for f in ("program.json", "meta.json"):
        shutil.copy(os.path.join(src_dir, f), dst_dir)
    with open(os.path.join(src_dir, "program.json")) as f:
        shapes = {v["name"]: v["shape"] for v in json.load(f)["blocks"][0]["vars"]}
    with open(os.path.join(src_dir, "meta.json")) as f:
        names = json.load(f)["param_names"]
    rng = np.random.RandomState(seed)
    arrays = {}
    for n in names:
        shape = shapes[n]
        arrays[n] = (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32)
    np.savez(os.path.join(dst_dir, "params.npz"), **arrays)


def ragged_feed(ptt, rng, batch, max_len, vocab, min_len):
    lens = rng.randint(min_len, max_len + 1, size=batch)
    lens[0] = max_len
    seqs = [rng.randint(2, vocab, size=(n,)).astype(np.int32) for n in lens]
    return ptt.LoDArray.from_sequences(seqs, capacity=batch * max_len, max_seqs=batch)


def cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def encoder_inputs(ptt, exe, program, scope, feed, amp):
    """x [T,B,3H] (bias added), mask, W and reverse for both encoder GRUs,
    from the artifact's own lookup_table and mul ops on `feed`."""
    d = program.to_dict()
    sub = ptt.Program.from_dict(d)
    sub.global_block().ops = [o for o in sub.global_block().ops
                              if o.type in ("lookup_table", "mul")][:3]
    sub.set_amp(amp)
    grus = [o for o in program.global_block().ops if o.type == "dynamic_gru"]
    projs = [g.inputs["Input"][0] for g in grus]
    outs = exe.run(sub, {"src": feed}, projs, scope=scope, return_numpy=False)
    cases = []
    for g, lod in zip(grus, outs):
        x, mask = lod.to_batch(max_len=g.attrs["max_len"])
        w = scope.get(g.inputs["Weight"][0])
        b = scope.get(g.inputs["Bias"][0])
        cases.append((x + b.to(x.dtype), mask, w.to(x.dtype), bool(g.attrs["is_reverse"])))
    return cases


def bound(x, mask, w, h_seq, h_T):
    """Least time the card could take for this GRU, counted over the valid
    tokens (a padded step only carries h and needs no x): the bytes of x's
    valid rows, the mask and W read once and h_seq and h_T written once,
    over HBM bandwidth; the products the valid tokens need (2*3H*H each),
    over the dtype's dense peak."""
    tokens = float(mask.float().sum())
    nbytes = tokens * x.shape[2] * x.element_size() + sum(
        t.numel() * t.element_size() for t in (mask, w, h_seq, h_T))
    H = w.shape[0]
    flops = 2.0 * tokens * 3 * H * H
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[x.dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations", nbytes, flops


def bf16_ulp(v):
    """One bf16 ulp at each element's magnitude (numpy float array)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126))) - 7)


def kernel_error(got, want, dt):
    """(max abs error over h_seq and h_T, share of h_seq elements that
    differ); fails past the dtype's bounds."""
    err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
    differing = float((got[0] != want[0]).float().mean())
    check(all(torch.isfinite(t.float()).all() for t in got), "non-finite kernel output")
    check(err <= TOL[dt], f"gru_fwd disagrees with its plain version: {err}")
    check(dt != torch.bfloat16 or differing <= BF16_MAX_DIFFERING,
          f"gru_fwd differs from its plain version in {differing:.4%} of h_seq")
    return err, differing


def same_bits(again, first, name):
    check(all(torch.equal(a, b) for a, b in zip(again, first)),
          f"{name}'s outputs differ between two runs")


def gru_edge_mask(rng, T, B, tc_edge):
    """A ragged [T, B] mask on the card: lengths 1..T, and for the bf16
    kernels' edges the first row whole and the second masked at every
    step (B > 2)."""
    lens = torch.as_tensor(rng.randint(1, T + 1, size=B))
    if tc_edge:
        lens[0] = T
        if B > 2:
            lens[1] = 0
    return (torch.arange(T)[:, None] < lens[None, :]).cuda()


def print_plan(rnn_kernels, name, B, H, what):
    """How the card takes the bf16 kernel `name` at (B, H): CTAs an SM,
    batch groups and their sub-tiles, where W's slice is read."""
    plan = rnn_kernels.tc_plan(name, B, H)
    print(f"  bf16 {name} at B={B}, H={H} ({what}): {plan['per_sm']} CTAs an SM fit, "
          f"{plan['groups']} batch groups of {plan['tiles_per_group']} 32-row sub-tiles, W's "
          f"slice in {'shared memory' if plan['w_smem'] else 'L1'}: "
          + ("a CTA for every sub-tile" if plan["tiles_per_group"] == 1
             else "a CTA walks several sub-tiles"))
    return plan


def gru_tc_plans(rnn_kernels, name):
    """Print how the card takes the bf16 kernel at GRU_TC_EDGE's sub-tile
    and W edges, and fail unless they take the walk and the L1 read."""
    for T_, B_, H_ in GRU_TC_EDGE[2:]:
        plan = print_plan(rnn_kernels, name, B_, H_, "an edge shape")
        if H_ == 512:
            check(plan["tiles_per_group"] > 1, f"{name} at B={B_}: no CTA walks several sub-tiles")
        else:
            check(not plan["w_smem"], f"{name} at H={H_}: W's slice still in shared memory")


# torch.profiler can lose a run of device events at the start of a
# capture (on the H100, from a few to over a hundred of a step's first
# events), which can take a kernel the step launched out of its count. So a
# capture opens with PROFILE_PAD spin kernels of about 10 us each, waits
# for them, and keeps only the events after the last of them recorded
PROFILE_PAD = 1024
PROFILE_PAD_CYCLES = 20000
PROFILE_TRIES = 3


def profiled_spans(run):
    """One call of `run` under torch.profiler, after the pad: (its wall
    µs, its device events as (start µs, end µs, name) sorted by start).
    Where not one of the pad's kernels was recorded, the loss may have
    reached the run's own events, and the capture is taken again (at most
    PROFILE_TRIES times)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_PAD):
                torch.cuda._sleep(PROFILE_PAD_CYCLES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        pads = [i for i, (_, _, name) in enumerate(spans) if "spin_kernel" in name]
        if pads:
            return wall_us, spans[pads[-1] + 1:]
        print(f"  profiler: none of the {PROFILE_PAD} pad kernels recorded "
              f"({len(spans)} device events); capturing again")
    check(False, f"torch.profiler recorded none of the pad kernels in {PROFILE_TRIES} captures")


def breakdown(run, median_ms, what="request", kinds=None):
    """One call of `run` under torch.profiler (profiled_spans): device
    busy time, as a share of the profiled wall time (which the profiler's
    own host cost inflates) and of the unprofiled median, and device time
    by kernel name, largest first; with `kinds` ({kind: name substrings}), also by
    the first kind whose substring a kernel's name holds. Returns (device
    busy µs, µs by kind), or (None, {}) where nothing was recorded."""
    wall_us, spans = profiled_spans(run)
    if not spans:
        print("  profiler: no device events recorded; breakdown not measured")
        return None, {}
    busy, end, by_name = 0.0, float("-inf"), {}
    for s, e, name in spans:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    print(f"  profiled {what}: wall {wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms "
          f"({100 * busy / wall_us:.1f}% of the profiled wall, "
          f"{100 * busy / 1e3 / median_ms:.1f}% of the unprofiled median), "
          f"{len(spans)} device events")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        print(f"    {us / 1e3:9.3f} ms  {name[:100]}")
    by_kind = {}
    if kinds:
        for name, us in by_name.items():
            kind = next((k for k, subs in kinds.items() if any(x in name for x in subs)), "other")
            by_kind[kind] = by_kind.get(kind, 0.0) + us
        print("  by kind: " + ", ".join(f"{k} {us / 1e3:.3f} ms" for k, us in
                                        sorted(by_kind.items(), key=lambda kv: -kv[1])))
    return busy, by_kind


# ---------------------------------------------------------------- training --
# Training kernels against their plain versions: max error relative to the
# largest element of the plain output, or for a sum whose terms cancel to
# the largest sum of its terms' magnitudes (term_scales). f32: the same
# f32 arithmetic summed in another order (warp shuffles, a batch-ordered
# dW, per-block dv partials) over 50 steps: 1e-5. The attention kernels
# compute in f32 in both io dtypes and round each bf16 output once, from
# an f32 sum that may land on the other side of a rounding boundary: so
# 1e-5 of the scale beyond one bf16 ulp of each plain value. In gru_bwd a
# flip travels with the bf16 dh carry into dx and dW: 1e-2 of the scale,
# and for dx a share of differing elements, which a dh carry rounded in
# the wrong place breaks (printed beside it).
# A check must be able to fail: an output left at zero must read above its
# tolerance (checked for every attention output; for gru_bwd at the edge
# shapes). On the warm-up step's inputs ddp and dv nearly cancel (the
# startup's small weights leave tanh(ep+dp) nearly the same at every s,
# and Σ_S dsc = 0), so the attention kernels also run on seeded normal
# inputs at the main path's shapes, where nothing cancels.
TRAIN_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
BF16_MAX_DIFFERING_DX = 0.05
# (T, B, H) for gru_bwd beyond the main path's: on a 132-SM card they take
# 1, 4 and 8 hidden units per CTA in the f32 kernel, the last with dW
# outside the kernel; then GRU_TC_EDGE
GRU_BWD_EDGE = [(3, 3, 100), (5, 3, 301), (4, 5, 700)]
# (B, S, A, C, T) for the attention kernels: the second takes the loops
# over S, A and C (256 threads, 8 warps, a 32-lane softmax) more than once;
# both have rows of 200/260 and 600/1040 bytes in bf16, which attn_fwd's
# row routine copies by plain loads (no bulk copy takes them)
ATTN_EDGE = [(3, 7, 100, 130, 4), (5, 45, 300, 520, 3)]
# (what, B, S, A, C, T) for attn_fwd's row routine at the main path's A and
# C: a mask with holes (no row a prefix); a row with no valid position
# beside such rows (α = 1/S, every enc row read); S = 300 with 200-300
# valid positions a row, past the 96 KB stage, streamed through its ring
ATTN_ROW_EDGE = [("non-prefix", 6, 50, 512, 1024, 3), ("fully masked", 6, 50, 512, 1024, 3),
                 ("S=300", 4, 300, 512, 1024, 3)]
# (what, B, S, A, C, T) for attn_bwd_step's row routine on its cluster at
# the main path's widths (2 ranks a row): rows whose dctx is exactly 0
# beside live ones (ddp and dsc held to exact zeros there); lists of odd
# lengths (37, 25, 13, 1, 49 valid positions with holes) that do not split
# evenly over the ranks; rows of a single valid position (α = 1 there, so
# dsc = dα − dα = 0 and ddp = 0 exactly)
ATTN_BWD_EDGE = [("dead rows", 6, 50, 512, 1024, 3), ("uneven", 5, 50, 512, 1024, 3),
                 ("single position", 4, 50, 512, 1024, 3)]
# the launches of one training step at T = S = 50
STEP_LAUNCHES = {"gru_fwd": 2, "gru_bwd": 2, "attn_fwd": 50, "attn_bwd_step": 50,
                 "attn_phase2": 1}
# small training program, card against CPU from one state (the bounds of
# tests/test_torch_train.py, where the port is held to the JAX package):
# loss relative error; parameters after two Adam steps in units of the
# learning rate: most elements within `close`, at most `share` beyond it;
# f32: every element within `far`; bf16: a gradient near 0 may flip its
# sign, and a step moves a value by lr·sign(g), so the bound is on the
# elements whose first gradient (the CPU's) exceeds `robust_grad` of the
# parameter's largest, within `robust`; moments relative to their largest
LR = 5e-4
TRAIN_PARITY = {
    None: dict(loss=1e-5, close=0.02, share=0.005, far=0.05, moment=5e-5, moment_share=0.0),
    "bfloat16": dict(loss=1e-4, close=0.1, share=0.03, robust_grad=0.05, robust=0.5,
                     moment=5e-2, moment_share=0.10),
}
F32_PEAK = PEAK_FLOPS[torch.float32]  # the attention kernels' math is f32


def rel_err(got, want, scale=None):
    """(max abs error, the same over `scale`, by default want's largest
    element)."""
    err = float((got.float() - want.float()).abs().max())
    if scale is None:
        scale = float(want.float().abs().max())
    return err, err / max(scale, 1e-30)


def beyond_ulp(got, want, scale):
    """Largest |got - want| beyond one bf16 ulp of the plain value (none
    for an f32 output), over `scale`."""
    g, w = (t.float().cpu().numpy() for t in (got, want))
    slack = bf16_ulp(w) if want.dtype == torch.bfloat16 else 0.0
    return float(np.maximum(np.abs(g - w) - slack, 0.0).max()) / max(scale, 1e-30)


def amax(t):
    return float(t.float().abs().max())


def term_scales(name, ins, want):
    """The scale each output's error is held to: its largest element, or
    for a sum whose terms cancel (dW over T·B, ddp and dv over a softmax
    gradient that sums to 0, dep over T) the largest sum of its terms'
    magnitudes, which bounds the error an f32 sum in another order makes."""
    out = [amax(w) for w in want]
    if name == "gru_bwd":
        h_prev, rh = ins[2].float().abs(), ins[3].float().abs()
        out[1] = max(amax(h_prev.sum((0, 1))), amax(rh.sum((0, 1)))) * out[0]
    elif name == "attn_bwd_step":  # ddp = v·Σ_S dsc·(1-t²), with |1-t²| ≤ 1
        out[0] = amax(want[1].abs().sum(1)) * amax(ins[3])
    elif name == "attn_phase2":
        out[0] = amax(ins[2].abs().sum(0)) * amax(ins[3])
        out[1] = float(ins[2].abs().sum())
    return out


def record_calls(mod, keep):
    """Wrap mod's kernel wrappers so they record their arguments: `keep`
    maps a name to "all", "first" or "last". Returns (calls, restore)."""
    calls, orig = {}, {}
    for name, which in keep.items():
        fn = orig[name] = getattr(mod, name)

        def spy(*a, _fn=fn, _name=name, _which=which, **k):
            seen = calls.setdefault(_name, [])
            rec = (tuple(t.detach() if torch.is_tensor(t) else t for t in a), k)
            if _which == "all" or not seen:
                seen.append(rec)
            elif _which == "last":
                seen[-1] = rec
            return _fn(*a, **k)

        setattr(mod, name, spy)
    return calls, lambda: [setattr(mod, n, f) for n, f in orig.items()]


def bound_ms(nbytes, ops, peak):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def gru_bwd_bound(args):
    """Valid tokens only: ur_pre, c_pre, h_prev, rh and dh_seq in and dx
    out for each; W, dhT and the f32 mask in and dW out once; the three
    products (drh, dur, dW) 12·H² operations per token."""
    ur, c, hp, rh, dh, mask, w, dhT = args
    tokens = float(mask.float().sum())
    H, item = hp.shape[2], hp.element_size()
    nbytes = tokens * 9 * H * item + 2 * w.numel() * item + dhT.numel() * item + mask.numel() * 4
    return (*bound_ms(nbytes, tokens * 12 * H * H, PEAK_FLOPS[hp.dtype]), nbytes)


def attn_bound(kind, args):
    """The least time for the call's work, over the valid source positions
    only (the mask's; for attn_bwd_step those of its live rows, whose dctx
    is not all zero; for phase 2 those with a nonzero dsc at some step):
    ep and enc (phase 2: ep in, dep out) once each, the small per-row
    tensors once (for attn_bwd_step dctx, ddp and dsc of every row, dp, the
    mask and alpha of the live rows); the f32 operations per valid element
    (tanh as one), over the f32 peak (the kernels compute in f32 on CUDA
    cores)."""
    ep = args[0]
    B, S, A = ep.shape
    item = ep.element_size()
    if kind == "attn_phase2":
        _, dp_seq, dsc_seq, _ = args
        nz = dsc_seq != 0
        valid_bs, valid_tb = float(nz.any(0).sum()), float(nz.any(-1).sum())
        nbytes = 2 * valid_bs * A * item + valid_tb * A * item + dsc_seq.numel() * 4 + A * (item + 4)
        return (*bound_ms(nbytes, float(nz.sum()) * A * 9, F32_PEAK), nbytes)
    enc, mask = args[1], args[4]
    C = enc.shape[2]
    if kind == "attn_bwd_step":
        live = (args[5] != 0).any(1) & (mask > 0).any(1)
        n_live = float(live.sum())
        valid = float((mask[live] > 0).sum())
        small = (B * C + B * A + A) * item + B * S * 4 + n_live * (A * item + 2 * S * 4)
        ops = valid * (5 * A + 2 * C)
    else:
        valid = float((mask > 0).sum())
        small = (2 * B * A + A + B * C) * item + 3 * B * S * 4
        ops = valid * (4 * A + 2 * C)
    nbytes = valid * (A + C) * item + small
    return (*bound_ms(nbytes, ops, F32_PEAK), nbytes)


def attn_fwd_first(ak, ep, enc, dp, v, mask):
    """attn_fwd's first-design kernel (attn_fwd_kernel) on these inputs,
    whichever route attn_fwd_path names: in bf16 the kernel before the
    staged rows, held and timed beside them. Not counted."""
    B, S, A = ep.shape
    C = enc.shape[2]
    ctx = torch.empty(B, C, dtype=ep.dtype, device=ep.device)
    alpha = torch.empty(B, S, dtype=torch.float32, device=ep.device)
    lib = ak._lib()
    err = lib.attn_fwd_launch(int(ep.dtype == torch.bfloat16), ep.data_ptr(), enc.data_ptr(),
                              dp.data_ptr(), v.data_ptr(), mask.data_ptr(), ctx.data_ptr(),
                              alpha.data_ptr(), B, S, A, C, torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"attn_fwd's first design at B={B} S={S} A={A} C={C}: "
          f"{lib.attn_error_string(err).decode()}")
    return ctx, alpha


def attn_bwd_first(ak, ep, enc, dp, v, mask, dctx, alpha):
    """attn_bwd_step's first-design kernel (attn_bwd_step_kernel) on these
    inputs, whichever route attn_bwd_path names: in bf16 the kernel before
    the cluster, held and timed beside it. Not counted."""
    B, S, A = ep.shape
    C = enc.shape[2]
    ddp = torch.empty(B, A, dtype=ep.dtype, device=ep.device)
    dsc = torch.empty(B, S, dtype=torch.float32, device=ep.device)
    lib = ak._lib()
    err = lib.attn_bwd_step_launch(
        int(ep.dtype == torch.bfloat16), ep.data_ptr(), enc.data_ptr(), dp.data_ptr(),
        v.data_ptr(), mask.data_ptr(), dctx.data_ptr(), alpha.data_ptr(), ddp.data_ptr(),
        dsc.data_ptr(), B, S, A, C, torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"attn_bwd_step's first design at B={B} S={S} A={A} C={C}: "
          f"{lib.attn_error_string(err).decode()}")
    return ddp, dsc


def attn_phase2_first(ak, ep, dp_seq, dsc_seq, v):
    """attn_phase2's first-design kernel (attn_phase2_kernel) on these
    inputs: the kernel before the walk over the nonzero terms, held and
    timed beside it. No wrapper launches it; not counted."""
    B, S, A = ep.shape
    T = dp_seq.shape[0]
    dep = torch.empty(B, S, A, dtype=ep.dtype, device=ep.device)
    dv = torch.empty(A, dtype=torch.float32, device=ep.device)
    dv_part = torch.empty(B, A, dtype=torch.float32, device=ep.device)
    done = torch.zeros(1, dtype=torch.int32, device=ep.device)
    lib = ak._lib()
    err = lib.attn_phase2_launch(
        int(ep.dtype == torch.bfloat16), ep.data_ptr(), dp_seq.data_ptr(), dsc_seq.data_ptr(),
        v.data_ptr(), dep.data_ptr(), dv.data_ptr(), dv_part.data_ptr(), done.data_ptr(), T, B,
        S, A, torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"attn_phase2's first design at T={T} B={B} S={S} A={A}: "
          f"{lib.attn_error_string(err).decode()}")
    return dep, dv


def bwd_edge_mask(rng, kind, B, S):
    """ATTN_BWD_EDGE's source masks on the card: ragged rows with holes (the
    first position masked); for "uneven" rows of 37, 25, 13, 1 and 49 valid
    positions; for "single position" rows 0 and 2 with one (at 7 and at
    S - 1)."""
    m = (rng.rand(B, S) < 0.7).astype(np.float32)
    m[:, 0] = 0.0
    if kind == "uneven":
        for b, n in enumerate((37, 25, 13, 1, 49)[:B]):
            m[b] = 0.0
            m[b, np.sort(rng.choice(np.arange(1, S), n, replace=False))] = 1.0
    if kind == "single position":
        m[0], m[2] = 0.0, 0.0
        m[0, 7], m[2, S - 1] = 1.0, 1.0
    return torch.as_tensor(m).cuda()


def row_mask(rng, kind, B, S):
    """ATTN_ROW_EDGE's source masks on the card: holes in every row (the
    first position masked), and for "fully masked" row 1 with no valid
    position; for S=300 rows of 200-300 valid positions with holes."""
    keep = 0.95 if kind == "S=300" else 0.6
    m = (rng.rand(B, S) < keep).astype(np.float32)
    m[:, 0] = 0.0
    m[0, 1] = 1.0
    if kind == "fully masked":
        m[1] = 0.0
    if kind == "S=300":
        m[:, 200:] *= (np.arange(S - 200)[None] < rng.randint(0, S - 199, size=(B, 1)))
    return torch.as_tensor(m).cuda()


def train_feed(ptt, rng, batch, max_len, vocab, min_len):
    """Ragged (src, trg) pairs; trg_in and label are the same sequence, as
    bench.py feeds them."""
    pack = lambda seqs: ptt.LoDArray.from_sequences(  # noqa: E731
        seqs, capacity=batch * max_len, max_seqs=batch)
    lens = rng.randint(min_len, max_len + 1, size=(2, batch))
    lens[:, 0] = max_len
    src, trg = ([rng.randint(2, vocab, size=(n,)).astype(np.int32) for n in row] for row in lens)
    return {"src": pack(src), "trg_in": pack(trg), "label": pack(trg)}


def seeded_state(ptt, main, startup, seed):
    """The small program's startup state on the CPU, with its parameters
    replaced by normal/sqrt(fan_in) values from `seed`."""
    scope = ptt.Scope()
    ptt.Executor(device="cpu").run(startup, scope=scope, seed=seed)
    names = [v.name for v in main.persistables()]
    state = ptt.io.state_to_numpy(scope, names)
    rng = np.random.RandomState(seed)
    for v in main.global_block().vars.values():
        if v.is_parameter:
            shape = state[v.name].shape
            state[v.name] = (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32)
    return state


def compare_state(got, want, amp, grads, lr=LR, biases=()):
    """Parameters and Adam moments after the steps, with TRAIN_PARITY's
    bounds in units of `lr` (`grads`: want's first-step gradients as Adam
    saw them, by P@GRAD name); the state of the parameters in `biases`
    with LSTM_BIAS_PARITY's; returns the worst readings for printing."""
    worst = dict(param_share=0.0, param_far=0.0, moment=0.0, moment_share=0.0)
    for n, w in want.items():
        b = dict(TRAIN_PARITY[amp])
        if amp and any(n.endswith(p) for p in biases):
            b.update(LSTM_BIAS_PARITY)
        d = np.abs(got[n] - w)
        if ".moment" in n:
            scale = max(float(np.abs(w).max()), 1e-30)
            rel, share = float(d.max()) / scale, float(np.mean(d > 0.01 * scale))
            worst["moment"] = max(worst["moment"], rel)
            worst["moment_share"] = max(worst["moment_share"], share)
            check(rel <= b["moment"] and share <= b["moment_share"],
                  f"{n}: moments {rel:.3e} apart ({share:.2%} beyond 1%)")
        elif "_pow." in n or n.endswith(".lr"):
            check(np.array_equal(got[n], w), f"{n}: {got[n]} != {w}")
        else:
            held = d
            if "robust" in b:
                g = np.abs(grads[n + "@GRAD"])
                held = d[g > b["robust_grad"] * g.max()]
            share, far = float(np.mean(d > b["close"] * lr)), float(held.max()) / lr
            worst["param_share"] = max(worst["param_share"], share)
            worst["param_far"] = max(worst["param_far"], far)
            check(share <= b["share"] and far <= b.get("far", b.get("robust")),
                  f"{n}: {share:.2%} of the parameter beyond {b['close']} lr, "
                  f"the largest held value {far:.3f} lr apart")
    return worst


# ------------------------------------------------------------------- LSTM --
# bench.py's lstm entry (_build_lstm_train, bench.py:261-317) at its
# defaults: V=30000, emb 128, H=512, 100 tokens a sequence, B=128, bf16;
# Adam(2e-3), L2Decay(8e-4), GradientClipByGlobalNorm(25)
LSTM_BENCH = dict(vocab=30000, emb=128, hidden=512, seqlen=100, batch=128)
LSTM_LR, LSTM_L2, LSTM_CLIP = 2e-3, 8e-4, 25.0
# the small program of tests/test_torch_frontend.py, card against CPU
LSTM_SMALL = dict(vocab=64, emb=32, hidden=384, seqlen=6, batch=8)
# LSTM kernels against their plain versions, errors over the largest
# element of each plain output, which an output left at zero reads as 1.
# f32: the same f32 arithmetic summed in another order over 100 steps;
# dW, a sum over T·B terms that nearly cancel, 1e-4 of its largest
# element. bf16: h, c, the carries and the dgates are rounded at the same
# places on both sides, and a sum that lands near a rounding boundary may
# round one ulp apart, after which the flip travels through the
# recurrence: 2e-2 of the scale (five ulps just below 1). On seeded inputs,
# where every step's input is of one size, also a share of the differing
# elements of h_seq (dx), which a rounding in the wrong place breaks
# (checked beside it). On the training step's own inputs the share is
# printed, not held: the loss reaches the LSTM at its last step only, so
# the backward's dh decays over the 100 steps and one flip late in time
# moves every smaller value after it by an ulp of its own.
LSTM_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
LSTM_DW_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
LSTM_MAX_DIFFERING = 0.05
# (T, B, H) beyond the main path's: on a 132-SM card they take 1, 4 and 8
# hidden units per CTA, the last two with a partly empty last CTA, the
# last with dW outside the backward kernel
LSTM_EDGE = [(3, 1, 100), (5, 3, 301), (4, 5, 700)]
# (T, B, H) beyond those, first taken by the forward, and by the bf16
# backward on the same partition: T=1; H=100, not a whole group of 16
# units, at B=3 with a row masked at every step; B=300, more 32-row tiles
# than the card holds batch groups beside 32 unit groups, so a CTA walks
# several; H=1800, whose W slice does not fit shared memory and is read
# through L1. f32 where its kernels take H (their W slices in shared
# memory: not at 1800)
LSTM_FWD_EDGE = [(1, 3, 100), (4, 300, 512), (3, 2, 1800)]
# the launches of one training step: two stacked layers
LSTM_STEP_LAUNCHES = {"lstm_fwd": 2, "lstm_bwd": 2}
# the redesigned kernels' times before the redesign, at the main path's
# shapes on an H100 at 700 W (PERF.md, the table of TPU kernels): B1 and
# B2 a launch, B11 a step's 36 calls, B8's forward at layer 0, B3 a launch
# at the request's B=128 and B4 at the training step's B=256
EARLIER_MS = {"lstm_fwd": 11.0729, "lstm_bwd": 10.5066, "fused_conv_bn": 8.6320,
              "flash_fwd": 0.34521, "gru_fwd": 4.1154, "gru_bwd": 9.8263,
              # B12 a call at the request's K=N=2048 site, and B10 a launch
              "quant_matmul": 0.20372, "decoder_seq_bwd": 13.4923,
              # B9 a launch at the warm-up step's inputs, and B5 a call with
              # its wrapper at the per-step route's main path
              "decoder_seq_fwd": 11.7467, "attn_fwd": 0.0739,
              # B6 a call on the device (the first recorded call of the
              # step, t = 0), B7 a launch on the device, and B10's post-walk
              # pass a launch with its wrapper, at the main paths' inputs
              "attn_bwd_step": 0.04504, "attn_phase2": 0.49443, "decoder_seq_dep": 0.4456}
# the small program's biases on the card against the CPU in bf16: their
# gradients, sums over B·T cotangents that nearly cancel, are held to 0.1
# of their largest (tests/test_torch_frontend.py), so the values held to
# `robust` lr are those past 10% of the largest, and the moments within
# 0.2 (the gradient's bound, squared)
LSTM_BIAS_PARITY = dict(robust_grad=0.1, moment=0.2, moment_share=1.0)


def build_lstm_program(ptt, vocab, emb, hidden, seqlen, batch=None):
    """bench.py's _build_lstm_train through the port's own front end.
    Returns (main, startup, loss)."""
    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        words = ptt.layers.data("words", shape=[-1], dtype=np.int32, lod_level=1,
                                append_batch_size=False)
        label = ptt.layers.data("label", shape=[1], dtype=np.int32)
        logits = ptt.models.lstm_benchmark_net(words, vocab_size=vocab, emb_dim=emb,
                                               hidden=hidden, max_len=seqlen)
        loss = ptt.layers.mean(ptt.layers.softmax_with_cross_entropy(logits, label))
        ptt.optimizer.Adam(learning_rate=LSTM_LR,
                           regularization=ptt.regularizer.L2Decay(LSTM_L2),
                           grad_clip=ptt.optimizer.GradientClipByGlobalNorm(LSTM_CLIP)
                           ).minimize(loss)
    return main, startup, loss


def lstm_bench_feed(ptt, vocab, seqlen, batch, device):
    """bench.py's feed: `batch` sequences of `seqlen` tokens and binary
    labels from RandomState(0)."""
    rng = np.random.RandomState(0)
    seqs = [rng.randint(0, vocab, (seqlen,)).astype(np.int32) for _ in range(batch)]
    return {"words": ptt.LoDArray.from_sequences(seqs, capacity=batch * seqlen,
                                                 max_seqs=batch, device=device),
            "label": rng.randint(0, 2, (batch, 1)).astype(np.int32)}


def lstm_fwd_bound(x, mask, w):
    """Valid tokens only: x's valid rows, W and the f32 mask read once;
    h_seq, c_seq, h_T and c_T written once; the product h@W, 8·H² operations
    a token, at the io dtype's dense peak."""
    T, B, H4 = x.shape
    H, item = H4 // 4, x.element_size()
    tokens = float(mask.float().sum())
    nbytes = tokens * H4 * item + w.numel() * item + mask.numel() * 4 + 2 * (T + 1) * B * H * item
    return (*bound_ms(nbytes, tokens * 2 * H4 * H, PEAK_FLOPS[x.dtype]), nbytes)


def lstm_bwd_bound(args):
    """Valid tokens only: gates_pre (4H), c_prev, h_prev and dh_seq in and
    dx (4H) out for each; W, dhT, dcT and the f32 mask in and dW out once;
    the two products (dh, dW) 16·H² operations a token."""
    gp, cp, hp, dh, mask, w, dhT, dcT = args
    tokens = float(mask.float().sum())
    H, item = hp.shape[2], hp.element_size()
    nbytes = tokens * 11 * H * item + 2 * w.numel() * item + 2 * dhT.numel() * item \
        + mask.numel() * 4
    return (*bound_ms(nbytes, tokens * 16 * H * H, PEAK_FLOPS[hp.dtype]), nbytes)


def lstm_check(lk, kind, ins, reverse, label, max_errs, hold_share=True):
    """One LSTM kernel against its plain version on `ins`: errors over
    their scales, which an output left at zero must exceed; in bf16 the
    share of h_seq (dx) elements that differ, held where `hold_share`.
    Returns (got, want, share)."""
    fn, plain = (lk.lstm_fwd, lk.lstm_fwd_plain) if kind == "lstm_fwd" else \
        (lk.lstm_bwd, lk.lstm_bwd_plain)
    got = fn(*ins, reverse=reverse)
    want = plain(*ins, reverse=reverse)
    torch.cuda.synchronize()
    dt = want[0].dtype
    tols = [LSTM_TOL[dt]] * len(want)
    if kind == "lstm_bwd":
        tols[1] = LSTM_DW_TOL[dt]
    abs_errs, errs = zip(*(rel_err(g, w_) for g, w_ in zip(got, want)))
    share = float((got[0] != want[0]).float().mean())
    names = ("h_seq", "c_seq", "h_T", "c_T") if kind == "lstm_fwd" else ("dx", "dW")
    # at T=1 dW = h_prevᵀ dgates is 0 in exact arithmetic (h_prev is the zero
    # initial state): held to be exactly 0 on both sides instead
    zero = ("dW",) if kind == "lstm_bwd" and ins[0].shape[0] == 1 else ()
    print(f"  {kind} {label} {str(dt)[6:]} {'rev' if reverse else 'fwd'}: rel err "
          + ", ".join(f"{n} {e:.3e} (tol {t:g})" for n, e, t in zip(names, errs, tols))
          + f"; {names[0]} differing {share:.4%}"
          + (f" (max {LSTM_MAX_DIFFERING:.0%})" if hold_share and dt == torch.bfloat16 else ""))
    check(all(torch.isfinite(t.float()).all() for t in got), f"non-finite {kind} output")
    check(all(e <= t for e, t in zip(errs, tols)), f"{kind} disagrees with its plain version")
    check(all(amax(w_) > 0 for n, w_ in zip(names, want) if n not in zero),
          f"{kind} {label}: an output left at zero would pass")
    check(all(amax(g) == 0 and amax(w_) == 0 for n, g, w_ in zip(names, got, want) if n in zero),
          f"{kind} {label}: dW is not 0 at T=1")
    check(dt != torch.bfloat16 or not hold_share or share <= LSTM_MAX_DIFFERING,
          f"{kind}'s {names[0]} differs in {share:.4%} (max {LSTM_MAX_DIFFERING:.0%})")
    max_errs[kind] = max(max_errs.get(kind, 0.0), *abs_errs)
    return got, want, share


def cudnn_lstm_ms(x, mask, w):
    """The yardstick: torch.nn.LSTM (cuDNN) on the same pre-projected x,
    with input_size 4H, weight_ih the identity, zero biases and
    weight_hh = W^T, on a PackedSequence of the mask's lengths. Times its
    forward (training mode) and its backward (dx and dW) alone, and the
    [T·B,4H]x[4H,4H] identity product it adds, in x's dtype. Returns a
    dict of the times, the dtype timed and cuDNN's h_seq."""
    from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

    T, B, H4 = x.shape
    H, dt = H4 // 4, x.dtype
    lengths = mask.sum(0).cpu()
    lstm = torch.nn.LSTM(H4, H).to(device=x.device, dtype=dt)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(torch.eye(H4))
        lstm.weight_hh_l0.copy_(w.T)
        lstm.bias_ih_l0.zero_()
        lstm.bias_hh_l0.zero_()
    # One weight buffer, as cuDNN wants it. flatten_parameters() skips any
    # dtype that torch.backends.cudnn.is_acceptable rejects, bf16 among
    # them, and cuDNN would then compact the weights at every call: let it
    # accept x's dtype for that call.
    acceptable = torch.backends.cudnn.is_acceptable
    torch.backends.cudnn.is_acceptable = lambda t: t.dtype == dt or acceptable(t)
    try:
        lstm.flatten_parameters()
    finally:
        torch.backends.cudnn.is_acceptable = acceptable
    storages = {p.untyped_storage().data_ptr() for p in lstm._flat_weights}
    if len(storages) != 1:
        raise RuntimeError(f"cuDNN's LSTM weights lie in {len(storages)} buffers, not one")
    xin = x.detach().requires_grad_(True)
    out, _ = lstm(pack_padded_sequence(xin, lengths, enforce_sorted=False))
    grad = torch.randn_like(out.data)
    fwd = cuda_ms(lambda: lstm(pack_padded_sequence(xin, lengths, enforce_sorted=False)), 10)
    bwd = cuda_ms(lambda: torch.autograd.backward(out.data, grad, retain_graph=True), 10)
    eye = torch.eye(H4, device=x.device, dtype=dt)
    proj = cuda_ms(lambda: torch.matmul(xin.detach().reshape(T * B, H4), eye), 20)
    h_seq, _ = pad_packed_sequence(out, total_length=T)
    return dict(fwd_ms=fwd, bwd_ms=bwd, proj_ms=proj, dtype=str(dt)[6:], h_seq=h_seq.detach())


def lstm_phases(ptt, exe, rng, smi, seed, first_phase):
    """Phases first_phase.. of the LSTM slice; returns the kernels' rows,
    their largest errors and their launches on the training path."""
    from paddle_tpu_torch.ops import lstm_kernels as lk

    n = first_phase
    phase(n, "LSTM training program at full width (bf16), built by the port's front end: "
          "startup and a warm-up step")
    main_p, startup, loss = build_lstm_program(ptt, **LSTM_BENCH)
    main_p.set_amp("bfloat16")
    ops = [o.type for o in main_p.global_block().ops]
    print(f"  main program: {len(ops)} ops ({ops.count('stacked_lstm2')} stacked_lstm2, "
          f"{ops.count('adam')} adam, {ops.count('clip_by_global_norm')} clip_by_global_norm, "
          f"{ops.count('scale')} scale); startup: {len(startup.global_block().ops)} ops")
    scope = ptt.Scope()
    t0 = time.perf_counter()
    exe.run(startup, scope=scope, seed=seed)
    torch.cuda.synchronize()
    n_values = sum(scope.get(p.name).numel() for p in main_p.parameters())
    print(f"  startup: {len(main_p.parameters())} parameters with {n_values} values, "
          f"{time.perf_counter() - t0:.2f} s")
    feed = lstm_bench_feed(ptt, LSTM_BENCH["vocab"], LSTM_BENCH["seqlen"],
                           LSTM_BENCH["batch"], exe.device)
    tokens = LSTM_BENCH["batch"] * LSTM_BENCH["seqlen"]
    calls, restore = record_calls(lk, {"lstm_fwd": "all", "lstm_bwd": "all"})
    try:
        t0 = time.perf_counter()
        losses = [float(exe.run(main_p, feed, [loss.name], scope=scope)[0])]
        torch.cuda.synchronize()
    finally:
        restore()
    print(f"  warm-up step: loss {losses[0]:.6f}, {time.perf_counter() - t0:.3f} s; "
          f"{tokens} tokens; recorded {len(calls['lstm_fwd'])} lstm_fwd and "
          f"{len(calls['lstm_bwd'])} lstm_bwd calls")
    check(len(calls["lstm_fwd"]) == 2 and len(calls["lstm_bwd"]) == 2,
          "the warm-up step did not run 2 lstm_fwd and 2 lstm_bwd")

    n += 1
    phase(n, "LSTM kernels against plain (the warm-up step's inputs, then seeded inputs)")
    rows, max_errs = {}, {}
    # the backward runs layer 2's call first
    for i, ((a, _), (ba, _)) in enumerate(zip(calls["lstm_fwd"], calls["lstm_bwd"][::-1])):
        x, mask, w = a
        for dt in (torch.bfloat16, torch.float32):
            fx, fw = x.to(dt), w.to(dt)
            for rev in (False, True):
                label = f"layer {i + 1} T={x.shape[0]} B={x.shape[1]} H={w.shape[0]}"
                got, want, _ = lstm_check(lk, "lstm_fwd", (fx, mask, fw), rev, label, max_errs,
                                          hold_share=False)
                bins = lk.lstm_bwd_inputs(fx, fw, want[0], want[1], rev)
                if rev:  # the step's own backward inputs are forward-only
                    bargs = (*bins, torch.randn_like(want[0]) * 0.01, mask, fw,
                             torch.zeros_like(want[2]), torch.zeros_like(want[3]))
                else:
                    bargs = tuple(t.to(dt) if t.is_floating_point() else t for t in ba)
                lstm_check(lk, "lstm_bwd", bargs, rev, label, max_errs, hold_share=False)
                if i == 0 and dt == torch.bfloat16 and not rev:
                    k_ms = cuda_ms(lambda: lk.lstm_fwd(fx, mask, fw), 10)
                    p_ms = cuda_ms(lambda: lk.lstm_fwd_plain(fx, mask, fw), 2)
                    b_ms, b_by, nbytes = lstm_fwd_bound(fx, mask, fw)
                    bk_ms = cuda_ms(lambda: lk.lstm_bwd(*bargs), 10)
                    bp_ms = cuda_ms(lambda: lk.lstm_bwd_plain(*bargs), 2)
                    bb_ms, bb_by, bbytes = lstm_bwd_bound(bargs)
                    lib = cudnn_lstm_ms(fx, mask, fw)
                    lib_err = float((lib["h_seq"].float() - want[0].float()).abs().max())
                    T_ = fx.shape[0]
                    print(f"    lstm_fwd: kernel {k_ms:.4f} ms ({k_ms / T_ * 1e3:.2f} us a time "
                          f"step; {EARLIER_MS['lstm_fwd']} ms before the redesign), plain "
                          f"{p_ms:.4f} ms, bound {b_ms:.5f} ms by {b_by} ({nbytes:.0f} B)")
                    print(f"    lstm_bwd: kernel {bk_ms:.4f} ms ({bk_ms / T_ * 1e3:.2f} us a "
                          f"time step; {EARLIER_MS['lstm_bwd']} ms before the redesign), plain "
                          f"{bp_ms:.4f} ms, bound {bb_ms:.5f} ms by {bb_by} ({bbytes:.0f} B)")
                    print(f"    cuDNN torch.nn.LSTM ({lib['dtype']}, input_size 4H, identity "
                          f"weight_ih, zero biases, PackedSequence): forward {lib['fwd_ms']:.4f} "
                          f"ms, backward {lib['bwd_ms']:.4f} ms, of which its identity "
                          f"[T*B,4H]x[4H,4H] product alone {lib['proj_ms']:.4f} ms; its h_seq "
                          f"{lib_err:.3e} from the plain forward's; lstm_fwd at "
                          f"{lib['fwd_ms'] / k_ms:.2f}x cuDNN's forward pace, lstm_bwd at "
                          f"{lib['bwd_ms'] / bk_ms:.2f}x its backward's ({bk_ms / T_ * 1e3:.2f} "
                          f"against {lib['bwd_ms'] / T_ * 1e3:.2f} us a time step)")
                    rows["lstm_fwd"] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                                            library_ms=lib["fwd_ms"])
                    rows["lstm_bwd"] = dict(ms=bk_ms, plain_ms=bp_ms, bound_ms=bb_ms,
                                            bound_by=bb_by, library_ms=lib["bwd_ms"])
    main_shape = (LSTM_BENCH["seqlen"], LSTM_BENCH["batch"], LSTM_BENCH["hidden"])
    for (T_, B_, H_), label in [(main_shape, "(main shapes, seeded, ragged)")] + \
            [(s, "") for s in LSTM_EDGE]:
        lens = torch.as_tensor(rng.randint(1, T_ + 1, size=B_))
        lens[0] = T_
        mask = (torch.arange(T_)[:, None] < lens[None, :]).cuda()
        for dt in LSTM_TOL:
            x = torch.as_tensor(rng.standard_normal((T_, B_, 4 * H_)), dtype=dt).cuda()
            w = torch.as_tensor(rng.standard_normal((H_, 4 * H_)) / np.sqrt(H_), dtype=dt).cuda()
            for rev in (False, True):
                tag = f"T={T_} B={B_} H={H_} {label}".strip()
                got, want, _ = lstm_check(lk, "lstm_fwd", (x, mask, w), rev, tag, max_errs)
                gp, cp, hp = lk.lstm_bwd_inputs(x, w, want[0], want[1], rev)
                dh, dhT, dcT = ((0.1 * torch.randn(*s, device="cuda")).to(dt)
                                for s in ((T_, B_, H_), (B_, H_), (B_, H_)))
                bargs = (gp, cp, hp, dh, mask, w, dhT, dcT)
                bgot, _, _ = lstm_check(lk, "lstm_bwd", bargs, rev, tag, max_errs)
                if dt != torch.bfloat16 or rev or label == "":
                    continue
                again = lk.lstm_bwd(*bargs)
                check(all(torch.equal(a_, b_) for a_, b_ in zip(bgot, again)),
                      "lstm_bwd's dx or dW differ between two runs")
                print(f"    lstm_bwd {tag}: dx and dW the same bits in two runs")
                f32 = lk.lstm_fwd_plain(x.float(), mask, w.float())[0].to(dt)
                off = float((f32 != got[0]).float().mean())
                bf32 = lk.lstm_bwd_plain(*(t.float() if t.is_floating_point() else t
                                           for t in bargs))[0].to(dt)
                boff = float((bf32 != bgot[0]).float().mean())
                print(f"    rounded only at the output: h_seq differing {off:.4%}; the "
                      f"backward with f32 carries and dgates: dx differing {boff:.4%}")
                check(off > LSTM_MAX_DIFFERING and boff > LSTM_MAX_DIFFERING,
                      "the bf16 share bound does not catch a misplaced rounding")
    for T_, B_, H_ in LSTM_FWD_EDGE:
        lens = torch.as_tensor(rng.randint(1, T_ + 1, size=B_))
        lens[0] = T_
        if B_ > 2:
            lens[1] = 0  # a row masked at every step
        mask = (torch.arange(T_)[:, None] < lens[None, :]).cuda()
        for dt in LSTM_TOL:
            if dt == torch.float32 and H_ > 1056:
                continue
            x = torch.as_tensor(rng.standard_normal((T_, B_, 4 * H_)), dtype=dt).cuda()
            w = torch.as_tensor(rng.standard_normal((H_, 4 * H_)) / np.sqrt(H_), dtype=dt).cuda()
            for rev in (False, True):
                tag = f"T={T_} B={B_} H={H_} (forward's edge)"
                _, want, _ = lstm_check(lk, "lstm_fwd", (x, mask, w), rev, tag, max_errs)
                gp, cp, hp = lk.lstm_bwd_inputs(x, w, want[0], want[1], rev)
                dh, dhT, dcT = ((0.1 * torch.randn(*s, device="cuda")).to(dt)
                                for s in ((T_, B_, H_), (B_, H_), (B_, H_)))
                lstm_check(lk, "lstm_bwd", (gp, cp, hp, dh, mask, w, dhT, dcT), rev, tag, max_errs)

    n += 1
    phase(n, "LSTM training at full width (bf16): 3 timed steps")
    torch.cuda.reset_peak_memory_stats()
    lk.lstm_fwd_launches = lk.lstm_bwd_launches = 0
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        losses.append(float(exe.run(main_p, feed, [loss.name], scope=scope)[0]))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = {"lstm_fwd": lk.lstm_fwd_launches, "lstm_bwd": lk.lstm_bwd_launches}
    print(f"  losses (warm-up, then timed): {losses}")
    check(all(np.isfinite(losses)), "non-finite loss")
    check(losses[-1] < losses[0], "the loss did not fall over 4 steps on one batch")
    print(f"  launches in 3 steps: {launches}; per step expected {LSTM_STEP_LAUNCHES}")
    for k, c in LSTM_STEP_LAUNCHES.items():
        check(launches[k] == 3 * c, f"{k} launched {launches[k]} times in 3 steps")
    med = statistics.median(times)
    print(f"  steps ms: {[round(t, 3) for t in times]}; median {med:.3f} ms/step, "
          f"{tokens / med * 1e3:.1f} tokens/s (B={LSTM_BENCH['batch']}, "
          f"{LSTM_BENCH['seqlen']} tokens each); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {smi}")
    breakdown(lambda: exe.run(main_p, feed, [loss.name], scope=scope), med, "step")

    n += 1
    phase(n, "small LSTM program: card against CPU (f32, then bf16)")
    smain, sstart, sloss = build_lstm_program(ptt, **LSTM_SMALL)
    state = seeded_state(ptt, smain, sstart, seed + 5)
    srng = np.random.RandomState(seed + 6)
    T_, B_, V_ = LSTM_SMALL["seqlen"], LSTM_SMALL["batch"], LSTM_SMALL["vocab"]
    sfeeds = []
    for _ in range(2):
        lens = srng.randint(2, T_ + 1, size=B_)
        lens[0] = T_
        seqs = [srng.randint(0, V_, size=k).astype(np.int32) for k in lens]
        sfeeds.append({"words": ptt.LoDArray.from_sequences(seqs, capacity=B_ * T_, max_seqs=B_),
                       "label": srng.randint(0, 2, (B_, 1)).astype(np.int32)})
    params = [p.name for p in smain.parameters()]
    biases = [p.name for p in smain.parameters() if len(p.shape) == 1]
    gnames = [p + "@GRAD" for p in params]
    for amp in (None, "bfloat16"):
        smain.set_amp(amp)
        res = {}
        for dev in ("cpu", "cuda"):
            sc_ = ptt.Scope()
            ptt.io.params_from_numpy(sc_, state, dev)
            dexe = ptt.Executor(device=dev)
            out = dexe.run(smain, sfeeds[0], [sloss.name] + gnames, scope=sc_)
            ls = [float(out[0]), float(dexe.run(smain, sfeeds[1], [sloss.name], scope=sc_)[0])]
            res[dev] = (ls, ptt.io.state_to_numpy(sc_, list(state)), dict(zip(gnames, out[1:])))
        (cl, cs, cg), (gl, gs, _) = res["cpu"], res["cuda"]
        seen = {g: cg[g] + LSTM_L2 * state[p] for p, g in zip(params, gnames)}
        lerr = max(abs(a - b) / abs(a) for a, b in zip(cl, gl))
        worst = compare_state(gs, cs, amp, seen, lr=LSTM_LR, biases=biases)
        b = TRAIN_PARITY[amp]
        loss_tol = b["loss"] if amp is None else 1e-3
        print(f"  {amp or 'f32'}: losses cpu {cl} card {gl}, rel {lerr:.3e} (tol {loss_tol:g}); "
              f"after 2 steps {worst['param_share']:.3%} of parameter values beyond "
              f"{b['close']} lr (max {b['share']:.1%}); the largest held value "
              f"{worst['param_far']:.3f} lr apart (max {b.get('far', b.get('robust'))}); "
              f"moments {worst['moment']:.3e}, {worst['moment_share']:.3%} beyond 1%")
        check(lerr <= loss_tol, "card and CPU losses differ")
    return rows, max_errs, launches


# ------------------------------------------------------------ transformer --
# bench.py's transformer row of the `all` sweep (_build_transformer_train,
# bench.py:378-422, with bench.py:445-446): dim 2048, 32 heads of D=64, 8
# layers, FFN 8192 (gelu), T=1024, vocab 32000, B=8, causal pre-LN,
# Adam(3e-4), bf16 amp; its BENCH_REMAT=full is left out (memory_optimize is
# not ported)
TFM_BENCH = dict(dim=2048, heads=32, layers=8, seqlen=1024, vocab=32000, batch=8)
TFM_LR = 3e-4
# the small program, card against CPU: D=64 as on the main path, a ragged T
TFM_SMALL = dict(dim=128, heads=2, layers=2, seqlen=200, vocab=512, batch=4)
# flash kernels against their plain versions. Each output's error over its
# largest element, against the plain version computed in f32 from the same
# io-dtype inputs. f32: the same f32 arithmetic in another order, 1e-5.
# bf16: the kernels round P (relative to the running row max) and dS to
# bf16 before their second products, as the TPU kernel does, where the f32
# plain version does not: 2e-2 (tests/test_torch_transformer.py holds the
# bf16 plain versions to the f32 formula with the same bound). In bf16 the
# kernel is also held to the bf16 plain version, which rounds where it
# does: at most FLASH_BEYOND_ULP of the elements more than one bf16 ulp
# apart, which the f32 plain version rounded only at its outputs must break
# on seeded inputs (phase 15 prints its share beside the kernel's).
# LSE is f32 in both io dtypes: 1e-5 of its largest element.
FLASH_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
FLASH_LSE_TOL = 1e-5
FLASH_BEYOND_ULP = 0.02
# seeded shapes beyond the main path's: (B, T, H, D), ragged T, both D;
# then T=1, T within one 64-row tile of 64 and 128 (63, 65, 127, 129), H=1
# and H odd, and T=1024 beside the main path's (each shape runs causal and
# full). At T=1 each query sees one key, so P = 1: rounding P changes
# nothing (no seeded discrimination there) and dK, dQ are 0 in exact
# arithmetic (see flash_scales).
FLASH_EDGE = [(2, 200, 3, 64), (2, 1000, 2, 64), (2, 200, 2, 128), (1, 1000, 2, 128),
              (2, 1, 3, 64), (1, 63, 1, 128), (2, 65, 1, 64), (1, 127, 5, 128), (2, 129, 1, 64),
              (1, 1024, 4, 64)]
# the views the kernels read in place or copy: q, k and v as [B,T,H,D]
# views of one packed [B,T,3E] projection (strides 3E, D, read through the
# tensor maps as they are), dO with d strided (copied by
# flash_kernels._aligned); (B, T, H, D)
FLASH_VIEWS = [(2, 200, 3, 64), (1, 127, 2, 128)]
# how phase 16 sums the profiled step's device time (cuBLAS's Hopper GEMMs
# are named nvjet_* or *gemm*)
TFM_KERNEL_KINDS = {"flash forward": ("flash_fwd",), "flash backward": ("flash_bwd",),
                    "matrix products": ("nvjet", "gemm", "cutlass"),
                    "elementwise": ("elementwise", "copy", "fill"),
                    "reductions": ("reduce", "softmax", "norm")}
# the launches of one training step: one a layer and pass
TFM_STEP_LAUNCHES = {"flash_fwd": 8, "flash_bwd_dkv": 8, "flash_bwd_dq": 8}
# the key projection's bias: its gradient is 0 in exact arithmetic (a
# per-row shift of the scores leaves softmax unchanged), so its value after
# two steps is rounding noise on both sides and is not held
TFM_NULL_GRAD = ".attn.wk_b"


def build_transformer_program(ptt, dim, heads, layers, seqlen, vocab, batch=None):
    """bench.py's _build_transformer_train through the port's own front end.
    Returns (main, startup, loss)."""
    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        toks = ptt.layers.data("toks", shape=[seqlen], dtype=np.int32)
        labels = ptt.layers.data("labels", shape=[seqlen, 1], dtype=np.int32)
        logits = ptt.models.transformer_lm(toks, vocab_size=vocab, dim=dim, num_heads=heads,
                                           num_layers=layers, max_len=seqlen)
        loss = ptt.layers.mean(ptt.layers.softmax_with_cross_entropy(logits, labels))
        ptt.optimizer.Adam(learning_rate=TFM_LR).minimize(loss)
    return main, startup, loss


def transformer_feed(rng, vocab, seqlen, batch):
    """bench.py's feed: tokens and labels drawn from `rng`."""
    return {"toks": rng.randint(0, vocab, (batch, seqlen)).astype(np.int32),
            "labels": rng.randint(0, vocab, (batch, seqlen, 1)).astype(np.int32)}


def flash_bound(name, q, causal):
    """Least time for one kernel's function on these inputs: each [B,T,H,D]
    input read and output written once (fwd: q, k, v in, o out; dkv: q, k,
    v, dO in, dK, dV out; dq: q, k, v, dO in, dQ out) and the f32 LSE and
    Di; the products over the visible (q, k) pairs only (causal: T(T+1)/2 a
    head), 2·D operations a pair for each: S and P·V (fwd); S, dP, dV, dK
    (dkv); S, dP, dQ (dq); at the io dtype's peak (bf16 on tensor cores, f32
    on FMAs)."""
    B, T, H, D = q.shape
    pairs = (T * (T + 1) / 2 if causal else T * T) * B * H
    tensors, stats, products = {"flash_fwd": (4, 1, 2), "flash_bwd_dkv": (6, 2, 4),
                                "flash_bwd_dq": (5, 2, 3)}[name]
    nbytes = tensors * q.numel() * q.element_size() + stats * B * H * T * 4
    return (*bound_ms(nbytes, products * 2 * D * pairs, PEAK_FLOPS[q.dtype]), nbytes)


def flash_call(fk, name, ins, plain=False):
    """The kernel (or its plain version) on ins = (q, k, v[, dO, LSE, Di])
    and causal; always a tuple of outputs."""
    fn = getattr(fk, f"{name}_plain" if plain else name)
    out = fn(*ins)
    return out if isinstance(out, tuple) else (out,)


def flash_scales(name, ins, outs, want):
    """The scale each output's error is held to: its largest element. At
    T=1 each query sees one key, so P = 1 and dS = P∘(dP − Di)·scale is 0
    in exact arithmetic: dK = dSᵀ Q and dQ = dS K are rounding noise on
    both sides, held instead to the largest sum of their terms' magnitudes,
    (|dP| + |Di|)·scale·|Q| (|K|), with dP = dO·V. Returns (scales, the
    outputs that are noise)."""
    scales = [amax(w) for w in want]
    q = ins[0]
    if name == "flash_fwd" or q.shape[1] != 1:
        return scales, ()
    k, v, do, _, di = (t.float() for t in ins[1:6])
    dp = (do * v).sum(-1)  # [B,1,H]
    terms = ((dp.abs() + di.transpose(1, 2).abs()) / math.sqrt(q.shape[-1]))[..., None]
    noise = {"dk": terms * q.float().abs(), "dq": terms * k.abs()}
    return [amax(noise[n]) if n in noise else s for n, s in zip(outs, scales)], tuple(noise)


def flash_check(fk, name, ins, label, max_errs, seeded=False):
    """Kernel against the f32 plain version (FLASH_TOL) and, in bf16, against
    the bf16 plain version (FLASH_BEYOND_ULP); an output left at zero reads
    an error of 1, but where it is 0 in exact arithmetic (flash_scales).
    On `seeded` inputs the f32 plain version rounded only at its outputs (P
    and dS unrounded) must break the bf16 bound. Returns the kernel's
    outputs."""
    *tensors, causal = ins
    dt = tensors[0].dtype
    want = flash_call(fk, name, (*(t.float() for t in tensors), causal), plain=True)
    got = flash_call(fk, name, ins)
    torch.cuda.synchronize()
    outs = {"flash_fwd": ("o", "lse"), "flash_bwd_dkv": ("dk", "dv"),
            "flash_bwd_dq": ("dq",)}[name]
    scales, noise = flash_scales(name, ins, outs, want)
    parts = []
    for n, g, w, sc in zip(outs, got, want, scales):
        check(g.dtype == (torch.float32 if n == "lse" else dt), f"{name} {n} dtype {g.dtype}")
        check(bool(torch.isfinite(g.float()).all()), f"non-finite {name} {n}")
        err, rel = rel_err(g, w, sc)
        tol = FLASH_LSE_TOL if n == "lse" else FLASH_TOL[dt]
        parts.append(f"{n} {rel:.3e} (tol {tol:g}{', of its terms' if n in noise else ''})")
        check(rel <= tol, f"{name} {label}: {n} disagrees with its plain version: {rel:.3e}")
        max_errs[name] = max(max_errs.get(name, 0.0), err)
    line = f"  {name} {label} {str(dt)[6:]} {'causal' if causal else 'full'}: rel err " + \
        ", ".join(parts)
    if dt == torch.bfloat16:
        def beyond(a, b):  # share of a's elements more than one ulp of b from b
            a, b = a.float().cpu().numpy(), b.float().cpu().numpy()
            return float(np.mean(np.abs(a - b) > bf16_ulp(b)))

        want_io = flash_call(fk, name, ins, plain=True)
        pairs = [(g, w_io, w) for n, g, w_io, w in zip(outs, got, want_io, want)
                 if n != "lse" and n not in noise]
        if pairs:
            share = max(beyond(g, w_io) for g, w_io, _ in pairs)
            off = min(beyond(w.to(dt), w_io) for _, w_io, w in pairs)
            line += f"; beyond one ulp of the bf16 plain version {share:.4%} " \
                    f"(max {FLASH_BEYOND_ULP:.0%}), rounded only at the output {off:.4%}"
            check(share <= FLASH_BEYOND_ULP,
                  f"{name} {label}: differs from the bf16 plain version by more than one ulp "
                  f"in {share:.4%}")
            check(not seeded or off > FLASH_BEYOND_ULP,
                  f"{name} {label}: the bf16 bound does not catch P or dS rounded elsewhere")
    print(line)
    return got


def flash_views(fk, rng, B, T, H, D, dt, causal):
    """flash_seeded's backward inputs, with q, k and v [B,T,H,D] views of one
    packed [B,T,3E] tensor and dO a view with d strided (FLASH_VIEWS)."""
    ins = flash_seeded(fk, rng, B, T, H, D, dt, causal)["flash_bwd_dkv"]
    q, k, v, do, lse, di, _ = ins
    packed = torch.cat([t.reshape(B, T, H * D) for t in (q, k, v)], -1)  # [B,T,3E]
    q, k, v = (packed[..., i * H * D:(i + 1) * H * D].view(B, T, H, D) for i in range(3))
    spread = torch.zeros(B, T, H, 2 * D, dtype=dt, device=do.device)
    spread[..., ::2] = do
    return (q, k, v, spread[..., ::2], lse, di, causal)


def flash_seeded(fk, rng, B, T, H, D, dt, causal):
    """Normal q, k, v, dO at these widths, LSE and Di from the f32 plain
    forward: the inputs of the three kernels."""
    q, k, v, do = (torch.as_tensor(rng.standard_normal((B, T, H, D)), dtype=torch.float32)
                   .cuda().to(dt) for _ in range(4))
    o, lse = fk.flash_fwd_plain(*(t.float() for t in (q, k, v)), causal)
    di = fk.flash_di(o, do.float())
    return {"flash_fwd": (q, k, v, causal),
            "flash_bwd_dkv": (q, k, v, do, lse, di, causal),
            "flash_bwd_dq": (q, k, v, do, lse, di, causal)}


def sdpa_ms(q, k, v, do, causal):
    """The yardstick, never called by the port: one
    torch.nn.functional.scaled_dot_product_attention call on the same [B,T,H,D]
    tensors seen as [B,H,T,D]: its forward, and its forward and backward
    (dQ, dK, dV). Returns (forward ms, backward ms, its O)."""
    import torch.nn.functional as F

    bhtd = lambda t: t.transpose(1, 2)  # noqa: E731
    fwd = cuda_ms(lambda: F.scaled_dot_product_attention(bhtd(q), bhtd(k), bhtd(v),
                                                         is_causal=causal), 20)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]

    def fwd_bwd():
        o = F.scaled_dot_product_attention(*(bhtd(t) for t in leaves), is_causal=causal)
        torch.autograd.grad(o, leaves, bhtd(do))

    both = cuda_ms(fwd_bwd, 20)
    with torch.no_grad():
        o = F.scaled_dot_product_attention(bhtd(q), bhtd(k), bhtd(v), is_causal=causal)
    return fwd, both - fwd, bhtd(o)


def transformer_phases(ptt, exe, rng, smi, seed, first_phase):
    """Phases first_phase.. of the transformer slice; returns the kernels'
    rows, their largest errors and their launches on the training path."""
    from paddle_tpu_torch.ops import flash_kernels as fk
    from paddle_tpu_torch.ops import flash_ops

    n = first_phase
    phase(n, "transformer LM at full width (bf16), built by the port's front end: startup "
          "and a warm-up step")
    main_p, startup, loss = build_transformer_program(ptt, **TFM_BENCH)
    main_p.set_amp("bfloat16")
    ops = [o.type for o in main_p.global_block().ops]
    print(f"  main program: {len(ops)} ops ({ops.count('flash_attention')} flash_attention, "
          f"{ops.count('layer_norm')} layer_norm, {ops.count('gelu')} gelu, "
          f"{ops.count('adam')} adam); startup: {len(startup.global_block().ops)} ops")
    scope = ptt.Scope()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    exe.run(startup, scope=scope, seed=seed)
    torch.cuda.synchronize()
    n_values = sum(scope.get(p.name).numel() for p in main_p.parameters())
    print(f"  startup: {len(main_p.parameters())} parameters with {n_values} values, "
          f"{time.perf_counter() - t0:.2f} s")
    feed = transformer_feed(np.random.RandomState(0), TFM_BENCH["vocab"], TFM_BENCH["seqlen"],
                            TFM_BENCH["batch"])
    tokens = TFM_BENCH["batch"] * TFM_BENCH["seqlen"]
    calls, restore = record_calls(fk, {"flash_fwd": "all", "flash_bwd_dkv": "all",
                                       "flash_bwd_dq": "all"})
    try:
        t0 = time.perf_counter()
        losses = [float(exe.run(main_p, feed, [loss.name], scope=scope)[0])]
        torch.cuda.synchronize()
    finally:
        restore()
    print(f"  warm-up step: loss {losses[0]:.6f}, {time.perf_counter() - t0:.3f} s; {tokens} "
          f"tokens; recorded " + ", ".join(f"{len(c)} {k}" for k, c in calls.items())
          + f" calls; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for k, c in TFM_STEP_LAUNCHES.items():
        check(len(calls[k]) == c, f"the warm-up step ran {len(calls[k])} {k}, not {c}")

    n += 1
    phase(n, "flash kernels against plain (the warm-up step's inputs, then seeded inputs)")
    rows, max_errs = {}, {}
    # the backward runs layer 7's calls first
    for layer, i in ((0, 0), (7, -1)):
        for name in TFM_STEP_LAUNCHES:
            a, _ = calls[name][i if name == "flash_fwd" else -1 - i]
            ins = tuple(a)
            label = f"layer {layer} B={ins[0].shape[0]} T={ins[0].shape[1]} " \
                    f"H={ins[0].shape[2]} D={ins[0].shape[3]}"
            flash_check(fk, name, ins, label, max_errs)
            if layer:
                continue
            k_ms = cuda_ms(lambda: flash_call(fk, name, ins), 20)
            p_ms = cuda_ms(lambda: flash_call(fk, name, ins, plain=True), 3)
            b_ms, b_by, nbytes = flash_bound(name, ins[0], ins[-1])
            earlier = f"; {EARLIER_MS[name] * 1e3:.2f} us before the redesign" \
                if name in EARLIER_MS else ""
            print(f"    {name}: kernel {k_ms * 1e3:.2f} us{earlier}, plain {p_ms * 1e3:.2f} us, "
                  f"bound {b_ms * 1e3:.2f} us by {b_by} ({nbytes:.0f} B), "
                  f"{100 * b_ms / k_ms:.2f}% of the bound")
            rows[name] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)
            again = flash_call(fk, name, ins)
            first = flash_call(fk, name, ins)
            check(all(torch.equal(x, y) for x, y in zip(first, again)),
                  f"{name}'s outputs differ between two runs")
            print(f"    {name}: the same bits in two runs")
    q, k, v, do = (calls["flash_bwd_dkv"][-1][0][j] for j in range(4))
    fwd_ms, bwd_ms, o_lib = sdpa_ms(q, k, v, do, True)
    o_plain = fk.flash_fwd_plain(q.float(), k.float(), v.float(), True)[0]
    print(f"  scaled_dot_product_attention (the yardstick, bf16, causal, [B,H,T,D] views): "
          f"forward {fwd_ms * 1e3:.2f} us, backward {bwd_ms * 1e3:.2f} us; its O "
          f"{rel_err(o_lib, o_plain)[1]:.3e} from the f32 plain version")
    f_ms = rows["flash_fwd"]["ms"]
    print(f"  flash_fwd at layer 0: {f_ms * 1e3:.2f} us, "
          f"{100 * rows['flash_fwd']['bound_ms'] / f_ms:.2f}% of its bound, "
          f"{f_ms / fwd_ms:.3f}x scaled_dot_product_attention's forward")
    rows["flash_fwd"]["library_ms"] = fwd_ms
    rows["flash_bwd_dkv"]["library_ms"] = rows["flash_bwd_dq"]["library_ms"] = bwd_ms
    pair_ms = rows["flash_bwd_dkv"]["ms"] + rows["flash_bwd_dq"]["ms"]
    print(f"  the backward pair at layer 0: {pair_ms * 1e3:.2f} us against "
          f"scaled_dot_product_attention's backward {bwd_ms * 1e3:.2f} us "
          f"({pair_ms / bwd_ms:.3f}x)")
    srng = np.random.RandomState(seed + 7)
    B_, T_, H_, D_ = (TFM_BENCH["batch"], TFM_BENCH["seqlen"],
                      TFM_BENCH["heads"], TFM_BENCH["dim"] // TFM_BENCH["heads"])
    for dt in FLASH_TOL:
        for causal in (True, False):
            ins = flash_seeded(fk, srng, B_, T_, H_, D_, dt, causal)["flash_fwd"]
            flash_check(fk, "flash_fwd", ins, f"B={B_} T={T_} H={H_} D={D_} (main shape, seeded)",
                        max_errs, seeded=True)
    del ins
    for B_, T_, H_, D_ in FLASH_EDGE:
        for dt in FLASH_TOL:
            for causal in (True, False):
                for name, ins in flash_seeded(fk, srng, B_, T_, H_, D_, dt, causal).items():
                    flash_check(fk, name, ins, f"B={B_} T={T_} H={H_} D={D_} (seeded)", max_errs,
                                seeded=T_ > 1)
    for B_, T_, H_, D_ in FLASH_VIEWS:
        for dt in FLASH_TOL:
            for causal in (True, False):
                ins = flash_views(fk, srng, B_, T_, H_, D_, dt, causal)
                check(ins[0].stride(1) == 3 * H_ * D_ and ins[3].stride(3) == 2,
                      "FLASH_VIEWS: not the packed and strided views")
                flash_check(fk, "flash_fwd", (*ins[:3], causal), f"B={B_} T={T_} H={H_} D={D_} "
                            f"(packed q, k, v)", max_errs, seeded=True)
                for name in ("flash_bwd_dkv", "flash_bwd_dq"):
                    flash_check(fk, name, ins, f"B={B_} T={T_} H={H_} D={D_} (packed q, k, v; "
                                f"strided dO)", max_errs, seeded=True)
    B_, T_, H_, D_ = 2, 129, 1, 64  # a FLASH_EDGE shape: a tile and a row, H=1
    edge = flash_seeded(fk, srng, B_, T_, H_, D_, torch.bfloat16, True)
    for name in TFM_STEP_LAUNCHES:
        first, again = flash_call(fk, name, edge[name]), flash_call(fk, name, edge[name])
        check(all(torch.equal(x, y) for x, y in zip(first, again)),
              f"{name}'s outputs differ between two runs at B={B_} T={T_} H={H_} D={D_}")
        print(f"    {name}: the same bits in two runs at B={B_} T={T_} H={H_} D={D_} (bf16, causal)")

    n += 1
    phase(n, "transformer training at full width (bf16): 3 timed steps")
    torch.cuda.reset_peak_memory_stats()
    for k in TFM_STEP_LAUNCHES:
        setattr(fk, f"{k}_launches", 0)
    flash_ops.plain_routes = 0
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        losses.append(float(exe.run(main_p, feed, [loss.name], scope=scope)[0]))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = {k: getattr(fk, f"{k}_launches") for k in TFM_STEP_LAUNCHES}
    plain_routes = flash_ops.plain_routes
    print(f"  losses (warm-up, then timed): {losses}")
    check(all(np.isfinite(losses)), "non-finite loss")
    check(losses[-1] < losses[0], "the loss did not fall over 4 steps on one batch")
    print(f"  launches in 3 steps: {launches}; per step expected {TFM_STEP_LAUNCHES}; "
          f"flash_attention calls routed to the plain formula: {plain_routes}")
    for k, c in TFM_STEP_LAUNCHES.items():
        check(launches[k] == 3 * c, f"{k} launched {launches[k]} times in 3 steps")
    check(plain_routes == 0, "the D=64 self-attention step routed attention to the plain formula")
    med = statistics.median(times)
    print(f"  steps ms: {[round(t, 3) for t in times]}; median {med:.3f} ms/step, "
          f"{tokens / med * 1e3:.1f} tokens/s (B={TFM_BENCH['batch']}, T={TFM_BENCH['seqlen']}); "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {smi}")
    _, by_kind = breakdown(lambda: exe.run(main_p, feed, [loss.name], scope=scope), med, "step",
                           kinds=TFM_KERNEL_KINDS)
    if by_kind:
        fwd_us, bwd_us = by_kind.get("flash forward", 0.0), by_kind.get("flash backward", 0.0)
        print(f"  the step's flash time: {(fwd_us + bwd_us) / 1e3:.3f} ms (forward "
              f"{fwd_us / 1e3:.3f}, backward {bwd_us / 1e3:.3f} ms)")
    del scope, calls

    n += 1
    phase(n, "small transformer program (D=64, T=200): card against CPU (f32, then bf16)")
    routes = transformer_card_vs_cpu(ptt, TFM_SMALL, seed + 8)
    check(routes == 0, "the D=64 program routed attention to the plain formula")
    return rows, max_errs, launches


def transformer_card_vs_cpu(ptt, widths, seed):
    """The transformer program at `widths`, card against CPU from one
    startup state (seeded on the CPU): losses and the state after 2 Adam
    steps, f32 then bf16 amp, with TRAIN_PARITY's bounds. Returns the
    flash_attention calls the card routed to the plain formula."""
    from paddle_tpu_torch.ops import flash_ops

    smain, sstart, sloss = build_transformer_program(ptt, **widths)
    sc_ = ptt.Scope()
    ptt.Executor(device="cpu").run(sstart, scope=sc_, seed=seed)
    names = [v.name for v in smain.persistables()]
    state = ptt.io.state_to_numpy(sc_, names)  # carried to both devices by params_from_numpy
    frng = np.random.RandomState(seed + 1)
    sfeeds = [transformer_feed(frng, widths["vocab"], widths["seqlen"], widths["batch"])
              for _ in range(2)]
    params = [p.name for p in smain.parameters()]
    vectors = [p for p in params if len(state[p].shape) == 1]
    gnames = [p + "@GRAD" for p in params]
    held = {n_ for n_ in names if TFM_NULL_GRAD not in n_}
    routes = 0
    for amp in (None, "bfloat16"):
        smain.set_amp(amp)
        res = {}
        for dev in ("cpu", "cuda"):
            before = flash_ops.plain_routes
            s = ptt.Scope()
            ptt.io.params_from_numpy(s, state, dev)
            dexe = ptt.Executor(device=dev)
            out = dexe.run(smain, sfeeds[0], [sloss.name] + gnames, scope=s)
            ls = [float(out[0]), float(dexe.run(smain, sfeeds[1], [sloss.name], scope=s)[0])]
            res[dev] = (ls, ptt.io.state_to_numpy(s, names), dict(zip(gnames, out[1:])))
            if dev == "cuda":
                routes += flash_ops.plain_routes - before
        (cl, cs, cg), (gl, gs, _) = res["cpu"], res["cuda"]
        lerr = max(abs(a - b) / abs(a) for a, b in zip(cl, gl))
        worst = compare_state({k: gs[k] for k in held}, {k: cs[k] for k in held}, amp, cg,
                              lr=TFM_LR, biases=vectors)
        b = TRAIN_PARITY[amp]
        print(f"  {amp or 'f32'}: losses cpu {cl} card {gl}, rel {lerr:.3e} (tol {b['loss']:g}); "
              f"after 2 steps {worst['param_share']:.3%} of parameter values beyond "
              f"{b['close']} lr (max {b['share']:.1%}); the largest held value "
              f"{worst['param_far']:.3f} lr apart (max {b.get('far', b.get('robust'))}); "
              f"moments {worst['moment']:.3e}, {worst['moment_share']:.3%} beyond 1%")
        check(lerr <= b["loss"], "card and CPU losses differ")
    D = widths["dim"] // widths["heads"]
    print(f"  head dim {D}: the card routed {routes} flash_attention calls to the plain formula")
    return routes


# The attention op's routing rule (flash_ops.kernel_takes): shapes the
# flash kernels do not take run the plain formula on the card. A
# cross-attention (multi_head_attention with 12 queries over 20 keys, 2
# heads of D=64) and the transformer LM at a head dim of 32, each card
# against CPU from one seeded state: the cross-attention's output within
# FLASH_TOL of its largest element, the transformer with TRAIN_PARITY's
# bounds.
CROSS_ATTN = dict(batch=4, tq=12, tk=20, dim=128, heads=2)
TFM_D32 = dict(dim=64, heads=2, layers=2, seqlen=16, vocab=64, batch=4)


def build_cross_attention(ptt, batch, tq, tk, dim, heads):
    """multi_head_attention of `tq` queries over `tk` keys through the
    port's front end. Returns (main, startup, out)."""
    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        q = ptt.layers.data("q", shape=[tq, dim], dtype=np.float32)
        kv = ptt.layers.data("kv", shape=[tk, dim], dtype=np.float32)
        out = ptt.layers.multi_head_attention(q, key=kv, value=kv, num_heads=heads, causal=False)
    return main, startup, out


def attention_routing_phase(ptt, seed, n):
    from paddle_tpu_torch.ops import flash_ops

    phase(n, "the attention op's routing: a cross-attention (Tk != Tq) and a D=32 transformer "
          "program, card against CPU")
    c = CROSS_ATTN
    main, startup, out = build_cross_attention(ptt, **c)
    sc_ = ptt.Scope()
    ptt.Executor(device="cpu").run(startup, scope=sc_, seed=seed)
    state = ptt.io.state_to_numpy(sc_, [v.name for v in main.persistables()])
    rng = np.random.RandomState(seed + 1)
    feed = {"q": rng.standard_normal((c["batch"], c["tq"], c["dim"])).astype(np.float32),
            "kv": rng.standard_normal((c["batch"], c["tk"], c["dim"])).astype(np.float32)}
    for amp, dt in ((None, torch.float32), ("bfloat16", torch.bfloat16)):
        main.set_amp(amp)
        res = {}
        for dev in ("cpu", "cuda"):
            s = ptt.Scope()
            ptt.io.params_from_numpy(s, state, dev)
            flash_ops.plain_routes = 0
            res[dev] = ptt.Executor(device=dev).run(main, feed, [out.name], scope=s,
                                                    return_numpy=False)[0]
        routes = flash_ops.plain_routes
        got, want = res["cuda"], res["cpu"]
        err, rel = rel_err(got.cpu(), want)
        print(f"  cross-attention B={c['batch']} Tq={c['tq']} Tk={c['tk']} {c['heads']} heads of "
              f"D={c['dim'] // c['heads']} {str(dt)[6:]}: card {tuple(got.shape)} {got.dtype}, "
              f"{rel:.3e} of the CPU's largest element from it (tol {FLASH_TOL[dt]:g}); the card "
              f"routed {routes} flash_attention call to the plain formula")
        check(tuple(got.shape) == (c["batch"], c["tq"], c["dim"]) and got.dtype == want.dtype,
              "the cross-attention's output shape or dtype")
        check(bool(torch.isfinite(got.float()).all()), "non-finite cross-attention output")
        check(routes == 1, f"the cross-attention routed {routes} calls to the plain formula")
        check(rel <= FLASH_TOL[dt], "card and CPU cross-attention differ")
    routes = transformer_card_vs_cpu(ptt, TFM_D32, seed + 2)
    layers = TFM_D32["layers"]
    check(routes == 2 * 2 * layers,  # f32 and bf16, two steps each, one call a layer
          f"the D=32 program routed {routes} calls to the plain formula, not {4 * layers}")


# ----------------------------------------------------------------- ResNet --
# bench.py's resnet entry (_build_resnet_train, bench.py:158-192) at its
# defaults: resnet_imagenet depth 50, NHWC 224x224x3, 1000 classes,
# softmax_with_cross_entropy + mean, Momentum(0.1, 0.9), bf16, B=128; in
# the slice's configuration, every 1x1 conv of the fused protocol a 2-D
# product (fused_conv_dot_max_n >= 128·56·56) through the hand-written
# kernel (fused_conv_pallas)
RESNET_BENCH = dict(hw=224, class_dim=1000, batch=128, lr=0.1)
RESNET_DOT_MAX_N = 128 * 56 * 56
RESNET_FLOP_PER_IMAGE = 3 * 8.2e9  # bench.py's count: train = 3 × the 8.2 GFLOP forward
# the small program of tests/test_torch_resnet.py, card against CPU
RESNET_SMALL = dict(hw=64, class_dim=10, batch=4, lr=1e-5)
# B11 against its plain version. Both sum the f32 products and round y
# once, in other orders, so a bf16 y may round one ulp apart near a
# rounding boundary, and further only where the sum cancels to far below
# its terms (a 2048-term sum's f32 error passes a bf16 ulp of a y a
# thousand times smaller than its terms): at most B11_BEYOND_ULP of y
# more than one bf16 ulp from the plain value. f32 y within B11_F32_TOL of its
# largest element. s and sq are f32 sums of the rounded y in other
# orders; a y that rounds one ulp apart moves them further (2·|y|·ulp in
# sq, past 1e-4 of a column of a few hundred rows), so they are held to
# the sums of the kernel's own y: within B11_STATS_TOL of Σ|y| and Σy²,
# and only printed beside the plain version's.
B11_BEYOND_ULP = 1e-3
B11_F32_TOL = 1e-5
B11_STATS_TOL = 1e-5
# seeded edge cases: (B, H, W, Cin, Cout, prologue, relu, stride): N not a
# multiple of the 128-row tile, N below one tile, Cin = 64, the prologue
# on and off, ReLU on and off, a stride-2 view read in place; and W's 2048
# x 2048, whose column tile is too large to stay in shared memory (read a
# K stage at a time, as in stage 4)
B11_EDGE = [(1, 1, 1000, 96, 128, True, False, 1), (1, 1, 37, 64, 64, True, True, 1),
            (3, 5, 7, 64, 192, False, False, 1), (4, 7, 7, 256, 512, True, True, 2),
            (4, 7, 7, 256, 512, False, False, 2), (2, 9, 9, 512, 64, True, False, 1),
            (1, 1, 300, 2048, 2048, True, True, 1)]
# how phase 20 sums the profiled step's device time
RESNET_KERNEL_KINDS = {"B11 (fused_conv_bn)": ("fused_conv_bn",),
                       "convolutions (cuDNN)": ("conv", "cudnn", "xmma", "sm90_", "implicit"),
                       "matrix products": ("nvjet", "gemm", "cutlass"),
                       "elementwise": ("elementwise", "copy", "fill"),
                       "reductions": ("reduce", "norm")}
# small program, card against CPU, two steps at RESNET_SMALL's lr (the
# bounds of tests/test_torch_resnet.py, where the port is held to the JAX
# package): f32 losses (first, second step) relative, gradients and
# updates relative L2; bf16 (the raw-statistics backward is noise in bf16
# on both sides) losses and running statistics, and norms within a factor
RESNET_PARITY = {
    None: dict(loss=(1e-3, 1e-2), grad=0.1, state=0.3, running=1e-2),
    "bfloat16": dict(loss=(5e-2, 1e-1), running=0.5, norm=2.0),
}
# RESNET_BF16_STATS_NOTE: phase 21 holds the small bf16 program with its
# batch statistics squared in f32 (bn_bf16_stats off), the configuration
# its bounds were set for. With the JAX package's default (bf16 squares,
# then max(E[x²] − E[x]², 0)) the B=4, 64x64 program is chaotic: its last
# stage normalises 16 rows a channel, where a one-ulp flip in a square
# moves the variance after the cancellation, so its losses move far when
# its images move by 1e-3 (phase 21 prints how far, as context). The
# default is held op by op instead: phase 21 replays the full-width step's
# own bn_stats and batch_norm calls, with the flag on as that step ran
# them, on the card and on the CPU. Each square rounds to bf16 alike on
# both, so only the order of the f32 sums differs: each channel's batch
# mean within BN_STATS_TOL of its rms, its batch variance (from BatchInv)
# within BN_STATS_TOL of its mean square, the running statistics beyond
# one f32 ulp within BN_STATS_TOL of (1 − momentum) times the same, and
# batch_norm's Y beyond one bf16 ulp within BN_STATS_TOL of its largest.
# Squares taken in f32 on one side move BatchInv by up to 9.4e-4 of its
# largest value (ROADMAP queue C, C2). A statistic left at zero must read
# above the bound. Tier-1 holds the flag's ops to the JAX package's, on
# and off.
BN_STATS_TOL = 1e-5
# BN scales whose gradient is 0 in exact arithmetic at the initial state
RESNET_NULL = ("branch2a_bn.w_0", "branch2b_bn.w_0")


def build_resnet_program(ptt, hw, class_dim, lr, batch=None):
    """bench.py's _build_resnet_train through the port's own front end
    (bf16 amp). Returns (main, startup, loss)."""
    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        img = ptt.layers.data("img", shape=[hw, hw, 3])
        label = ptt.layers.data("label", shape=[1], dtype=np.int32)
        logits = ptt.models.resnet_imagenet(img, class_dim=class_dim, data_format="NHWC")
        loss = ptt.layers.mean(ptt.layers.softmax_with_cross_entropy(logits, label))
        ptt.optimizer.Momentum(learning_rate=lr, momentum=0.9).minimize(loss)
    main.set_amp("bfloat16")
    return main, startup, loss


def resnet_feed(rng, hw, class_dim, batch):
    """bench.py's feed: normal images and integer labels from `rng`."""
    return {"img": rng.randn(batch, hw, hw, 3).astype(np.float32),
            "label": rng.randint(0, class_dim, (batch, 1)).astype(np.int32)}


class _Flags:
    """Sets the port's FLAGS for a block and restores them."""

    def __init__(self, flags, **values):
        self.flags, self.values, self.old = flags, values, {}

    def __enter__(self):
        for k, v in self.values.items():
            self.old[k] = getattr(self.flags, k)
            setattr(self.flags, k, v)

    def __exit__(self, *exc):
        for k, v in self.old.items():
            setattr(self.flags, k, v)


def b11_bound(x, cin, cout):
    """Least time for one call: x [N, Cin], W and y [N, Cout] in the io
    dtype once each, the four [Cin] f32 vectors and the two [Cout] f32
    statistics; 2·N·Cin·Cout operations at the io dtype's peak."""
    n = x.numel() // cin
    nbytes = (n * cin + cin * cout + n * cout) * x.element_size() + (4 * cin + 2 * cout) * 4
    return (*bound_ms(nbytes, 2.0 * n * cin * cout, PEAK_FLOPS[x.dtype]), nbytes)


def b11_label(x, w, vecs, relu):
    n = x.numel() // x.shape[-1]
    strided = not x.is_contiguous()
    return (f"N={n} Cin={x.shape[-1]} Cout={w.shape[0]} "
            f"{'prologue' + ('+relu' if relu else '') if vecs[0] is not None else 'no prologue'}"
            f"{' strided' if strided else ''}")


def graph_ms(fn, reps=20):
    """The device time of one call of `fn`, replayed from a CUDA graph: the
    host's part (Python, the launch) is left out."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    ms = cuda_ms(g.replay, reps)
    del g
    return ms


def b11_check(fk, args, label, max_errs, time_it=False):
    """B11 against its plain version on one call's inputs (x, w, pm, pi,
    ps, pb, relu): y beyond one bf16 ulp (or f32 relative), s and sq
    against Σ|y| and Σy², every output nonzero, the same bits in two runs.
    With `time_it`, returns (kernel, its device time, plain, bound, bound
    by, torch.matmul) ms."""
    x, w, *vecs, relu = args
    dt = x.dtype
    got = fk.fused_matmul_bn(x, w, *vecs, relu=relu)
    again = fk.fused_matmul_bn(x, w, *vecs, relu=relu)
    want = fk.fused_matmul_bn_plain(x, w, *vecs, relu=relu)
    torch.cuda.synchronize()
    y, s, sq = got
    check(y.dtype == dt and s.dtype == sq.dtype == torch.float32, f"B11 {label}: dtypes")
    check(all(bool(torch.isfinite(t.float()).all()) for t in got), f"B11 {label}: non-finite")
    check(amax(y) > 0 and amax(s) > 0 and amax(sq) > 0, f"B11 {label}: an output is all zero")
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    check(same, f"B11 {label}: two runs differ")
    yw = want[0].float()
    if dt == torch.bfloat16:
        ulp = torch.as_tensor(bf16_ulp(yw.cpu().numpy()), device=yw.device)
        y_read = float(((y.float() - yw).abs() > ulp).float().mean())
        y_tol, y_what = B11_BEYOND_ULP, "beyond one ulp"
    else:
        y_read, y_tol, y_what = rel_err(y, yw)[1], B11_F32_TOL, "rel err"
    yk = y.float()
    abs_sum, sq_sum = yk.abs().sum(0).clamp_min(1e-30), (yk * yk).sum(0).clamp_min(1e-30)
    s_err = float(((s - yk.sum(0)).abs() / abs_sum).max())
    sq_err = float(((sq - (yk * yk).sum(0)).abs() / sq_sum).max())
    s_plain = float(((s - want[1]).abs() / abs_sum).max())
    sq_plain = float(((sq - want[2]).abs() / sq_sum).max())
    differ = float((y != want[0]).float().mean())
    print(f"  fused_conv_bn {label} {str(dt)[6:]}: y {y_what} {y_read:.3e} (max {y_tol:g}), "
          f"{differ:.4%} differ; s {s_err:.3e}, sq {sq_err:.3e} from the sums of its y (max "
          f"{B11_STATS_TOL:g}), {s_plain:.3e}, {sq_plain:.3e} from the plain version's; "
          f"same bits in two runs")
    check(y_read <= y_tol, f"B11 {label}: y disagrees with its plain version: {y_read:.3e}")
    check(s_err <= B11_STATS_TOL and sq_err <= B11_STATS_TOL,
          f"B11 {label}: the statistics are not the sums of y: {s_err:.3e} {sq_err:.3e}")
    max_errs["fused_conv_bn"] = max(max_errs.get("fused_conv_bn", 0.0),
                                    float((y.float() - yw).abs().max()))
    if not time_it:
        return None
    cin, cout = x.shape[-1], w.shape[0]
    k_ms = cuda_ms(lambda: fk.fused_matmul_bn(x, w, *vecs, relu=relu), 10)
    d_ms = graph_ms(lambda: fk.fused_matmul_bn(x, w, *vecs, relu=relu))
    p_ms = cuda_ms(lambda: fk.fused_matmul_bn_plain(x, w, *vecs, relu=relu), 2)
    xn = x if vecs[0] is None else fk.prologue_plain(x, *vecs, relu)
    xn = xn.reshape(-1, cin).contiguous()
    lib_ms = cuda_ms(lambda: torch.matmul(xn, w.t()), 10)
    b_ms, b_by, nbytes = b11_bound(x, cin, cout)
    print(f"    kernel {k_ms * 1e3:.2f} us with the wrapper, {d_ms * 1e3:.2f} us on the device; "
          f"plain {p_ms * 1e3:.2f} us, torch.matmul on the prologued operands {lib_ms * 1e3:.2f} "
          f"us, bound {b_ms * 1e3:.2f} us by {b_by} ({nbytes:.0f} B), {100 * b_ms / k_ms:.2f}% of "
          f"the bound")
    return k_ms, d_ms, p_ms, b_ms, b_by, lib_ms


def b11_seeded(rng, B, H, W, cin, cout, prologue, relu, stride, dt):
    """Normal x (a stride-s view of a larger NHWC tensor when stride > 1),
    W / sqrt(Cin) and the prologue's vectors, on the card."""
    t = lambda *s: torch.as_tensor(rng.standard_normal(s), dtype=torch.float32).cuda()  # noqa
    x = t(B, H * stride, W * stride, cin).to(dt)[:, ::stride, ::stride, :]
    w = (t(cout, cin) / np.sqrt(cin)).to(dt)
    vecs = [0.3 * t(cin), 1 + 0.1 * t(cin).abs(), 1 + 0.1 * t(cin), 0.1 * t(cin)] \
        if prologue else [None] * 4
    return (x, w, *vecs, relu)


def resnet_small_runs(ptt, state, feeds, amp, dev):
    """Two steps of the small program on `dev` from `state`: (losses, the
    first step's P@GRAD, the state after)."""
    main, _, loss = build_resnet_program(ptt, **{k: RESNET_SMALL[k]
                                                  for k in ("hw", "class_dim", "lr")})
    main.set_amp(amp)
    sc_ = ptt.Scope()
    ptt.io.params_from_numpy(sc_, state, dev)
    grads = [p.name + "@GRAD" for p in main.parameters()]
    dexe = ptt.Executor(device=dev)
    out = dexe.run(main, feeds[0], [loss.name] + grads, scope=sc_)
    second = dexe.run(main, feeds[1], [loss.name], scope=sc_)
    return ([float(out[0]), float(second[0])], dict(zip(grads, out[1:])),
            ptt.io.state_to_numpy(sc_, list(state)))


def resnet_compare(state, cpu, card, amp):
    """Card against CPU with RESNET_PARITY's bounds; returns the worst
    readings."""
    b = RESNET_PARITY[amp]
    (cl, cg, cs), (gl, gg, gs) = cpu, card
    worst = dict(loss=0.0, grad=0.0, state=0.0, running=0.0, norm=1.0)
    for i, (a, g) in enumerate(zip(cl, gl)):
        rel = abs(a - g) / abs(a)
        worst["loss"] = max(worst["loss"], rel)
        check(np.isfinite(g) and rel <= b["loss"][i], f"losses differ: cpu {cl} card {gl}")
    null = lambda n: n.replace("@GRAD", "").endswith(RESNET_NULL)  # noqa: E731

    def hold(name, got, want, bound_key):
        if bound_key in b and not null(name):
            r = float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))
            worst[bound_key] = max(worst[bound_key], r)
            check(r <= b[bound_key], f"{name}: {r:.3e} apart (relative L2)")
        else:
            ratio = float(np.linalg.norm(got) / max(np.linalg.norm(want), 1e-30))
            worst["norm"] = max(worst["norm"], ratio, 1 / max(ratio, 1e-30))
            check(1 / 2.0 <= ratio <= 2.0, f"{name}: norm ratio {ratio:.3f}")

    for n, a in cg.items():
        hold(n, gg[n], a, "grad")
    for n, a in cs.items():
        if n.endswith(".lr"):
            check(np.array_equal(gs[n], a), f"{n} differs")
        elif n.endswith((".mean", ".variance")):
            r = float(np.linalg.norm(gs[n] - a) / max(np.linalg.norm(a), 1e-30))
            worst["running"] = max(worst["running"], r)
            check(r <= b["running"], f"{n}: running statistics {r:.3e} apart")
        elif ".velocity." in n:
            hold(n, gs[n], a, "state")
        else:
            hold(n, gs[n] - state[n], a - state[n], "state")
    return worst


def record_ops(registry, types, outputs=False):
    """Wrap the registered kernels of `types` so each call records (its
    operator, its inputs by name, detached; LoDArrays whole), and with
    `outputs` its outputs in the same dict after the call. Returns (calls,
    restore)."""
    calls, orig = {t: [] for t in types}, {}

    def detached(v):
        return v.with_data(v.data.detach()) if hasattr(v, "with_data") else v.detach()

    for t in types:
        fn = orig[t] = registry._KERNELS[t]

        def spy(ctx, _fn=fn, _t=t):
            vals = {n: detached(ctx.env[n]) for slot in ctx.op.inputs.values() for n in slot}
            calls[_t].append((ctx.op, vals))
            _fn(ctx)
            if outputs:
                vals.update({n: detached(ctx.env[n]) for slot in ctx.op.outputs.values()
                             for n in slot if n in ctx.env})

        registry._KERNELS[t] = spy
    return calls, lambda: registry._KERNELS.update(orig)


def f32_ulp(v):
    """One f32 ulp at each element's magnitude (numpy float array)."""
    return np.spacing(np.abs(v).astype(np.float32)).astype(np.float64)


def bn_op_readings(registry, op, ins):
    """One recorded bn_stats or batch_norm call run by its registered kernel
    on the card and on the CPU from the same inputs (see
    RESNET_BF16_STATS_NOTE): {output: (reading, a zero output's reading)}."""
    env = {}
    for dev in ("cuda", "cpu"):
        env[dev] = {k: v.to(dev) for k, v in ins.items()}
        registry.get_kernel(op.type)(registry.OpContext(op, env[dev]))
    torch.cuda.synchronize()
    x = ins[op.inputs["X"][0]].double()
    nhwc = op.type == "bn_stats" or op.attrs.get("data_format", "NCHW") == "NHWC"
    ch = x.dim() - 1 if nhwc else 1
    ms = (x * x).mean(tuple(i for i in range(x.dim()) if i != ch)).cpu().numpy()
    rms, keep = np.sqrt(ms), 1 - op.attrs.get("momentum", 0.9)
    eps = op.attrs.get("epsilon", 1e-5)
    out = lambda name: [env[d][op.outputs[name][0]].double().cpu().numpy()  # noqa: E731
                        for d in ("cuda", "cpu")]
    running = lambda slot: [env[d][op.inputs[slot][0]].double().cpu().numpy()  # noqa: E731
                            for d in ("cuda", "cpu")]
    rd = {}
    for slot, scale in (("Mean", rms), ("Variance", ms)):
        g, w = running(slot)
        rd["running " + slot.lower()] = (
            float((np.maximum(np.abs(g - w) - f32_ulp(w), 0) / (keep * scale)).max()),
            float((np.abs(w) / (keep * scale)).max()))
    if op.type == "bn_stats":
        g, w = out("BatchMean")
        rd["BatchMean"] = float((np.abs(g - w) / rms).max()), float((np.abs(w) / rms).max())
        g, w = (1 / v ** 2 - eps for v in out("BatchInv"))  # the batch variance
        rd["BatchInv"] = float((np.abs(g - w) / ms).max()), float((np.abs(w) / ms).max())
    else:
        g, w = (env[d][op.outputs["Y"][0]] for d in ("cuda", "cpu"))
        scale = amax(w)
        rd["Y"] = beyond_ulp(g, w, scale), beyond_ulp(torch.zeros_like(w), w, scale)
    return rd


def bn_stats_gate(ptt, recorded):
    """The full-width step's own bn_stats and batch_norm calls, card against
    CPU with bn_bf16_stats on (RESNET_BF16_STATS_NOTE): prints each
    output's worst reading and the least a zero output would read."""
    from paddle_tpu_torch.core import registry

    check(ptt.FLAGS.bn_bf16_stats, "bn_bf16_stats is off; the gate holds the default")
    for t, calls in recorded.items():
        worst = {}
        for op, ins in calls:
            for name, (r, z) in bn_op_readings(registry, op, ins).items():
                w = worst.setdefault(name, [0.0, float("inf")])
                w[0], w[1] = max(w[0], r), min(w[1], z)
        print(f"  {t} x{len(calls)} (bn_bf16_stats on), card against CPU: " + "; ".join(
            f"{k} {r:.3e} (zeros would read {z:.3e})" for k, (r, z) in worst.items())
            + f" (tol {BN_STATS_TOL:g})")
        for k, (r, z) in worst.items():
            check(r <= BN_STATS_TOL, f"{t}: {k} {r:.3e} apart on the card and the CPU")
            check(z > BN_STATS_TOL, f"{t}: a {k} left at zero would pass its check")


def resnet_phases(ptt, exe, rng, smi, seed, first_phase, summary):
    """Phases first_phase.. of the ResNet slice; returns the kernels' rows,
    their largest errors and their launches on the training path, and puts
    the timed steps' median ms in summary["step_ms"]."""
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.ops import fused_conv_kernels as fk

    n = first_phase
    phase(n, "ResNet-50 at full width (bf16), built by the port's front end, B11 route: "
          "startup and a warm-up step")
    flags = _Flags(ptt.FLAGS, fused_conv_dot_max_n=RESNET_DOT_MAX_N, fused_conv_pallas=True)
    flags.__enter__()  # left in phase 20, before the default route's steps
    main_p, startup, loss = build_resnet_program(ptt, **{k: RESNET_BENCH[k]
                                                        for k in ("hw", "class_dim", "lr")})
    ops = [o.type for o in main_p.global_block().ops]
    counts = {t: ops.count(t) for t in sorted(set(ops))}
    print(f"  main program: {len(ops)} ops {counts}; startup: "
          f"{len(startup.global_block().ops)} ops")
    fused = ops.count("fused_conv_bn")
    scope = ptt.Scope()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    exe.run(startup, scope=scope, seed=seed)
    torch.cuda.synchronize()
    n_values = sum(scope.get(p.name).numel() for p in main_p.parameters())
    print(f"  startup: {len(main_p.parameters())} parameters with {n_values} values, "
          f"{time.perf_counter() - t0:.2f} s")
    batch = RESNET_BENCH["batch"]
    feed = resnet_feed(np.random.RandomState(0), RESNET_BENCH["hw"], RESNET_BENCH["class_dim"],
                       batch)
    calls, restore = record_calls(fk, {"fused_matmul_bn": "all"})
    bn_calls, bn_restore = record_ops(registry, ("bn_stats", "batch_norm"))
    try:
        t0 = time.perf_counter()
        losses = [float(exe.run(main_p, feed, [loss.name], scope=scope)[0])]
        torch.cuda.synchronize()
    finally:
        restore()
        bn_restore()
    for t, c in bn_calls.items():
        check(len(c) == counts[t], f"the warm-up step ran {len(c)} {t} calls, not {counts[t]}")
    recorded = calls.get("fused_matmul_bn", [])
    print(f"  warm-up step: loss {losses[0]:.6f}, {time.perf_counter() - t0:.3f} s; {batch} "
          f"images; {len(recorded)} fused_matmul_bn calls recorded; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(len(recorded) == fused, f"the warm-up step ran {len(recorded)} B11 calls, "
          f"not the program's {fused}")

    n += 1
    phase(n, "B11 against plain (the warm-up step's inputs at each shape, then seeded inputs)")
    rows, max_errs = {}, {}
    by_shape = {}  # a label: (the call's inputs, calls a step)
    for a, _ in recorded:  # (x, w, pm, pi, ps, pb, relu), as _FusedConvBNFn passes them
        by_shape.setdefault(b11_label(a[0], a[1], a[2:6], a[6]), [a, 0])[1] += 1
    totals = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    bound_by = {"bytes": 0.0, "operations": 0.0}
    for key, (args, mult) in by_shape.items():
        k_ms, d_ms, p_ms, b_ms, b_by, lib_ms = b11_check(fk, args, f"{key} (x{mult} a step)",
                                                         max_errs, time_it=True)
        for name, v in zip(("ms", "device_ms", "plain_ms", "bound_ms", "library_ms"),
                           (k_ms, d_ms, p_ms, b_ms, lib_ms)):
            totals[name] += mult * v
        bound_by[b_by] += mult * b_ms
    print(f"  a step's {fused} calls at {len(by_shape)} shapes: kernel {totals['ms']:.4f} ms with "
          f"the wrapper ({EARLIER_MS['fused_conv_bn']} ms before the redesign), "
          f"{totals['device_ms']:.4f} ms on the device; plain {totals['plain_ms']:.4f} ms, "
          f"torch.matmul {totals['library_ms']:.4f} ms, bound {totals['bound_ms']:.4f} ms "
          f"({bound_by['bytes']:.4f} by bytes, {bound_by['operations']:.4f} by operations; the "
          f"kernels at {100 * totals['bound_ms'] / totals['ms']:.2f}% of the bound)")
    rows["fused_conv_bn"] = dict(totals, bound_by=max(bound_by, key=bound_by.get))
    # f32 on a subset of the step's own inputs: the first call, and the last
    for a, _ in (recorded[0], recorded[-1]):
        b11_check(fk, (a[0].float(), a[1].float(), *a[2:]),
                  b11_label(a[0], a[1], a[2:6], a[6]) + " (the step's input in f32)", max_errs)
    srng = np.random.RandomState(seed + 11)
    for B_, H_, W_, ci, co, pro, relu, stride in B11_EDGE:
        for dt in (torch.bfloat16, torch.float32):
            args = b11_seeded(srng, B_, H_, W_, ci, co, pro, relu, stride, dt)
            b11_check(fk, args, b11_label(args[0], args[1], args[2:6], relu) + " (seeded)",
                      max_errs)
    del recorded, calls, by_shape

    n += 1
    phase(n, "ResNet-50 training at full width (bf16, B11 route): 3 timed steps")
    torch.cuda.reset_peak_memory_stats()
    fk.fused_conv_bn_launches = 0
    fk.fused_conv_bn_input_copies = 0
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        losses.append(float(exe.run(main_p, feed, [loss.name], scope=scope)[0]))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = {"fused_conv_bn": fk.fused_conv_bn_launches}
    print(f"  losses (warm-up, then timed): {losses}")
    check(all(np.isfinite(losses)), "non-finite loss")
    check(losses[-1] < losses[0], "the loss did not fall over 4 steps on one batch")
    print(f"  launches in 3 steps: {launches}, input copies {fk.fused_conv_bn_input_copies}; "
          f"per step expected {fused} (the statistics summed in the same launch)")
    for k, c in launches.items():
        check(c == 3 * fused, f"{k} launched {c} times in 3 steps, not {3 * fused}")
    check(fk.fused_conv_bn_input_copies == 0, "B11 copied an input on the main path")
    med = statistics.median(times)
    summary["step_ms"] = med
    flops = RESNET_FLOP_PER_IMAGE * batch
    print(f"  steps ms: {[round(t, 3) for t in times]}; median {med:.3f} ms/step, "
          f"{batch / med * 1e3:.1f} images/s (B={batch}, 224x224); "
          f"{100 * flops / (med / 1e3) / PEAK_FLOPS[torch.bfloat16]:.2f}% of the bf16 peak for "
          f"bench.py's {flops / 1e12:.3f} TFLOP a step; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {smi}")
    breakdown(lambda: exe.run(main_p, feed, [loss.name], scope=scope), med, "step",
              kinds=RESNET_KERNEL_KINDS)
    flags.__exit__()
    with _Flags(ptt.FLAGS, fused_conv_dot_max_n=0, fused_conv_pallas=False):
        before = fk.fused_conv_bn_launches
        exe.run(main_p, feed, [loss.name], scope=scope)  # warm-up of the other route
        torch.cuda.synchronize()
        alt = []
        for _ in range(3):
            t0 = time.perf_counter()
            exe.run(main_p, feed, [loss.name], scope=scope)
            torch.cuda.synchronize()
            alt.append((time.perf_counter() - t0) * 1e3)
        check(fk.fused_conv_bn_launches == before, "the cuDNN route launched B11")
    print(f"  context, not a gate: the same step on the default route (fused_conv_pallas off, "
          f"fused_conv_dot_max_n 0: each 1x1 conv a cuDNN conv): steps ms "
          f"{[round(t, 3) for t in alt]}, median {statistics.median(alt):.3f} ms/step, "
          f"{batch / statistics.median(alt) * 1e3:.1f} images/s")
    del scope

    n += 1
    phase(n, "the step's bn_stats and batch_norm calls, then the small ResNet-50 program "
          "(64x64, B=4): card against CPU (f32, then bf16)")
    bn_stats_gate(ptt, bn_calls)
    del bn_calls
    with _Flags(ptt.FLAGS, fused_conv_dot_max_n=10 ** 9, fused_conv_pallas=True):
        smain, sstart, _ = build_resnet_program(ptt, **{k: RESNET_SMALL[k]
                                                        for k in ("hw", "class_dim", "lr")})
        sc_ = ptt.Scope()
        ptt.Executor(device="cpu").run(sstart, scope=sc_, seed=seed + 12)
        state = ptt.io.state_to_numpy(sc_, [v.name for v in smain.persistables()])
        frng = np.random.RandomState(seed + 13)
        sfeeds = [resnet_feed(frng, RESNET_SMALL["hw"], RESNET_SMALL["class_dim"],
                              RESNET_SMALL["batch"]) for _ in range(2)]
        for amp in (None, "bfloat16"):
            before = fk.fused_conv_bn_launches
            # the statistics squared in f32; the default is held op by op
            # above (see RESNET_BF16_STATS_NOTE)
            with _Flags(ptt.FLAGS, bn_bf16_stats=False):
                cpu = resnet_small_runs(ptt, state, sfeeds, amp, "cpu")
                card = resnet_small_runs(ptt, state, sfeeds, amp, "cuda")
            check(fk.fused_conv_bn_launches - before == 2 * fused,
                  f"the small program's card run launched B11 "
                  f"{fk.fused_conv_bn_launches - before} times, not {2 * fused}")
            worst = resnet_compare(state, cpu, card, amp)
            b = RESNET_PARITY[amp]
            print(f"  {amp or 'f32'}: losses cpu {cpu[0]} card {card[0]}, worst rel "
                  f"{worst['loss']:.3e} (max {b['loss']}); " +
                  (f"gradients {worst['grad']:.3e} (max {b['grad']}), velocities and updates "
                   f"{worst['state']:.3e} (max {b['state']}) relative L2; " if amp is None else "")
                  + f"running statistics {worst['running']:.3e} (max {b['running']}); norms "
                  f"within a factor {worst['norm']:.3f} (max 2)")
        # context, not a gate: bf16 with the default bn_bf16_stats, and its
        # CPU run again with the first feed's images moved by 1e-3
        moved = [dict(sfeeds[0], img=(sfeeds[0]["img"] * (1 + 1e-3 * frng.standard_normal(
            sfeeds[0]["img"].shape))).astype(np.float32)), sfeeds[1]]
        dflt = [resnet_small_runs(ptt, state, f, "bfloat16", d)[0]
                for f, d in ((sfeeds, "cpu"), (sfeeds, "cuda"), (moved, "cpu"))]
        print(f"  context, not a gate: bf16 with bn_bf16_stats on (the default): losses cpu "
              f"{dflt[0]} card {dflt[1]}; cpu with the images moved by 1e-3: {dflt[2]}")
    return rows, max_errs, launches


# ------------------------------------------ NMT, the whole-sequence decoder --
# bench.py's nmt entry (_build_nmt_train, bench.py:320-375) at BENCH_BATCH=256,
# built by the port's own front end: V=30000, emb = enc = dec hidden = 512,
# S = T = 50, Adam(5e-4), bf16 amp; the decoder in the configuration the JAX
# package exposes for B9 and B10 (fused_attention_seq_fwd/_bwd on)
NMT_BENCH = dict(vocab=30000, emb=512, enc_hidden=512, dec_hidden=512, max_len=50, batch=256)
NMT_SMALL = dict(vocab=64, emb=32, enc_hidden=128, dec_hidden=128, max_len=6, batch=8)
NMT_VALUES = 53_455_664
SEQ_FLAGS = dict(fused_attention_seq_fwd=True, fused_attention_seq_bwd=True)
SEQ_STEP_LAUNCHES = {"decoder_seq_fwd": 1, "decoder_seq_bwd": 1, "decoder_seq_dep": 1,
                     "attn_fwd": 0,
                     "attn_bwd_step": 0, "attn_phase2": 0, "gru_fwd": 2, "gru_bwd": 2}
# B9 and B10 against their plain versions, each output's error over its
# scale (seq_scales). f32: within 1e-5 (the same f32 arithmetic summed in
# other orders; tests/test_torch_seq2seq.py holds the plain versions to
# the JAX kernels) of its largest element, or for ddp (over S) and dep
# (over T) of the largest sum of their terms' magnitudes, to which an f32
# sum's error in another order grows: on the warm-up step's inputs ddp
# cancels to 7e-5 of it (a softmax gradient sums to 0, and at the
# startup's weights tanh(ep+dp) is nearly the same at every s). bf16: the
# kernel and cuBLAS sum in other orders, so an output may round one ulp
# apart, and the flip travels through h, or through the dh carry, to the
# later steps and spreads, as gru_bwd's does: at most 10% of h_seq, ctx,
# dxp, dctx and dh0 lies more than one ulp from the plain value, and
# alpha, ddp, dep and dv (f32 outputs and sums) lie beyond one ulp by at
# most 1e-2 (gru_bwd's bf16 bound) of their own largest element. dv, f32
# and summed in f32 on both sides, is held to its own largest element in
# both dtypes: its terms over every step, row and position cancel, so the
# sum of their magnitudes is up to 2e4 times dv. A check must be able to
# fail: every output left at zero must read above its bound (printed
# beside it), and a version with its roundings elsewhere must break the
# share bound at the main path's shapes (seq_control, printed beside it).
SEQ_TOL = 1e-5
SEQ_BF16_TOL = 1e-2
SEQ_BEYOND_ULP = 0.10
SEQ_CANCELS = ("ddp", "dep", "dv")
SEQ_FWD_OUT = ("h_seq", "alpha", "ctx")
SEQ_BWD_OUT = ("dxp", "dctx", "ddp", "dh0", "dep", "dv")
# (B, S, T, E, C, A, H) beyond the main path's: on a 132-SM card 1, 4 and 8
# hidden units a CTA, a partly empty last CTA, slices of A and C that do not
# divide, S past one warp, fewer batch rows than CTAs
SEQ_EDGE = [(5, 7, 4, 16, 130, 100, 100), (3, 45, 5, 24, 520, 300, 301),
            (4, 9, 3, 16, 130, 128, 700),
            # the bf16 backward's batch groups of 32-row sub-tiles at H=512:
            # two whole sub-tiles, then a third of one row; and T=1
            (64, 20, 6, 32, 1024, 512, 512), (65, 20, 6, 32, 1024, 512, 512),
            (8, 10, 1, 16, 256, 128, 128),
            # long source and target: the post-walk pass's tiles of S and T
            # (T = S = 256 staged whole would pass shared memory's 227 KB)
            (4, 256, 256, 16, 130, 128, 100)]


def build_nmt_program(ptt, vocab, emb, enc_hidden, dec_hidden, max_len, batch=None):
    """bench.py's _build_nmt_train through the port's front end, names
    counted from 0. Returns (main, startup, loss)."""
    ptt.reset_default_programs()
    prog, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(prog, startup):
        src, trg_in, label = (ptt.layers.data(n, shape=[-1], dtype=np.int32, lod_level=1,
                                              append_batch_size=False)
                              for n in ("src", "trg_in", "label"))
        logits = ptt.models.seq2seq_attention(
            src, trg_in, src_vocab=vocab, trg_vocab=vocab, emb_dim=emb, enc_hidden=enc_hidden,
            dec_hidden=dec_hidden, src_max_len=max_len, trg_max_len=max_len)
        tok_loss = ptt.layers.softmax_with_cross_entropy(logits, label)
        loss = ptt.layers.mean(ptt.layers.sequence_pool(tok_loss, "sum"))
        ptt.optimizer.Adam(learning_rate=5e-4).minimize(loss)
    return prog, startup, loss


def nmt_bench_feed(ptt, vocab, seqlen, batch):
    """bench.py's feed: RandomState(0) source and target sentences of
    `seqlen` tokens; trg_in and label are the same sequences."""
    rng = np.random.RandomState(0)
    pack = lambda seqs: ptt.LoDArray.from_sequences(  # noqa: E731
        seqs, capacity=batch * seqlen, max_seqs=batch)
    srcs = [rng.randint(2, vocab, (seqlen,)).astype(np.int32) for _ in range(batch)]
    trgs = [rng.randint(2, vocab, (seqlen,)).astype(np.int32) for _ in range(batch)]
    return {"src": pack(srcs), "trg_in": pack(trgs), "label": pack(trgs)}


def seq_bound(name, args):
    """Least time for one call. Bytes: each input once (a source tensor over
    the valid source positions, a [T,B,.] input over the valid target
    steps, the weights whole) and each output once; operations: the
    products and the attention for each valid target step, over the bf16
    tensor-core peak (the cheapest the card computes them)."""
    ep, enc, mask = args[:3]
    B, S, A = ep.shape
    C, item = enc.shape[2], ep.element_size()
    src = float((mask > 0).sum())
    tmask = args[4]
    T, steps = tmask.shape[0], float((tmask > 0).sum())
    if name == "decoder_seq_fwd":
        H = args[5].shape[1]
        ins = src * (A + C) + steps * 3 * H + B * H + H * A + A + C * 3 * H + 3 * H * H
        nbytes = (ins + T * B * (H + C)) * item + (B * S + T * B + T * B * S) * 4
        ops = steps * (2 * H * A + 2 * C * 3 * H + 2 * H * 2 * H + 2 * H * H
                       + src / B * (3 * A + 2 * C))
    else:
        H = args[5].shape[2]
        ins = src * (A + C) + steps * (5 * H + A) + A + 3 * H * H + C * 3 * H + H * A
        outs = T * B * (3 * H + C + A) + B * H + B * S * A
        nbytes = (ins + outs) * item + (B * S + T * B + T * B * S + A) * 4
        ops = steps * (2 * H * H + 2 * H * 2 * H + 2 * 3 * H * C + 2 * A * H
                       + src / B * (2 * C + 6 * A))
    return (*bound_ms(nbytes, ops, PEAK_FLOPS[torch.bfloat16]), nbytes)


def seq_dep_bound(ep, dp_seq, dsc):
    """Least time for the post-walk pass: ep, dp_seq, dsc and v read once,
    dep and dv written once; per (t, b, s, a) term with a nonzero dsc, nine
    f32 operations (tanh as one) at the f32 peak off the tensor cores."""
    T, B, A = dp_seq.shape
    S = ep.shape[1]
    nbytes = (2 * B * S * A + T * B * A + A) * ep.element_size() + (T * B * S + A) * 4
    ops = 9.0 * float((dsc != 0).sum()) * A
    return (*bound_ms(nbytes, ops, PEAK_FLOPS[torch.float32]), nbytes)


def seq_seeded(rng, B, S, T, E, C, A, H, dt):
    """Seeded inputs of both kernels: ragged source and target masks, one
    row (when B > 3) whose target steps are all masked; the backward's from
    the plain forward and the batched recompute. Returns (forward args,
    backward args)."""
    from paddle_tpu_torch.ops import attention_kernels as ak

    f = lambda *s, sc=1.0: torch.as_tensor(sc * rng.standard_normal(s), dtype=dt).cuda()  # noqa
    lens, tlens = rng.randint(1, S + 1, size=B), rng.randint(1, T + 1, size=B)
    lens[0], tlens[0] = S, T
    if B > 3:
        tlens[3] = 0
    mask = torch.as_tensor(np.arange(S)[None] < lens[:, None], dtype=torch.float32).cuda()
    tmask = torch.as_tensor(np.arange(T)[:, None] < tlens[None], dtype=torch.float32).cuda()
    ep, enc, trg, h0 = f(B, S, A), f(B, S, C, sc=0.5), f(T, B, E, sc=0.5), f(B, H, sc=0.5)
    wa, v, wh = f(H, A, sc=H ** -0.5), f(A, sc=A ** -0.5), f(H, 3 * H, sc=H ** -0.5)
    wx, bias = f(E + C, 3 * H, sc=(E + C) ** -0.5), f(3 * H, sc=0.1)
    fwd = (ep, enc, mask, torch.matmul(trg, wx[:E]) + bias, tmask, h0, wa, v, wx[E:],
           wh[:, : 2 * H], wh[:, 2 * H:])
    h_seq, alpha, ctx = ak.decoder_seq_fwd_plain(*fwd)
    hp, dp, _, u, r, _, c = ak.decoder_bwd_inputs(trg, h0, wa, wx, wh, bias, h_seq, ctx)
    bwd = (ep, enc, mask, f(T, B, H, sc=0.1), tmask, hp, u, r, c, dp, alpha, v, wh[:, 2 * H:],
           wh[:, : 2 * H], wx[E:], wa)
    return fwd, bwd


def seq_scales(name, args, want):
    """The scale each output's error is held to (see SEQ_TOL's note): its
    largest element, or in f32 for ddp and dep the largest sum of their
    terms' magnitudes, from the plain version's dctx (|1 - t²| <= 1).
    Returns (scales, {sum: the sum of its terms' magnitudes over its
    largest element}) for ddp, dep and dv, which the backward prints."""
    scales = [max(amax(w), 1e-30) for w in want]
    if name != "decoder_seq_bwd":
        return scales, {}
    enc, mask, alpha, v = args[1], args[2], args[10], args[11]
    dal = torch.einsum("bsc,tbc->tbs", enc.float(), want[1].float())
    dsc = (alpha * (dal - (alpha * dal).sum(-1, keepdim=True)) * (mask > 0)).abs()
    vmax = amax(v)
    terms = {2: amax(dsc.sum(2)) * vmax, 4: amax(dsc.sum(0)) * vmax, 5: float(dsc.sum())}
    if args[0].dtype == torch.float32:
        scales[2], scales[4] = terms[2], terms[4]
    return scales, {SEQ_BWD_OUT[i]: t / max(amax(want[i]), 1e-30) for i, t in terms.items()}


def seq_reading(g, w, scale, dt, n):
    """(reading, bound, what it reads) of one output under SEQ_*'s bounds."""
    over = beyond_ulp(g, w, scale)  # the error itself for an f32 output
    if dt == torch.float32:
        return over, SEQ_TOL, ""
    if w.dtype == torch.float32 or n in SEQ_CANCELS:
        return over, SEQ_BF16_TOL, " beyond 1 ulp"
    gn, wn = g.float().cpu().numpy(), w.float().cpu().numpy()
    return float((np.abs(gn - wn) > bf16_ulp(wn)).mean()), SEQ_BEYOND_ULP, " beyond 1 ulp"


def seq_check(ak, name, args, label, max_errs, fn=None):
    """Kernel (`fn`, by default the wrapper `name`) against plain on `args`
    with SEQ_*'s bounds (errors over seq_scales); prints every output's
    reading and what it would read left at zero, then fails on the first
    out of bounds. Returns (got, want)."""
    got = (fn or getattr(ak, name))(*args)
    want = getattr(ak, name + "_plain")(*args)
    torch.cuda.synchronize()
    dt = args[0].dtype
    names = SEQ_FWD_OUT if name == "decoder_seq_fwd" else SEQ_BWD_OUT
    parts, faults = [], []
    scales, terms = seq_scales(name, args, want)
    for n, g, w, scale in zip(names, got, want, scales):
        check(bool(torch.isfinite(g.float()).all()), f"{name}: non-finite {n}")
        check(g.shape == w.shape and g.dtype == w.dtype, f"{name}: {n} {g.shape} {g.dtype}")
        err = float((g.float() - w.float()).abs().max())
        max_errs[name] = max(max_errs.get(name, 0.0), err)
        over, tol, what = seq_reading(g, w, scale, dt, n)
        zero = seq_reading(torch.zeros_like(w), w, scale, dt, n)[0]
        fmt = ".3%" if tol == SEQ_BEYOND_ULP else ".2e"
        parts.append(f"{n} {over:{fmt}}{what} (zeros {zero:{fmt}})")
        if over > tol:
            faults.append(f"{n} {over:.3e} (tol {tol:g})")
        if zero <= tol:
            faults.append(f"{n} left at zero would read {zero:.3e} (tol {tol:g})")
    if terms:
        parts.append("their terms' magnitudes sum to " + ", ".join(
            f"{t:.3g}x {n}'s largest" for n, t in terms.items()))
    print(f"  {name} {label} {str(dt)[6:]}: " + "; ".join(parts))
    check(not faults, f"{name} {label} disagrees with its plain version, or its check "
          f"cannot fail: {', '.join(faults)}")
    return got, want


def seq_control(ak, name, args, got):
    """The share of the first output beyond one ulp of the kernel's for a
    version with its roundings elsewhere, which the main-shape bound must
    catch: the forward in f32 rounded only at its outputs; the backward of
    the per-step route, which carries dh in the io dtype (B10 carries it in
    f32)."""
    if name == "decoder_seq_fwd":
        other = ak.decoder_seq_fwd_plain(*(t.float() for t in args))[0].to(got[0].dtype)
        what = "in f32, rounded only at the output"
    else:
        other = ak._decoder_bwd_steps(*args)[0]
        what = "the per-step route's backward, dh carried in bf16"
    w, g = other.float().cpu().numpy(), got[0].float().cpu().numpy()
    off = float((np.abs(g - w) > bf16_ulp(w)).mean())
    out = (SEQ_FWD_OUT if name == "decoder_seq_fwd" else SEQ_BWD_OUT)[0]
    print(f"    {what}: {off:.3%} of {out} beyond one ulp (the bound "
          f"{SEQ_BEYOND_ULP:.0%} must catch it)")
    check(off > SEQ_BEYOND_ULP, f"{name}: the bf16 bound does not catch a misplaced rounding")


def seq_fwd_first(ak, args):
    """decoder_seq_fwd's first-design kernel on `args`, whichever route
    seq_fwd_route names (it sends f32 there, and bf16 shapes the
    tensor-core plan cannot place): in bf16 the kernel before the
    redesign, held and timed beside it. Not counted."""
    ep, enc, xpx, h0 = args[0], args[1], args[3], args[5]
    (B, S, A), C, T, H = ep.shape, enc.shape[2], xpx.shape[0], h0.shape[1]
    new = lambda *shape, dtype=ep.dtype: torch.empty(*shape, dtype=dtype,  # noqa: E731
                                                     device=ep.device)
    outs = [new(T, B, H), new(T, B, S, dtype=torch.float32), new(T, B, C),
            new(B, A, dtype=torch.float32), new(B, H)]
    ak._seq_launch("decoder_seq_fwd", "decoder_seq_fwd_launch", [t.contiguous() for t in args],
                   outs, (T, B, S, A, C, H), ep.dtype, lead=(int(ep.dtype == torch.bfloat16),))
    return tuple(outs[:3])


def seq_fwd_report(ak, ins, row):
    """The bf16 forward at the warm-up step's inputs: its route and plan, the
    same bits in two runs, its four phases by the timed instance
    (attention_kernels.decoder_seq_fwd_phase_us), and the first design held
    to plain and timed beside it; adds the first design's time and the
    phase split to the kernel's row."""
    ep, enc, h0 = ins[0], ins[1], ins[5]
    (B, S, A), C, H = ep.shape, enc.shape[2], h0.shape[1]
    route = ak.seq_fwd_route(B, S, A, C, H, ep.dtype)
    check(route == ak.SEQ_TC, f"the main shape's forward is on the {route} route")
    print(f"  decoder_seq_fwd (bf16): route {route}, the card's plan "
          f"{ak.decoder_seq_fwd_plan(B, S, A, C, H)}, row path {ak.row_path(A, C)}")
    first = ak.decoder_seq_fwd(*ins)
    same_bits(ak.decoder_seq_fwd(*ins), first, "decoder_seq_fwd")
    split = ak.decoder_seq_fwd_phase_us(*ins)
    T = ins[3].shape[0]
    total = sum(split["us"].values())
    print(f"  decoder_seq_fwd: the same bits in two runs; by its timed instance (SM clock "
          f"{split['ghz']:.3f} GHz), µs a time step: "
          + ", ".join(f"({i}) {n} {us:.2f}" for i, (n, us) in enumerate(split["us"].items(), 1))
          + f"; {total:.2f} in all, {total * T / 1e3:.4f} ms over T={T}")
    seq_check(ak, "decoder_seq_fwd", ins, "(the warm-up step's inputs, the first design)", {},
              fn=lambda *a: seq_fwd_first(ak, a))
    f_ms = cuda_ms(lambda: seq_fwd_first(ak, ins), 3)
    print(f"    the first design (decoder_seq_fwd_kernel, {EARLIER_MS['decoder_seq_fwd']} ms in an "
          f"earlier run) {f_ms:.4f} ms on the same inputs, the redesign {row['ms']:.4f} ms "
          f"({f_ms / row['ms']:.2f}x)")
    row.update(earlier_ms=f_ms, phase_us=split["us"])


def nmt_card_vs_cpu(ptt, smain, loss_name, param_names, state, sfeeds, label=""):
    """The small training program from one state on the CPU and the card:
    both losses and the state after 2 Adam steps (TRAIN_PARITY), f32 then
    bf16 amp."""
    gnames = [p + "@GRAD" for p in param_names]
    for amp in (None, "bfloat16"):
        smain.set_amp(amp)
        res = {}
        for dev in ("cpu", "cuda"):
            sc_ = ptt.Scope()
            ptt.io.params_from_numpy(sc_, state, dev)
            dexe = ptt.Executor(device=dev)
            out = dexe.run(smain, sfeeds[0], [loss_name] + gnames, scope=sc_)
            ls = [float(out[0]), float(dexe.run(smain, sfeeds[1], [loss_name], scope=sc_)[0])]
            res[dev] = (ls, ptt.io.state_to_numpy(sc_, list(state)), dict(zip(gnames, out[1:])))
        (cl, cs, cg), (gl, gs, _) = res["cpu"], res["cuda"]
        lerr = max(abs(a - b) / abs(a) for a, b in zip(cl, gl))
        worst = compare_state(gs, cs, amp, cg)
        b = TRAIN_PARITY[amp]
        held = ("every value" if "far" in b else
                f"the values whose gradient exceeds {b['robust_grad']:.0%} of the largest")
        print(f"  {label}{amp or 'f32'}: losses cpu {cl} card {gl}, rel {lerr:.3e} (tol "
              f"{b['loss']:g}); after 2 steps {worst['param_share']:.3%} of parameter values "
              f"beyond {b['close']} lr (max {b['share']:.1%}); of {held}, the largest "
              f"{worst['param_far']:.3f} lr apart (max {b.get('far', b.get('robust'))}); "
              f"moments {worst['moment']:.3e} (tol {b['moment']:g}), "
              f"{worst['moment_share']:.3%} beyond 1% (max {b['moment_share']:.0%})")
        check(lerr <= b["loss"], "card and CPU losses differ")
    smain.set_amp(None)


def timed_steps(exe, main_p, feed, loss_name, scope, counters, tokens, smi, what, tally=None):
    """3 timed steps with the launch counts set to 0 just before: returns
    (losses, launches, median ms), launches["routes"] the 3 steps' counts
    in the dict `tally` (a wrapper's launches by route) where given; prints
    ms, tokens/s, peak memory and the profiled step's busy share."""
    torch.cuda.reset_peak_memory_stats()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    tally0 = dict(tally or {})
    times, losses = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        losses.append(float(exe.run(main_p, feed, [loss_name], scope=scope)[0]))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
    if tally is not None:
        launches["routes"] = {k: n - tally0[k] for k, n in tally.items()}
    med = statistics.median(times)
    print(f"  {what}: steps ms {[round(t, 3) for t in times]}; median {med:.3f} ms/step, "
          f"{tokens / med * 1e3:.1f} target tokens/s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {smi}; launches {launches}")
    breakdown(lambda: exe.run(main_p, feed, [loss_name], scope=scope), med, "step")
    return losses, launches, med


def nmt_seq_phases(ptt, exe, rng, smi, seed, first_phase):
    """Phases first_phase.. of the NMT slice on the whole-sequence decoder;
    returns the kernels' rows, their largest errors and their launches a
    step on the path."""
    from paddle_tpu_torch.ops import attention_kernels as ak
    from paddle_tpu_torch.ops import rnn_kernels

    n = first_phase
    phase(n, "NMT training program at full width (bf16), built by the port's front end, "
          "whole-sequence decoder: startup and a warm-up step")
    main_p, startup, loss = build_nmt_program(ptt, **NMT_BENCH)
    adir = os.path.join(ROOT, "paddle_tpu_torch", "artifacts", "nmt_train_wmt")
    for fname, prog in (("main.json", main_p), ("startup.json", startup)):
        with open(os.path.join(adir, fname)) as f:
            check(json.loads(json.dumps(prog.to_dict())) == json.load(f),
                  f"the port's build differs from artifacts/nmt_train_wmt/{fname}")
    print(f"  main and startup equal artifacts/nmt_train_wmt/ ({len(main_p.global_block().ops)} "
          f"and {len(startup.global_block().ops)} ops)")
    main_p.set_amp("bfloat16")
    scope = ptt.Scope()
    exe.run(startup, scope=scope, seed=seed)
    n_values = sum(scope.get(p.name).numel() for p in main_p.parameters())
    print(f"  startup: {len(main_p.parameters())} parameters with {n_values} values")
    check(n_values == NMT_VALUES, f"{n_values} parameter values, not {NMT_VALUES}")
    feed = nmt_bench_feed(ptt, NMT_BENCH["vocab"], NMT_BENCH["max_len"], NMT_BENCH["batch"])
    tokens = int(feed["label"].lengths.sum())
    flags = _Flags(ptt.FLAGS, **SEQ_FLAGS)
    flags.__enter__()
    try:
        calls, restore = record_calls(ak, {"decoder_seq_fwd": "first", "decoder_seq_bwd": "first"})
        try:
            t0 = time.perf_counter()
            losses = [float(exe.run(main_p, feed, [loss.name], scope=scope)[0])]
            torch.cuda.synchronize()
        finally:
            restore()
        print(f"  warm-up step: loss {losses[0]:.6f}, {time.perf_counter() - t0:.3f} s; "
              f"{tokens} target tokens (bench.py's RandomState(0) feed, B="
              f"{NMT_BENCH['batch']}, all {NMT_BENCH['max_len']} tokens)")
        check(set(calls) == {"decoder_seq_fwd", "decoder_seq_bwd"},
              f"the warm-up step ran {sorted(calls)}")

        n += 1
        phase(n, "B9 and B10 against plain (the warm-up step's inputs, then seeded inputs)")
        rows, max_errs = {}, {}
        for name in ("decoder_seq_fwd", "decoder_seq_bwd"):
            args = calls[name][0][0]
            for dt in (torch.bfloat16, torch.float32):
                ins = tuple(t.to(dt) if t.dtype == torch.bfloat16 else t for t in args)
                got, _ = seq_check(ak, name, ins, "(the warm-up step's inputs)", max_errs)
                if dt == torch.bfloat16:
                    k_ms = cuda_ms(lambda: getattr(ak, name)(*ins), 5)
                    p_ms = cuda_ms(lambda: getattr(ak, name + "_plain")(*ins), 1)
                    b_ms, b_by, nbytes = seq_bound(name, ins)
                    print(f"    kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.5f} ms by "
                          f"{b_by} ({nbytes:.0f} B); library: none (no one PyTorch call "
                          f"computes the decoder's recurrence)")
                    rows[name] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                                      library_ms=None)
                    if name == "decoder_seq_fwd":
                        seq_fwd_report(ak, ins, rows[name])
        args = calls["decoder_seq_bwd"][0][0]
        ep_, enc_, mask_, alpha_ = args[0], args[1], args[2], args[10]
        plan = ak.decoder_seq_bwd_plan(ep_.shape[0], ep_.shape[1], ep_.shape[2], enc_.shape[2],
                                       args[5].shape[2])
        print(f"  decoder_seq_bwd (bf16) {rows['decoder_seq_bwd']['ms']:.4f} ms, "
              f"{EARLIER_MS['decoder_seq_bwd']} ms before the redesign; the card's plan {plan}")
        first, again = ak.decoder_seq_bwd(*args), ak.decoder_seq_bwd(*args)
        check(all(torch.equal(a, b) for a, b in zip(first, again)),
              "decoder_seq_bwd gives other bits in a second run")
        print("  decoder_seq_bwd: the same bits in two runs (dep and dv included)")
        # the post-walk pass against its plain version, on the dsc of the
        # kernel's own walk (from its dctx, as the walk computes it)
        dal = torch.einsum("bsc,tbc->tbs", enc_.float(), first[1].float())
        dsc = alpha_ * (dal - (alpha_ * dal).sum(-1, keepdim=True)) * (mask_ > 0)
        dep_args = (ep_, args[9], dsc.contiguous(), args[11])
        dgot, dwant = ak.decoder_seq_dep(*dep_args), ak.decoder_seq_dep_plain(*dep_args)
        torch.cuda.synchronize()
        parts = []
        for nm, g, w in zip(("dep", "dv"), dgot, dwant):
            over, tol, what = seq_reading(g, w, amax(w), torch.bfloat16, nm)
            zero = seq_reading(torch.zeros_like(w), w, amax(w), torch.bfloat16, nm)[0]
            parts.append(f"{nm} {over:.2e}{what} (zeros {zero:.2e}), "
                         f"{float((g != w).float().mean()):.4%} differing")
            check(over <= tol and zero > tol, f"decoder_seq_dep's {nm} disagrees with plain")
            max_errs["decoder_seq_dep"] = max(max_errs.get("decoder_seq_dep", 0.0),
                                              float((g.float() - w.float()).abs().max()))
        k_ms = cuda_ms(lambda: ak.decoder_seq_dep(*dep_args), 10)
        p_ms = cuda_ms(lambda: ak.decoder_seq_dep_plain(*dep_args), 2)
        b_ms, b_by, nbytes = seq_dep_bound(*dep_args[:3])
        d_ms = graph_ms(lambda: ak.decoder_seq_dep(*dep_args))
        rows["decoder_seq_dep"] = dict(ms=k_ms, device_ms=d_ms, plain_ms=p_ms, bound_ms=b_ms,
                                       bound_by=b_by, library_ms=None,
                                       kernel="attn_dep_kernel (t newest first) + attn_dv_kernel")
        again = ak.decoder_seq_dep(*dep_args)
        check(all(torch.equal(a, b) for a, b in zip(dgot, again)),
              "decoder_seq_dep gives other bits in a second run")
        print(f"  decoder_seq_dep (the post-walk pass on B7's walk, t newest first, on the walk's "
              f"dsc): {'; '.join(parts)}; the same bits in two runs; kernel {k_ms:.4f} ms "
              f"({EARLIER_MS['decoder_seq_dep']} ms before, decoder_dep_kernel), {d_ms:.4f} ms on "
              f"the device, plain {p_ms:.4f} ms, bound {b_ms:.5f} ms by {b_by} ({nbytes:.0f} B)")
        wb = NMT_BENCH
        main_shape = (wb["batch"], wb["max_len"], wb["max_len"], wb["emb"], 2 * wb["enc_hidden"],
                      wb["dec_hidden"], wb["dec_hidden"])
        for shape, label in [(main_shape, "(main shapes, seeded, ragged)")] + \
                [(s, "") for s in SEQ_EDGE]:
            B_, S_, T_, E_, C_, A_, H_ = shape
            tag = (f"B={B_} S={S_} T={T_} C={C_} A={A_} H={H_} " + label).strip()
            route = ak.seq_fwd_route(B_, S_, A_, C_, H_, torch.bfloat16)
            check(route == ak.SEQ_TC, f"the bf16 forward at {tag} is on the {route} route")
            print(f"  bf16 forward at {tag}: route {route}, plan "
                  f"{ak.decoder_seq_fwd_plan(B_, S_, A_, C_, H_)}, row path {ak.row_path(A_, C_)}")
            print(f"  bf16 backward's plan at {tag}: {ak.decoder_seq_bwd_plan(B_, S_, A_, C_, H_)}")
            for dt in (torch.float32, torch.bfloat16):
                fwd, bwd = seq_seeded(rng, *shape, dt)
                got, _ = seq_check(ak, "decoder_seq_fwd", fwd, tag, max_errs)
                bgot, _ = seq_check(ak, "decoder_seq_bwd", bwd, tag, max_errs)
                if dt == torch.bfloat16:
                    same_bits(ak.decoder_seq_fwd(*fwd), got, "decoder_seq_fwd")
                if shape == main_shape and dt == torch.bfloat16:
                    seq_control(ak, "decoder_seq_fwd", fwd, got)
                    seq_control(ak, "decoder_seq_bwd", bwd, bgot)

        n += 1
        phase(n, "NMT training at full width (bf16), whole-sequence decoder: 3 timed steps, "
              "then the per-step route as context")
        counters = {"decoder_seq_fwd": (ak, "decoder_seq_fwd_launches"),
                    "decoder_seq_bwd": (ak, "decoder_seq_bwd_launches"),
                    "decoder_seq_dep": (ak, "decoder_seq_dep_launches"),
                    "attn_fwd": (ak, "attn_fwd_launches"),
                    "attn_bwd_step": (ak, "attn_bwd_step_launches"),
                    "attn_phase2": (ak, "attn_phase2_launches"),
                    "gru_fwd": (rnn_kernels, "gru_fwd_launches"),
                    "gru_bwd": (rnn_kernels, "gru_bwd_launches")}
        step_losses, launches, med = timed_steps(exe, main_p, feed, loss.name, scope, counters,
                                                 tokens, smi, "whole-sequence decoder",
                                                 tally=ak.decoder_seq_fwd_routes)
    finally:
        flags.__exit__()
    routes = launches.pop("routes")
    wb = NMT_BENCH
    route = ak.seq_fwd_route(wb["batch"], wb["max_len"], wb["dec_hidden"], 2 * wb["enc_hidden"],
                             wb["dec_hidden"], torch.bfloat16)
    losses += step_losses
    print(f"  losses (warm-up, then timed): {losses}; per step expected {SEQ_STEP_LAUNCHES}, "
          f"decoder_seq_fwd on the {route} route (launches by route {routes})")
    check(all(np.isfinite(losses)), "non-finite loss")
    check(losses[-1] < losses[0], "the loss did not fall over 4 steps on one batch")
    for k, c in SEQ_STEP_LAUNCHES.items():
        check(launches[k] == 3 * c, f"{k} launched {launches[k]} times in 3 steps")
    check(routes[route] == 3 * SEQ_STEP_LAUNCHES["decoder_seq_fwd"],
          f"decoder_seq_fwd's launches by route {routes}: not all on the main shape's {route}")
    off_losses, off_launches, off_med = timed_steps(exe, main_p, feed, loss.name, scope, counters,
                                                    tokens, smi, "per-step route (seq flags off)")
    check(all(np.isfinite(off_losses)), "non-finite loss on the per-step route")
    check(off_launches["attn_fwd"] == 3 * NMT_BENCH["max_len"] and
          off_launches["decoder_seq_fwd"] == 0, f"the per-step route launched {off_launches}")
    print(f"  whole-sequence decoder {med:.3f} ms a step, per-step route {off_med:.3f} ms")

    n += 1
    phase(n, "small NMT program, built by the port's front end, whole-sequence decoder: card "
          "against CPU (f32, then bf16)")
    smain, sstart, sloss = build_nmt_program(ptt, **NMT_SMALL)
    state = seeded_state(ptt, smain, sstart, seed + 14)
    srng = np.random.RandomState(seed + 15)
    sw = NMT_SMALL
    sfeeds = [train_feed(ptt, srng, sw["batch"], sw["max_len"], sw["vocab"], min_len=2)
              for _ in range(2)]
    before = (ak.decoder_seq_fwd_launches, ak.decoder_seq_bwd_launches)
    with _Flags(ptt.FLAGS, **SEQ_FLAGS):
        nmt_card_vs_cpu(ptt, smain, sloss.name, [p.name for p in smain.parameters()], state,
                        sfeeds)
    ran = (ak.decoder_seq_fwd_launches - before[0], ak.decoder_seq_bwd_launches - before[1])
    check(ran == (4, 4), f"the small program's card runs launched B9 and B10 {ran} times")
    return rows, max_errs, launches


# a tensor-core f32 convolution rounds each operand to TF32 (2^-11); an f32
# one lies within a few f32 ulps of float64: phase 27 holds the port's f32
# conv on the card to float64 at this share of the output's largest element
CONV_F32_TOL = 1e-5


def tf32_phase(ptt, smi, n):
    """C1: with torch's TF32 defaults restored, an Executor made for the
    card runs an f32 conv2d in f32 (within f32 error of a float64 CPU
    reference); the same convolution under the restored default, as
    context."""
    import torch.nn.functional as F

    phase(n, "f32 convolution on the card against float64, torch's TF32 defaults restored")
    torch.backends.cuda.matmul.allow_tf32 = False  # torch's defaults
    torch.backends.cudnn.allow_tf32 = True
    print(f"  before: matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    ptt.reset_default_programs()
    prog, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(prog, startup):
        img = ptt.layers.data("img", shape=[28, 28, 64])
        out = ptt.layers.conv2d(img, num_filters=128, filter_size=3, padding=1, bias_attr=False,
                                data_format="NHWC")
    scope = ptt.Scope()
    cexe = ptt.Executor()
    print(f"  after ptt.Executor(): matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    cexe.run(startup, scope=scope, seed=7)
    x = np.random.RandomState(8).standard_normal((16, 28, 28, 64)).astype(np.float32)
    got = cexe.run(prog, {"img": x}, [out.name], scope=scope)[0]
    w = scope.get(prog.global_block().ops[0].inputs["Filter"][0])
    ref = F.conv2d(torch.as_tensor(x).double().permute(0, 3, 1, 2), w.double().cpu(),
                   padding=1).permute(0, 2, 3, 1).numpy()
    scale = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max()) / scale
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
        tf32 = F.conv2d(torch.as_tensor(x).cuda().permute(0, 3, 1, 2), w.cuda(), padding=1)
        tf32 = tf32.permute(0, 2, 3, 1).cpu().numpy()
    tf32_err = float(np.abs(tf32 - ref).max()) / scale
    print(f"  the port's f32 conv2d (16x28x28x64, 3x3, 128 filters): {err:.3e} of the largest "
          f"output from float64 (tol {CONV_F32_TOL:g}); cuDNN with TF32 allowed, as context: "
          f"{tf32_err:.3e}; on {smi}")
    check(not torch.backends.cudnn.allow_tf32, "the Executor left cuDNN's TF32 on")
    check(err <= CONV_F32_TOL, "the port's f32 convolution is not f32-accurate on the card")


# ------------------------------------------------------------ int8 serving --
# bench.py's transformer LM at the `all` sweep's row (_build_transformer_train,
# bench.py:378-422, is_test), quantized as the JAX package's `quant` command
# does it (paddle_tpu/cli.py:1079 _cmd_quant): an fp artifact saved and
# loaded, calibrated on 8 synthetic samples (B=4), converted with the first
# as the check feed, saved and loaded again (its sidecar checked), then
# serving requests of B=8 in bf16
QTFM = dict(dim=2048, heads=32, layers=8, seqlen=1024, vocab=32000)
QTFM_BATCH = 8
QTFM_SITES = 6 * QTFM["layers"] + 1  # q, k, v, o, FFN in and out a block; the head
# bench.py's serving_quant MLP (run_serving_quant, bench.py:2137-2200):
# 512 → 1024 → 1024 → 128, B=8, calibrated on 8 RandomState(0) feeds, held
# out RandomState(99)
QMLP = dict(in_dim=512, hidden=1024, out_dim=128, batch=8)
QMLP_SITES = 3
QMLP_REL_DELTA = 0.05  # the bound bench.py:2234 asserts
# phase 30, card against CPU: the transformer cut to dim 64 (one head of
# D=64, the flash kernel's), 2 layers, T=16, vocab 128, B=4; and the MLP
QTFM_SMALL = dict(dim=64, heads=1, layers=2, seqlen=16, vocab=128)
# calibration ranges card against CPU: f32 sums in another order; bf16
# activations a few bf16 ulps (2^-8 relative each) apart
QRANGE_TOL = {None: 1e-5, "bfloat16": 2e-2}
# B12 against its plain version, tolerance 0: the sites of both paths, then
# on the wgmma route M in {1, 8, 17, 64, 65, 127, 8193} (below one 64-row
# warpgroup, one and a row past it, a row past 64 tiles of 128) x K in {32,
# 48, 8192} (one k32 step, a stage zero-filled past K, 64 stages) x N in
# {24, 256, 1000} (below one 256-column tile, one, and ragged), each also on
# the kept route, not taken; on the kept mma.sync route K=40 (no tensor
# map: K % 16) at M in {1, 8, 17, 8193} x N in {1000, 24}; then every value
# -128, then 127, at the largest K
QMM_EDGE = [(m, k, n) for m in (1, 8, 17, 64, 65, 127, 8193) for k in (32, 48, 8192)
            for n in (24, 256, 1000)]
QMM_EDGE_KEPT = [(m, 40, n) for m in (1, 8, 17, 8193) for n in (1000, 24)]
QMM_CONST = (8193, 8192, 1000)
# the H100 SXM's dense int8 peak (NVIDIA data sheet), at a 700 W limit
INT8_PEAK_OPS = 1979e12
# how phase 28 sums the profiled request's device time
QTFM_KERNEL_KINDS = {"int8 GEMM (B12)": ("quant_matmul",), "flash kernels": ("flash_",),
                     "matrix products": ("nvjet", "gemm", "cutlass"),
                     "elementwise": ("elementwise", "copy", "fill"),
                     "reductions": ("reduce", "softmax", "norm")}


def synthetic_samples(feed_specs, feed_names, n, batch=4):
    """The JAX package's calibration feeds (paddle_tpu/cli.py
    `_synthetic_samples`): seed-0 standard-normal floats and randint(0, 8)
    ints, -1 dims pinned to the batch (dim 0) or 8 (inner dims)."""
    rng = np.random.RandomState(0)
    samples = []
    for _ in range(n):
        feed = {}
        for name in feed_names:
            spec = feed_specs[name]
            shape = [batch if i == 0 and d == -1 else (8 if d == -1 else d)
                     for i, d in enumerate(spec["shape"])]
            dtype = np.dtype(spec["dtype"])
            if dtype.kind in "iu":
                feed[name] = rng.randint(0, 8, size=shape).astype(dtype)
            else:
                feed[name] = rng.standard_normal(shape).astype(dtype)
        samples.append(feed)
    return samples


def mlp_samples(n=8):
    """bench.py run_serving_quant's calibration feeds."""
    rng = np.random.RandomState(0)
    return [{"x": rng.standard_normal((QMLP["batch"], QMLP["in_dim"])).astype(np.float32)}
            for _ in range(n)]


def mlp_eval_feed():
    return {"x": np.random.RandomState(99).standard_normal(
        (QMLP["batch"], QMLP["in_dim"])).astype(np.float32)}


def build_lm_infer(ptt, dim, heads, layers, seqlen, vocab):
    """bench.py's transformer LM, is_test, through the port's front end:
    (main, startup, logits)."""
    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        toks = ptt.layers.data("toks", shape=[seqlen], dtype=np.int32)
        logits = ptt.models.transformer_lm(toks, vocab_size=vocab, dim=dim, num_heads=heads,
                                           num_layers=layers, max_len=seqlen, is_test=True)
    return main, startup, logits


def build_qmlp(ptt, in_dim, hidden, out_dim):
    """bench.py run_serving_quant's MLP: (main, startup, pred)."""
    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        x = ptt.layers.data("x", shape=[in_dim])
        h1 = ptt.layers.fc(x, size=hidden, act="relu", name="q_fc1")
        h2 = ptt.layers.fc(h1, size=hidden, act="relu", name="q_fc2")
        pred = ptt.layers.fc(h2, size=out_dim, name="q_fc3")
    return main, startup, pred


def save_fp_artifact(ptt, build, feed_name, dirname, seed, device):
    """Build, run the startup program from `seed` on `device`, and save the
    fp inference artifact; returns the seconds the save took."""
    main, startup, target = build()
    scope = ptt.Scope()
    ptt.Executor(device=device).run(startup, scope=scope, seed=seed)
    t0 = time.perf_counter()
    ptt.io.save_inference_model(dirname, [feed_name], [target], main_program=main, scope=scope)
    return time.perf_counter() - t0


def quantize_artifact(ptt, fp_dir, q_dir, samples, device, amp):
    """The `quant` command's recipe on `device`: load, calibrate, convert
    with samples[0] as the check feed, save. Returns (report, calibration,
    seconds by step)."""
    secs, t0 = {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        if device == "cuda":
            torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    scope = ptt.Scope()
    prog, feeds, fetches = ptt.io.load_inference_model(fp_dir, scope=scope, device=device)
    prog.set_amp(amp)
    lap("load")
    exe = ptt.Executor(device=device)
    calib = ptt.quant.calibrate(prog, samples, scope=scope, exe=exe)
    lap("calibrate")
    report = ptt.quant.convert(prog, scope=scope, calib=calib, check_feed=samples[0],
                               fetch_list=fetches, exe=exe)
    lap("convert")
    ptt.io.save_inference_model(q_dir, feeds, fetches, main_program=prog, scope=scope)
    lap("save")
    return report, calib, secs


def qmm_bound(M, K, N):
    """xq, wq read and the int32 output written once; 2·M·N·K int8
    operations at the int8 peak."""
    nbytes = M * K + K * N + 4 * M * N
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2.0 * M * N * K / INT8_PEAK_OPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def qmm_on(qk, route, a, b):
    """quant_matmul's kernel on `route`, whichever route kernel_route names:
    the route not taken, held and timed beside the one taken. Not counted."""
    M, N = a.shape[0], b.shape[1]
    out = torch.empty(M, N, dtype=torch.int32, device=a.device)
    lib = qk._lib()
    launch, w = ((lib.quant_matmul_tc_launch, qk.kmajor_weight(b)) if route == qk.WGMMA
                 else (lib.quant_matmul_launch, b))
    err = launch(a.data_ptr(), w.data_ptr(), out.data_ptr(), M, N, a.shape[1],
                 torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"quant_matmul's {route} kernel at M={M} K={a.shape[1]} N={N}: "
          f"{lib.quant_matmul_error_string(err).decode()}")
    return out


def int_mm_pair(a, b, M, K, N, reps):
    """torch._int_mm's time (cuBLASLt int8, the yardstick) with the weight
    as it lies ([K, N] row-major) and in the column-major layout its IMMA
    kernels want (b.t().contiguous().t(), made before the timed calls); None
    each where it refuses the shape."""
    if not int_mm_takes(M, K, N):
        return None, None
    bc = b.t().contiguous().t()
    try:
        return (cuda_ms(lambda: torch._int_mm(a, b), reps),
                cuda_ms(lambda: torch._int_mm(a, bc), reps))
    except RuntimeError as e:  # cuBLASLt refuses some of those shapes too (M=65, K=48)
        if "CUBLAS_STATUS_NOT_SUPPORTED" not in str(e):
            raise
        return None, None


def int_mm_takes(M, K, N):
    """The shapes torch._int_mm (cuBLASLt int8, the yardstick) takes: its
    documented M > 16 and N % 8 == 0, and K % 16 == 0 (it refuses K=40 on
    the H100)."""
    return M > 16 and K % 16 == 0 and N % 8 == 0


def qmm_sites(program):
    """{(M, K, N): calls} of one request's quantized ops, M from the feed's
    batch and the ops' x_num_col_dims."""
    block = program.global_block()
    sites = {}
    for op in block.ops:
        if op.type != "quantized_mul":
            continue
        K, N = block.var(op.inputs["Y"][0]).shape
        x_shape = block.var(op.inputs["X"][0]).shape
        lead = x_shape[:op.attrs.get("x_num_col_dims", 1)]
        M = int(np.prod([QTFM_BATCH if d == -1 else d for d in lead]))
        sites[(M, int(K), int(N))] = sites.get((M, int(K), int(N)), 0) + 1
    return sites


def expect_quant_error(ptt, fn, match):
    """fn() must raise io.QuantMetaError with `match` in its message."""
    try:
        fn()
    except ptt.io.QuantMetaError as e:
        check(match in str(e), f"QuantMetaError without {match!r}: {e}")
        return str(e)
    fail(f"a {match} artifact loaded without QuantMetaError")


def flip_bound_check(qk, op, scope_get, xs, outs, amp):
    """One quantized op on the card and the CPU, from their own inputs:
    the activation codes that differ, and each output within what its
    row's differing codes can move it, Σ|Δcode| · x_scale · max|w_col|,
    plus the output's own rounding (two f32 ulps; one bf16 ulp). Returns
    (share of codes differing, the largest excess over that bound)."""
    wq = scope_get(op.inputs["Y"][0]).cpu()
    ws = scope_get(op.inputs["Scale"][0]).cpu()
    K, N = wq.shape
    codes = [qk._quantize_act(torch.as_tensor(np.array(x, np.float32)).reshape(-1, K),
                              op.attrs["x_scale"]).int() for x in xs]
    flips = (codes[0] - codes[1]).abs().sum(1).double()
    colmax = (wq.abs().double() * ws.double()).amax(0)
    bound = flips[:, None] * op.attrs["x_scale"] * colmax[None, :]
    a, b = (torch.as_tensor(np.array(o, np.float64)).reshape(-1, N) for o in outs)
    big = torch.maximum(a.abs(), b.abs())
    slack = torch.as_tensor(bf16_ulp(big.numpy())) if amp else 2.0 ** -22 * big
    excess = float(((a - b).abs() - bound - slack).max())
    return float((codes[0] != codes[1]).double().mean()), excess


def quant_phases(ptt, exe, smi, seed, first_phase, keep):
    """Phases first_phase.. of the int8 serving slice; returns B12's rows
    (the wgmma route, the kept mma.sync route), each route's largest error,
    and each route's launches on the transformer and MLP paths. The int8
    transformer artifact is moved to `keep` for the serving phase (39)."""
    from paddle_tpu_torch.ops import flash_kernels as fk
    from paddle_tpu_torch.ops import flash_ops
    from paddle_tpu_torch.ops import quant_kernels as qk

    n = first_phase
    phase(n, "B12 (csrc/quant_matmul.cu) against its plain version (float64) on the card, "
          "tolerance 0: the site shapes of both paths, then edge shapes")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 27)

    def rnd(*shape):
        return torch.randint(-128, 128, shape, dtype=torch.int8, device="cuda", generator=gen)

    M_T = QTFM_BATCH * QTFM["seqlen"]
    D, F, V = QTFM["dim"], 4 * QTFM["dim"], QTFM["vocab"]
    paths = {"transformer request": {(M_T, D, D): 4 * QTFM["layers"], (M_T, D, F): QTFM["layers"],
                                     (M_T, F, D): QTFM["layers"], (M_T, D, V): 1},
             "MLP request": {(QMLP["batch"], QMLP["in_dim"], QMLP["hidden"]): 1,
                             (QMLP["batch"], QMLP["hidden"], QMLP["hidden"]): 1,
                             (QMLP["batch"], QMLP["hidden"], QMLP["out_dim"]): 1}}
    other = {qk.WGMMA: qk.MMA_SYNC, qk.MMA_SYNC: qk.WGMMA}

    def on_route(fn, M, K, N, route):
        """fn() (one quant_matmul call), which must take `route`."""
        before = dict(qk.quant_matmul_routes)
        out = fn()
        took = {k: qk.quant_matmul_routes[k] - before[k] for k in before}
        check(qk.kernel_route(M, K, N) == route and took == {**{k: 0 for k in took}, route: 1},
              f"quant_matmul M={M} K={K} N={N} took {took}, not the {route} route")
        return out

    max_err, totals = {qk.WGMMA: 0, qk.MMA_SYNC: 0}, {}

    def held(got, want, route, what):
        """got against the plain version's want at tolerance 0, into the
        route's largest error."""
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max()) if want.numel() else 0
        check(got.dtype == torch.int32 and err == 0,
              f"quant_matmul {what} ({route}) differs from its plain version by {err}")
        max_err[route] = max(max_err[route], err)

    route = qk.WGMMA  # every site of both paths
    for path, sites in paths.items():
        tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, library_row_ms=0.0,
                   other_ms=0.0)
        by = {"bytes": 0.0, "operations": 0.0}
        for (M, K, N), calls in sites.items():
            a, b = rnd(M, K), rnd(K, N)
            got = on_route(lambda: qk.quant_matmul(a, b), M, K, N, route)
            want = qk.quant_matmul_plain(a, b)
            held(got, want, route, f"M={M} K={K} N={N}")
            held(qmm_on(qk, other[route], a, b), want, other[route], f"M={M} K={K} N={N}")
            o_ms = cuda_ms(lambda: qmm_on(qk, other[route], a, b), 10)
            k_ms = cuda_ms(lambda: qk.quant_matmul(a, b), 10)
            p_ms = cuda_ms(lambda: qk.quant_matmul_plain(a, b), 2)
            b_ms, b_by = qmm_bound(M, K, N)
            row_ms, col_ms = int_mm_pair(a, b, M, K, N, 10)
            earlier = f" ({EARLIER_MS['quant_matmul'] * 1e3:.2f} us before the redesign)" \
                if (M, K, N) == (M_T, D, D) else ""
            print(f"  {path} M={M} K={K} N={N} (x{calls}): equal on both routes; {route} "
                  f"kernel {k_ms * 1e3:.2f} us{earlier} ({other[route]}, not taken, "
                  f"{o_ms * 1e3:.2f} us), bound {b_ms * 1e3:.2f} us by {b_by} "
                  f"({100 * b_ms / k_ms:.2f}%), "
                  f"{2.0 * M * N * K / k_ms / 1e9:.1f} TOP/s; plain {p_ms:.4f} ms; torch._int_mm "
                  + (f"{col_ms * 1e3:.2f} us with the weight column-major, {row_ms * 1e3:.2f} us "
                     "row-major as it lies" if row_ms else "refuses the shape"))
            for key, v in (("ms", k_ms), ("plain_ms", p_ms), ("bound_ms", b_ms),
                           ("library_ms", col_ms), ("library_row_ms", row_ms), ("other_ms", o_ms)):
                tot[key] = None if v is None or tot[key] is None else tot[key] + calls * v
            by[b_by] += calls * b_ms
        # the row's yardstick: the faster of the two layouts over the path
        row_lib, col_lib = tot.pop("library_row_ms"), tot["library_ms"]
        if col_lib is not None:
            layout = "column-major" if col_lib <= row_lib else "row-major"
            tot["library_ms"] = min(col_lib, row_lib)
        else:
            layout = None
        other_ms = tot.pop("other_ms")
        totals[path] = dict(tot, bound_by=max(by, key=by.get), library_layout=layout,
                            library_other_ms=None if layout is None else max(col_lib, row_lib),
                            at=path, route_not_taken_ms=other_ms)
        print(f"  {path}, {sum(sites.values())} calls on the {route} route: kernel "
              f"{tot['ms']:.4f} ms ({other[route]}, not taken, {other_ms:.4f} ms), bound "
              f"{tot['bound_ms']:.4f} ms ({100 * tot['bound_ms'] / tot['ms']:.2f}%), plain "
              f"{tot['plain_ms']:.4f} ms, torch._int_mm "
              + (f"{col_lib:.4f} ms with the weight column-major, {row_lib:.4f} ms row-major"
                 if layout else "not for every site") + f" on {smi}")
    for shapes, route in ((QMM_EDGE, qk.WGMMA), (QMM_EDGE_KEPT, qk.MMA_SYNC)):
        for M, K, N in shapes:
            a, b = rnd(M, K), rnd(K, N)
            got = on_route(lambda: qk.quant_matmul(a, b), M, K, N, route)
            want = qk.quant_matmul_plain(a, b)
            held(got, want, route, f"M={M} K={K} N={N}")
            b_ms, b_by = qmm_bound(M, K, N)
            k_ms = cuda_ms(lambda: qk.quant_matmul(a, b), 5)
            p_ms = cuda_ms(lambda: qk.quant_matmul_plain(a, b), 2)
            line = (f"  edge M={M} K={K} N={N} ({route}): equal; kernel {k_ms * 1e3:.2f} us, "
                    f"bound {b_ms * 1e3:.2f} us by {b_by}, plain {p_ms:.4f} ms")
            if K % 16 == 0:
                held(qmm_on(qk, other[route], a, b), want, other[route], f"M={M} K={K} N={N}")
                o_ms = cuda_ms(lambda: qmm_on(qk, other[route], a, b), 5)
                line += f"; {other[route]} (not taken) equal, {o_ms * 1e3:.2f} us"
            if (M, K, N) == QMM_EDGE_KEPT[-2]:
                kept_row = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                                library_ms=None, at=f"M={M} K={K} N={N}")
            row_ms, col_ms = int_mm_pair(a, b, M, K, N, 5)
            if row_ms:
                line += (f", torch._int_mm {col_ms * 1e3:.2f} us column-major, "
                         f"{row_ms * 1e3:.2f} us row-major")
            print(line)
    M, K, N = QMM_CONST
    for v in (-128, 127):
        a = torch.full((M, K), v, dtype=torch.int8, device="cuda")
        b = torch.full((K, N), v, dtype=torch.int8, device="cuda")
        got = qk.quant_matmul(a, b)
        held(got, qk.quant_matmul_plain(a, b), qk.kernel_route(M, K, N), f"every value {v}")
        check(int(got[0, 0]) == K * v * v, f"quant_matmul with every value {v}: C[0, 0]")
        print(f"  M={M} K={K} N={N}, every value {v}: equal, C = {int(got[0, 0])}")
    a, b = rnd(M_T, D), rnd(D, V)
    check(torch.equal(qk.quant_matmul(a, b), qk.quant_matmul(a, b)),
          "quant_matmul's outputs differ between two runs")
    a, b = rnd(QMM_EDGE_KEPT[-2][0], 40), rnd(40, QMM_EDGE_KEPT[-2][2])
    check(torch.equal(qk.quant_matmul(a, b), qk.quant_matmul(a, b)),
          "quant_matmul's kept route gives other bits in a second run")
    for M, K, N in paths["MLP request"]:
        a, b = rnd(M, K), rnd(K, N)
        check(torch.equal(qk.quant_matmul(a, b), qk.quant_matmul(a, b)),
              f"quant_matmul at the MLP's M={M} K={K} N={N} gives other bits in a second run")
    print(f"  M={M_T} K={D} N={V} and the MLP's sites (wgmma), M={QMM_EDGE_KEPT[-2][0]} K=40 "
          f"N={QMM_EDGE_KEPT[-2][2]} (mma.sync): the same bits in two runs")
    del a, b, got, want

    work = tempfile.mkdtemp(prefix="chip_smoke_quant_")
    try:
        n += 1
        phase(n, "the quantized transformer LM at full width: save, load, calibrate, convert, "
              "save, load, then 3 requests of B=8 x 1024 tokens in bf16")
        fp_dir, q_dir = os.path.join(work, "tfm_fp"), os.path.join(work, "tfm_int8")
        t0 = time.perf_counter()
        save_s = save_fp_artifact(ptt, lambda: build_lm_infer(ptt, **QTFM), "toks", fp_dir,
                                  seed, "cuda")
        torch.cuda.empty_cache()
        print(f"  fp artifact: built, startup from seed {seed} and saved in "
              f"{time.perf_counter() - t0:.2f} s (the save {save_s:.2f} s, "
              f"{os.path.getsize(os.path.join(fp_dir, 'params.npz')) / 2**30:.2f} GiB)")
        with open(os.path.join(fp_dir, "meta.json")) as f:
            fmeta = json.load(f)
        samples = synthetic_samples(fmeta["feed_specs"], fmeta["feed_names"], 8)
        report, _, secs = quantize_artifact(ptt, fp_dir, q_dir, samples, "cuda", "bfloat16")
        meta = report.meta()
        print(f"  quantized in bf16: load {secs['load']:.2f} s, calibrate (8 samples of "
              f"B=4) {secs['calibrate']:.2f} s, convert {secs['convert']:.2f} s (quantize_weight "
              f"in numpy and the check feed run twice), save {secs['save']:.2f} s")
        print(f"  report: {meta['sites']} sites, {meta['skipped']} skipped, "
              f"{meta['bytes_saved']} weight bytes saved, accuracy_delta "
              f"{meta['accuracy_delta']:.6g} on the check feed")
        check(meta["sites"] == QTFM_SITES and meta["skipped"] == 0,
              f"{meta['sites']} sites quantized, {meta['skipped']} skipped")
        check(np.isfinite(meta["accuracy_delta"]), "non-finite accuracy_delta")
        torch.cuda.empty_cache()
        scope = ptt.Scope()
        t0 = time.perf_counter()
        prog, feeds, fetches = ptt.io.load_inference_model(q_dir, scope=scope)
        torch.cuda.synchronize()
        print(f"  int8 artifact loaded (sidecar checked) in {time.perf_counter() - t0:.2f} s: "
              f"{sorted({o.type for o in prog.global_block().ops})}")
        check(qmm_sites(prog) == paths["transformer request"],
              f"the request's sites {qmm_sites(prog)}")
        prog.set_amp("bfloat16")
        rng = np.random.RandomState(seed + 28)
        reqs = [{"toks": rng.randint(0, QTFM["vocab"], (QTFM_BATCH, QTFM["seqlen"]))
                 .astype(np.int32)} for _ in range(3)]
        tokens = QTFM_BATCH * QTFM["seqlen"]
        exe.run(prog, reqs[0], fetches, scope=scope)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        qk.quant_matmul_launches = fk.flash_fwd_launches = flash_ops.plain_routes = 0
        qk.quant_matmul_routes = {k: 0 for k in qk.quant_matmul_routes}
        times, outs = [], []
        for r in reqs:
            t0 = time.perf_counter()
            outs.append(exe.run(prog, r, fetches, scope=scope, return_numpy=False)[0])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        tfm_launches, tfm_routes = qk.quant_matmul_launches, dict(qk.quant_matmul_routes)
        print(f"  launches in 3 requests: quant_matmul {tfm_launches} (by route {tfm_routes}), "
              f"flash_fwd {fk.flash_fwd_launches}; flash_attention calls routed to the plain "
              f"formula {flash_ops.plain_routes}; K-major weight copies kept "
              f"{len(qk._KMAJOR)} "
              f"({sum(c.numel() for _, _, c in qk._KMAJOR.values()) / 1e6:.1f} MB)")
        check(tfm_launches == 3 * QTFM_SITES, f"quant_matmul launched {tfm_launches} times")
        check(tfm_routes == {qk.WGMMA: 3 * QTFM_SITES, qk.MMA_SYNC: 0},
              f"the request's quant_matmul calls took the routes {tfm_routes}")
        check(fk.flash_fwd_launches == 3 * QTFM["layers"], "flash_fwd launches")
        check(flash_ops.plain_routes == 0, "the int8 request routed attention to the plain formula")
        for o in outs:
            check(tuple(o.shape) == (QTFM_BATCH, QTFM["seqlen"], QTFM["vocab"])
                  and o.dtype == torch.bfloat16, f"logits {tuple(o.shape)} {o.dtype}")
            check(bool(torch.isfinite(o.float()).all()), "non-finite logits")
        med = statistics.median(times)
        print(f"  requests ms: {[round(t, 3) for t in times]}; median {med:.3f} ms/request, "
              f"{tokens / med * 1e3:.1f} tokens/s (B={QTFM_BATCH}, T={QTFM['seqlen']}); peak "
              f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {smi}")
        busy, by_kind = breakdown(lambda: exe.run(prog, reqs[0], fetches, scope=scope,
                                                  return_numpy=False), med, "request",
                                  kinds=QTFM_KERNEL_KINDS)
        if busy:
            print(f"  B12's share of the request's device time: "
                  f"{100 * by_kind.get('int8 GEMM (B12)', 0.0) / busy:.1f}%; the request's flash "
                  f"time {by_kind.get('flash kernels', 0.0) / 1e3:.3f} ms")
        again = exe.run(prog, reqs[0], fetches, scope=scope, return_numpy=False)[0]
        kernel_route, before = qk.quant_matmul, qk.quant_matmul_launches
        qk.quant_matmul = qk.quant_matmul_plain
        try:
            plain = exe.run(prog, reqs[0], fetches, scope=scope, return_numpy=False)[0]
        finally:
            qk.quant_matmul = kernel_route
        torch.cuda.synchronize()
        check(torch.equal(outs[0], again), "the kernel route's logits differ between two runs")
        check(qk.quant_matmul_launches == before, "the plain route launched the kernel")
        same = torch.equal(outs[0], plain)
        print(f"  logits on the kernel route: the same bits in two runs; equal to the same "
              f"program with quant_matmul sent to its plain version: {same}")
        check(same, "the kernel route's logits differ from the plain route's")
        del scope, outs, again, plain
        torch.cuda.empty_cache()
        fscope = ptt.Scope()
        fprog, _, ffetch = ptt.io.load_inference_model(fp_dir, scope=fscope)
        fprog.set_amp("bfloat16")
        exe.run(fprog, reqs[0], ffetch, scope=fscope, return_numpy=False)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ftimes = []
        for r in reqs:
            t0 = time.perf_counter()
            exe.run(fprog, r, ffetch, scope=fscope, return_numpy=False)
            torch.cuda.synchronize()
            ftimes.append((time.perf_counter() - t0) * 1e3)
        fmed = statistics.median(ftimes)
        print(f"  context, the fp artifact in bf16: requests ms {[round(t, 3) for t in ftimes]}; "
              f"median {fmed:.3f} ms/request, {tokens / fmed * 1e3:.1f} tokens/s; peak device "
              f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        breakdown(lambda: exe.run(fprog, reqs[0], ffetch, scope=fscope, return_numpy=False),
                  fmed, "fp request", kinds=QTFM_KERNEL_KINDS)
        del fscope
        shutil.rmtree(fp_dir)
        shutil.move(q_dir, keep)  # served by phase 50, not quantized again
        torch.cuda.empty_cache()

        n += 1
        phase(n, "bench.py's serving_quant MLP (512-1024-1024-128, B=8), built by the port's "
              "front end: quantized, served, and stale or tampered artifacts refused")
        fp_dir, q_dir = os.path.join(work, "mlp_fp"), os.path.join(work, "mlp_int8")
        mlp = lambda: build_qmlp(ptt, QMLP["in_dim"], QMLP["hidden"], QMLP["out_dim"])  # noqa: E731
        save_fp_artifact(ptt, mlp, "x", fp_dir, seed + 29, "cuda")
        report, _, secs = quantize_artifact(ptt, fp_dir, q_dir, mlp_samples(), "cuda", None)
        meta = report.meta()
        print(f"  report: {meta['sites']} sites, {meta['bytes_saved']} bytes saved, "
              f"accuracy_delta {meta['accuracy_delta']:.6g}; load {secs['load']:.3f} s, "
              f"calibrate {secs['calibrate']:.3f} s, convert {secs['convert']:.3f} s, save "
              f"{secs['save']:.3f} s")
        check(meta["sites"] == QMLP_SITES and meta["skipped"] == 0, f"MLP sites {meta}")
        out = {}
        for name, d in (("fp", fp_dir), ("int8", q_dir)):
            sc_ = ptt.Scope()
            p_, _, f_ = ptt.io.load_inference_model(d, scope=sc_)
            feed = mlp_eval_feed()
            exe.run(p_, feed, f_, scope=sc_)
            torch.cuda.synchronize()
            qk.quant_matmul_launches = 0
            qk.quant_matmul_routes = {k: 0 for k in qk.quant_matmul_routes}
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                out[name] = exe.run(p_, feed, f_, scope=sc_)[0]
                times.append((time.perf_counter() - t0) * 1e3)
            print(f"  {name}: {statistics.median(times):.3f} ms/request (B={QMLP['batch']}), "
                  f"quant_matmul launches in 3 requests {qk.quant_matmul_launches} (by route "
                  f"{qk.quant_matmul_routes})")
        mlp_launches, mlp_routes = qk.quant_matmul_launches, dict(qk.quant_matmul_routes)
        check(mlp_launches == 3 * QMLP_SITES, f"the MLP launched quant_matmul {mlp_launches} "
              "times in 3 requests")
        check(mlp_routes == {qk.WGMMA: 3 * QMLP_SITES, qk.MMA_SYNC: 0},
              f"the MLP's quant_matmul calls took the routes {mlp_routes}")
        rel = float(np.abs(out["fp"] - out["int8"]).max() / np.abs(out["fp"]).max())
        print(f"  held-out RandomState(99) feed: max |int8 - fp| over max |fp| {rel:.5f} "
              f"(bench.py's bound {QMLP_REL_DELTA})")
        check(out["int8"].shape == (QMLP["batch"], QMLP["out_dim"]) and np.isfinite(
            out["int8"]).all(), "MLP outputs")
        check(rel <= QMLP_REL_DELTA, f"the int8 MLP is {rel:.4f} from fp")
        stale = os.path.join(work, "mlp_stale")
        shutil.copytree(q_dir, stale)
        with open(os.path.join(stale, "program.json")) as f:
            pd = json.load(f)
        next(o for o in pd["blocks"][0]["ops"] if o["type"] == "quantized_mul")[
            "attrs"]["x_scale"] *= 2.0
        with open(os.path.join(stale, "program.json"), "w") as f:
            json.dump(pd, f)
        msg = expect_quant_error(ptt, lambda: ptt.io.load_inference_model(
            stale, scope=ptt.Scope()), "stale")
        print(f"  stale program (an x_scale doubled): QuantMetaError: {msg[:90]}...")
        tampered = os.path.join(work, "mlp_tampered")
        shutil.copytree(q_dir, tampered)
        path = os.path.join(tampered, "params.npz")
        payload = dict(np.load(path))
        payload[min(k for k in payload if k.endswith(ptt.quant.SCALE_SUFFIX))] *= 1.5
        np.savez(path, **payload)
        msg = expect_quant_error(ptt, lambda: ptt.io.load_inference_model(
            tampered, scope=ptt.Scope()), "digest")
        print(f"  tampered scale (x1.5): QuantMetaError: {msg[:90]}...")

        n += 1
        phase(n, "small quantized transformer (dim 64, 2 layers, T=16, vocab 128) and the MLP: "
              "card against CPU, f32 then bf16")
        small = {"transformer": (lambda: build_lm_infer(ptt, **QTFM_SMALL), "toks"),
                 "MLP": (mlp, "x")}
        for model, (build, feed_name) in small.items():
            fp_dir = os.path.join(work, f"small_{feed_name}_fp")
            save_fp_artifact(ptt, build, feed_name, fp_dir, seed + 30, "cpu")
            with open(os.path.join(fp_dir, "meta.json")) as f:
                fmeta = json.load(f)
            if model == "MLP":
                calib_feeds, feed = mlp_samples(), mlp_eval_feed()
            else:
                calib_feeds = synthetic_samples(fmeta["feed_specs"], fmeta["feed_names"], 8)
                feed = {"toks": np.random.RandomState(seed + 30).randint(
                    0, QTFM_SMALL["vocab"], (4, QTFM_SMALL["seqlen"])).astype(np.int32)}
            for amp in (None, "bfloat16"):
                ranges, digests = {}, {}
                for dev in ("cpu", "cuda"):
                    qd = os.path.join(work, f"small_{feed_name}_{dev}_{amp}")
                    _, calib, _ = quantize_artifact(ptt, fp_dir, qd, calib_feeds, dev, amp)
                    ranges[dev] = calib.act_ranges
                    with open(os.path.join(qd, "meta.json")) as f:
                        digests[dev] = json.load(f)["quant"]["scales_digest"]
                rerr = max(abs(ranges["cuda"][k] - v) / v for k, v in ranges["cpu"].items())
                check(digests["cpu"] == digests["cuda"], "card and CPU int8 payloads differ")
                check(rerr <= QRANGE_TOL[amp], f"calibration ranges {rerr:.3e} apart")
                # the CPU's artifact served on both
                qd = os.path.join(work, f"small_{feed_name}_cpu_{amp}")
                res, scopes = {}, {}
                for dev in ("cpu", "cuda"):
                    scopes[dev] = ptt.Scope()
                    p_, _, _ = ptt.io.load_inference_model(qd, scope=scopes[dev], device=dev)
                    p_.set_amp(amp)
                    qops = [o for o in p_.global_block().ops if o.type == "quantized_mul"]
                    names = [o.inputs["X"][0] for o in qops] + [o.outputs["Out"][0] for o in qops]
                    res[dev] = ptt.Executor(device=dev).run(p_, feed, names, scope=scopes[dev])
                sc_ = scopes["cpu"]
                shares, excess = [], float("-inf")
                for i, op in enumerate(qops):
                    share, ex = flip_bound_check(
                        qk, op, sc_.get, (res["cpu"][i], res["cuda"][i]),
                        (res["cpu"][len(qops) + i], res["cuda"][len(qops) + i]), amp)
                    shares.append(share)
                    excess = max(excess, ex)
                print(f"  {model} {amp or 'f32'}: calibration ranges at most {rerr:.3e} apart "
                      f"(tol {QRANGE_TOL[amp]:g}), equal payload digests; the CPU's artifact on "
                      f"both: activation codes differing at the {len(qops)} sites in order "
                      f"{', '.join(f'{100 * x:.2f}%' for x in shares)}; every output within "
                      f"its row's flipped codes' bound (largest excess {excess:.3e})")
                check(excess <= 0.0, f"{model} {amp}: an output beyond its flipped codes' bound")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    names = {"quant_matmul": qk.WGMMA, "quant_matmul_mma": qk.MMA_SYNC}
    rows = {"quant_matmul": totals["transformer request"], "quant_matmul_mma": kept_row}
    launches = {name: {"transformer_int8_executor": tfm_routes[route],
                       "mlp_int8_serve": mlp_routes[route]} for name, route in names.items()}
    return rows, {name: max_err[route] for name, route in names.items()}, launches


# ------------------------------------------------- the Trainer, and A6a --
# bench.py's train_loop row (run_train_loop, bench.py:910-1070): 16
# features, fc 256 tanh, fc 1, square_error_cost, mean, SGD(0.01); B=64, 60
# steps a pass; pass 0 warms up, pass 1 is timed
TRAIN_LOOP = dict(features=16, hidden=256, batch=64, steps=60, lr=0.01)
TRAIN_LOOP_SCAN = 8  # bench.py's BENCH_SCAN_WINDOW
# the ResNet Trainer run: bench.py's _build_resnet_train at RESNET_BENCH on
# the B11 route, 2 passes of 4 batches of (img, label) samples
RESNET_PASSES, RESNET_BATCHES = 2, 4
# the timed passes (prefetch depth 2 against 0) walk the samples twice
TIMED_BATCHES = 2 * RESNET_BATCHES
# the mid-pass resume against the uninterrupted run, when two card steps
# from one state do not give the same bits: the relative L2 norm of the
# difference of every parameter (the two-step reading is printed beside)
RESUME_REL_L2 = 1e-3
# eval-mode ResNet-50 (A6a). bench.py's resnet_infer row (run_infer,
# bench.py:754-838): NHWC 224x224x3, 1000 classes, B=128, bf16
RESNET_INFER_BATCH = 128
# __graft_entry__.entry's NCHW is_test ResNet-50 (__graft_entry__.py:117-145)
GRAFT_BATCH = 8
# card against CPU. f32 (the Executor turns cuDNN's TF32 off): the same f32
# arithmetic in other orders over 53 layers, within INFER_F32_REL of the
# largest logit (tests/test_torch_resnet_infer.py measured 7e-7 between the
# packages on the CPU). bf16: cuDNN and oneDNN round each conv output to
# bf16 after f32 sums in other orders, and a flip travels through the
# residual stream (on the CPU the port and the JAX package differ in 42% of
# 4000 logits by more than an ulp, as much as an f32 run rounded once):
# every logit within INFER_BF16_REL of the largest and at most
# INFER_BF16_SHARE of them beyond one bf16 ulp, beside a zero output's 1.0
# and 1.0. The served B=128 bf16 logits against the same artifact run in
# f32 on the card: INFER_BF16_REL.
INFER_F32_REL = 1e-4
INFER_BF16_REL, INFER_BF16_SHARE = 5e-2, 0.75
RESNET_EVAL_SMALL = dict(hw=64, batch=4, class_dim=10)
# the card the new phases run on, against the CPU
CARD = "cuda"


def build_train_loop(ptt, seed):
    """bench.py's train_loop model through the port's front end; the
    startup draws from `seed` (its random_seed)."""
    ptt.reset_default_programs()
    prog, startup = ptt.Program(), ptt.Program()
    startup.random_seed = seed
    with ptt.program_guard(prog, startup):
        x = ptt.layers.data("x", shape=[TRAIN_LOOP["features"]])
        y = ptt.layers.data("y", shape=[1])
        h = ptt.layers.fc(x, size=TRAIN_LOOP["hidden"], act="tanh")
        pred = ptt.layers.fc(h, size=1)
        loss = ptt.layers.mean(ptt.layers.square_error_cost(pred, y))
        ptt.optimizer.SGD(learning_rate=TRAIN_LOOP["lr"]).minimize(loss)
    return prog, startup, loss


def train_loop_phase(ptt, smi, seed, n, work):
    """Phase n: the train_loop row through the port's Trainer in three
    modes; returns its readings."""
    from paddle_tpu_torch import obs, profiler

    phase(n, "bench.py's train_loop row through the port's Trainer (16 features, hidden 256, "
          "B=64, 60 steps, SGD(0.01)): sync, async, scan (scan_window=8), async_traced")
    B, steps = TRAIN_LOOP["batch"], TRAIN_LOOP["steps"]
    rng = np.random.RandomState(seed)
    xs = rng.randn(steps * B, TRAIN_LOOP["features"]).astype(np.float32)
    ys = (xs @ rng.randn(TRAIN_LOOP["features"], 1)).astype(np.float32)

    def reader():
        for i in range(steps):
            yield {"x": xs[i * B:(i + 1) * B], "y": ys[i * B:(i + 1) * B]}

    trace_path = os.path.join(work, "train_loop.trace.json")
    results, params, trace_doc = {}, {}, {}
    old_timers = ptt.FLAGS.enable_timers
    ptt.FLAGS.enable_timers = True
    try:
        for mode, interval, window in (("sync", 1, 0), ("async", steps, 0),
                                       ("scan", steps, TRAIN_LOOP_SCAN),
                                       ("async_traced", steps, 0)):
            prog, startup, loss = build_train_loop(ptt, seed + 11)
            scope = ptt.Scope()
            trainer = ptt.Trainer(loss, main_program=prog, startup_program=startup, scope=scope)
            traced = mode == "async_traced"
            if traced:
                obs.trace.arm(out=trace_path)
            # pass 0 warms up (and captures the scan column's step)
            trainer.train(reader, num_passes=1, log_interval=interval, scan_window=window)
            stats = profiler.global_stat_set()
            stats.reset()
            syncs0, disp0 = trainer.host_sync_count, trainer.host_dispatch_count
            cache0 = dict(trainer.exe.cache_stats)
            t0 = time.perf_counter()
            trainer.train(reader, num_passes=1, log_interval=interval, scan_window=window)
            dt = time.perf_counter() - t0  # the pass ends in the accumulator's read
            if traced:
                obs.trace.disarm(export=True)
                with open(trace_path) as f:
                    trace_doc = json.load(f)
            blocked = stats.stats.get("hostSync")
            results[mode] = {
                "steps_per_sec": steps / dt,
                "host_syncs_per_step": (trainer.host_sync_count - syncs0) / steps,
                "dispatches_per_step": (trainer.host_dispatch_count - disp0) / steps,
                "host_blocked_fraction": (blocked.total if blocked else 0.0) / dt}
            if window:
                cs = trainer.exe.cache_stats
                results[mode].update(
                    scan_window=window, captures=cs["captures"],
                    replays_timed_pass=cs["replays"] - cache0["replays"],
                    eager_steps_timed_pass=cs["eager_steps"] - cache0["eager_steps"])
            params[mode] = {p.name: scope.get(p.name).cpu() for p in prog.parameters()}
            extra = (f"; {results[mode]['captures']} capture (pass 0), "
                     f"{results[mode]['replays_timed_pass']} replays and "
                     f"{results[mode]['eager_steps_timed_pass']} eager steps in the timed pass"
                     if window else "")
            print(f"  {mode}: {results[mode]['steps_per_sec']:.1f} steps/s, "
                  f"{results[mode]['host_syncs_per_step']:.4f} host syncs a step, "
                  f"{results[mode]['dispatches_per_step']:.4f} dispatches a step, host-blocked "
                  f"{100 * results[mode]['host_blocked_fraction']:.2f}% of the pass's "
                  f"wall time{extra}")
        # hidden syncs: the async pass once more with torch counting every
        # synchronizing call (set_sync_debug_mode), the trainer's own reads
        # among them
        import warnings

        s0 = trainer.host_sync_count
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                trainer.train(reader, num_passes=1, log_interval=steps)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        msgs = [str(w.message).split("\n")[0] for w in caught]
        print(f"  async pass under torch.cuda.set_sync_debug_mode('warn'): {len(msgs)} "
              f"synchronizing calls reported over {steps} steps, beside the trainer's "
              f"{trainer.host_sync_count - s0} counted syncs; first: {sorted(set(msgs))[:3]}")
    finally:
        ptt.FLAGS.enable_timers = old_timers
    spans = [e for e in trace_doc.get("traceEvents", ()) if e.get("ph") == "X"]
    threads = {e["tid"] for e in spans}
    problems = obs.validate_chrome_trace(trace_doc)
    print(f"  traced: {len(spans)} spans on {len(threads)} threads, validate_chrome_trace: "
          f"{problems or 'no problems'}; tracing cost "
          f"{100 * (1 - results['async_traced']['steps_per_sec'] / results['async']['steps_per_sec']):.2f}"
          f"% of async's steps/s")
    # bench.py's train_loop assertions (bench.py:1020-1041)
    check(results["async"]["host_syncs_per_step"] < results["sync"]["host_syncs_per_step"],
          f"async fences no less often than sync: {results}")
    check(results["scan"]["dispatches_per_step"] < results["async"]["dispatches_per_step"],
          f"scan dispatches no less often than async: {results}")
    check(results["scan"]["host_syncs_per_step"] <= results["async"]["host_syncs_per_step"],
          f"scan fences more often than async: {results}")
    check(results["scan"]["host_syncs_per_step"] <= 1.0 / TRAIN_LOOP_SCAN,
          f"scan fences more often than once a window: {results}")
    check(results["scan"]["replays_timed_pass"] == steps
          and results["scan"]["eager_steps_timed_pass"] == 0,
          f"the timed scan pass did not replay every step: {results['scan']}")
    for k in ("host_syncs_per_step", "dispatches_per_step"):
        check(results["async_traced"][k] == results["async"][k],
              f"the traced run's {k} differs from async's")
    check(len(threads) >= 2, f"spans on {len(threads)} threads, not >= 2")
    check(not problems, f"the exported trace fails validation: {problems[:3]}")
    for mode in ("async", "scan", "async_traced"):
        for name, want in params["sync"].items():
            check(torch.equal(params[mode][name], want),
                  f"{mode}: parameter {name} differs from sync's")
    print("  the parameters are the same bits in the four modes")
    return results


def bind_trained(eval_prog, train_prog, train_scope):
    """{name: value} for every persistable of the eval program from the
    training scope: by name (`_cbn_attrs` names each conv and BN pair alike
    in the fused training graph and the unfused eval graph), and the
    parameters whose automatic names differ (the classifier's fc) in the
    order both programs create them, shapes checked."""
    bound = {v.name: train_scope.get(v.name) for v in eval_prog.persistables()
             if train_scope.has(v.name)}
    left = [v for v in eval_prog.persistables() if v.name not in bound]
    spare = [v for v in train_prog.parameters()
             if v.name not in bound and train_scope.has(v.name)]
    check(len(left) == len(spare), f"unbound eval parameters {[v.name for v in left]}, "
          f"training parameters left {[v.name for v in spare]}")
    for e, t in zip(left, spare):
        check(tuple(e.shape) == tuple(t.shape), f"{e.name} {e.shape} against {t.name} {t.shape}")
        bound[e.name] = train_scope.get(t.name)
    return bound, len(left)


def snapshot(scope, names):
    return {n: scope.get(n).clone() for n in names}


def diff_reading(got, want):
    """(share of differing elements, relative L2 norm of the difference)
    over every tensor of `want`."""
    ndiff = total = 0
    d2 = w2 = 0.0
    for n, w in want.items():
        g = got[n]
        ndiff += int((g != w).sum())
        total += w.numel()
        d2 += float((g.double() - w.double()).square().sum())
        w2 += float(w.double().square().sum())
    return ndiff / total, math.sqrt(d2 / max(w2, 1e-300))


def h2d_overlap(trace_path):
    """From a torch.profiler Chrome trace: the streams of the host-to-device
    copies and of the kernels, and the share of the copies' time that ran
    while a kernel ran on another stream."""
    with open(trace_path) as f:
        evs = json.load(f)["traceEvents"]
    kern = [e for e in evs if e.get("cat") == "kernel" and "dur" in e]
    copies = [e for e in evs if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")]
    by_stream = {}
    for e in kern:
        s = e.get("args", {}).get("stream")
        by_stream[s] = by_stream.get(s, 0.0) + e["dur"]
    compute = max(by_stream, key=by_stream.get) if by_stream else None
    copy_streams = sorted({str(e.get("args", {}).get("stream")) for e in copies})
    spans = sorted((e["ts"], e["ts"] + e["dur"], e.get("args", {}).get("stream")) for e in kern)
    total = over = 0.0
    for c in copies:
        s0, s1, cs = c["ts"], c["ts"] + c["dur"], c.get("args", {}).get("stream")
        total += s1 - s0
        cut = []
        for k0, k1, ks in spans:
            if k0 >= s1:
                break
            if k1 > s0 and ks != cs:
                cut.append((max(k0, s0), min(k1, s1)))
        end = s0
        for a, b in sorted(cut):
            if b > end:
                over += b - max(a, end)
                end = b
    return dict(compute_stream=compute, copy_streams=copy_streams, copies=len(copies),
                copy_ms=total / 1e3, overlapped=(over / total) if total else 0.0)


def resnet_trainer_phase(ptt, smi, seed, n, work, step_ms):
    """Phase n: ResNet-50 trained at full width through the port's Trainer,
    checkpointed, resumed; returns (its readings, the trained scope and
    program)."""
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.ops import fused_conv_kernels as fk

    phase(n, "ResNet-50 through the port's Trainer at full width (bf16, B11 route): reader -> "
          "batch -> DataFeeder -> DevicePrefetcher, checkpoints, determinism, mid-pass resume")
    B = RESNET_BENCH["batch"]
    hw, classes = RESNET_BENCH["hw"], RESNET_BENCH["class_dim"]
    t0 = time.perf_counter()
    rng = np.random.RandomState(seed + 20)
    imgs = rng.randn(RESNET_BATCHES * B, hw, hw, 3).astype(np.float32)
    labels = rng.randint(0, classes, (RESNET_BATCHES * B, 1)).astype(np.int32)
    samples = list(zip(imgs, labels))
    reader = ptt.data.batch(lambda: iter(samples), B)
    print(f"  {len(samples)} (img, label) samples made from --seed in "
          f"{time.perf_counter() - t0:.2f} s ({imgs.nbytes / 2**20:.0f} MiB)")
    out = {}
    flags = _Flags(ptt.FLAGS, fused_conv_dot_max_n=RESNET_DOT_MAX_N, fused_conv_pallas=True,
                   enable_timers=True)
    with flags:
        main_p, startup, loss = build_resnet_program(
            ptt, **{k: RESNET_BENCH[k] for k in ("hw", "class_dim", "lr")})
        startup.random_seed = seed + 21
        feed_order = [main_p.global_block().var("img"), main_p.global_block().var("label")]
        persist = [v.name for v in main_p.persistables()]
        params = [p.name for p in main_p.parameters()]
        feeder = ptt.data.DataFeeder(feed_order)
        fused = [o.type for o in main_p.global_block().ops].count("fused_conv_bn")

        # pinning one batch's images: the first call grows torch's caching
        # host allocator (cudaHostAlloc), a second reuses the freed block
        imgs0 = feeder.feed(next(iter(reader())))["img"]
        pin_first = []
        for _ in range(2):
            t0 = time.perf_counter()
            pinned = torch.as_tensor(imgs0).pin_memory()
            pin_first.append((time.perf_counter() - t0) * 1e3)
            del pinned
        print(f"  pinning a batch's images ({imgs0.nbytes / 2**20:.1f} MiB): the process's first "
              f"{pin_first[0]:.3f} ms (the caching host allocator grows), again "
              f"{pin_first[1]:.3f} ms (a cached block)")
        out.update(pin_first_ms=pin_first[0], pin_again_ms=pin_first[1])
        del imgs0

        # two card steps from one state
        exe = ptt.Executor()
        sc = ptt.Scope()
        exe.run_startup(startup, scope=sc)
        state0 = snapshot(sc, persist)
        feed = feeder.feed(next(iter(reader())))
        runs = []
        for _ in range(2):
            for k, v in state0.items():
                sc.set(k, v.clone())
            exe.run(main_p, feed, [loss.name], scope=sc)
            runs.append(snapshot(sc, params))
        share, rel = diff_reading(runs[1], runs[0])
        deterministic = share == 0.0
        print(f"  two card steps from one state: the parameters are "
              f"{'the same bits' if deterministic else 'NOT the same bits'}; share of "
              f"differing values {share:.3e}, relative L2 {rel:.3e} (no deterministic mode set)")
        out.update(determinism_share=share, determinism_rel_l2=rel)
        del sc, state0, runs

        # the uninterrupted run, checkpointed
        ck = os.path.join(work, "resnet_ckpt")
        cfg = ptt.CheckpointConfig(ck, epoch_interval=1, step_interval=3, background=True)
        sc_a = ptt.Scope()
        trainer = ptt.Trainer(loss, main_program=main_p, startup_program=startup, scope=sc_a,
                              checkpoint_config=cfg)
        stats = profiler.global_stat_set()
        stats.reset()
        fk.fused_conv_bn_launches = 0
        losses, marks = [], []

        def on_event(e):
            if isinstance(e, ptt.EndIteration):
                losses.append(e.cost)
            elif isinstance(e, (ptt.BeginPass, ptt.EndPass)):
                marks.append(time.perf_counter())

        t0 = time.perf_counter()
        trainer.train(reader, RESNET_PASSES, feed_order=feed_order, prefetch_to_device=2,
                      event_handler=on_event)
        wall = time.perf_counter() - t0
        steps = RESNET_PASSES * RESNET_BATCHES
        losses = [float(c) for c in losses]
        pass_ms = [(marks[2 * i + 1] - marks[2 * i]) * 1e3 / RESNET_BATCHES
                   for i in range(RESNET_PASSES)]
        print(f"  uninterrupted run: {steps} steps in {wall:.2f} s, ms a step by pass "
              f"{[round(t, 3) for t in pass_ms]} (BeginPass to EndPass: the first pass's "
              f"first pinned blocks, and the waits on the previous commit, included); losses "
              f"{losses}")
        check(all(np.isfinite(losses)), "non-finite loss in the Trainer run")
        b11 = fk.fused_conv_bn_launches
        check(b11 == fused * steps, f"B11 launched {b11} times in {steps} steps, not "
              f"{fused * steps}")
        print(f"  B11 launches: {b11} in {steps} steps, {b11 // steps} a step (the program's "
              f"{fused} fused_conv_bn ops)")
        snap, commit = stats.get("checkpointSnapshot"), stats.get("checkpointCommit")
        print(f"  checkpoints: {snap.count} snapshots on the step loop, {1e3 * snap.avg:.3f} ms "
              f"each; {commit.count} commits on the writer thread (host copy, npz, sha256), "
              f"{commit.avg:.3f} s each, largest {commit.max:.3f} s; serials "
              f"{ptt.io._complete_serials(ck)}")
        out.update(b11_launches_per_step=b11 // steps, ckpt_snapshot_ms=1e3 * snap.avg,
                   ckpt_commit_s=commit.avg, losses=losses, pass_ms=pass_ms)
        full = snapshot(sc_a, persist)

        # the mid-pass resume
        serial = None
        for s in ptt.io._complete_serials(ck):
            with open(os.path.join(ptt.io._serial_dir(ck, s), "meta.json")) as f:
                args = json.load(f)["trainer_args"]
            if args.get("mid_pass") and args["pass_id"] == RESNET_PASSES - 1:
                serial = s
        check(serial is not None, "no mid-pass checkpoint in the last pass")
        rdir = os.path.join(work, "resnet_resume")
        shutil.copytree(ck, rdir)
        for s in ptt.io._complete_serials(rdir):
            if s > serial:
                shutil.rmtree(ptt.io._serial_dir(rdir, s))
        sc_r = ptt.Scope()
        resumed = ptt.Trainer(loss, main_program=main_p, startup_program=startup, scope=sc_r,
                              checkpoint_config=ptt.CheckpointConfig(rdir, step_interval=3))
        resumed.init()
        print(f"  resume from serial {serial}: pass {resumed.start_pass}, batch "
              f"{resumed._resume_batch}, step {resumed.step}")
        resumed.train(reader, RESNET_PASSES, feed_order=feed_order, prefetch_to_device=2)
        check(resumed.step == steps, f"the resumed run ended at step {resumed.step}")
        share, rel = diff_reading(snapshot(sc_r, persist), full)
        print(f"  resumed against uninterrupted, every persistable: share of differing values "
              f"{share:.3e}, relative L2 {rel:.3e}")
        if deterministic:
            check(share == 0.0, "the resumed run is not the same bits as the uninterrupted "
                  "run, though two card steps from one state were")
        else:
            check(rel <= RESUME_REL_L2, f"the resumed run is {rel:.3e} apart (relative L2), "
                  f"past {RESUME_REL_L2}")
        out.update(resume_share=share, resume_rel_l2=rel)
        del sc_r, resumed, full

        # prefetch depth 2 against 0, in turns, a pass each, no checkpoints
        sc_t = ptt.Scope()
        timing = ptt.Trainer(loss, main_program=main_p, startup_program=startup, scope=sc_t)
        timing.init()
        for k, v in snapshot(sc_a, persist).items():
            sc_t.set(k, v)
        # in turns: the Trainer at prefetch depth 2 and 0, and the bare loop
        # (the DevicePrefetcher feeding Executor.run, no Trainer) at depth 2;
        # a pass walks the samples twice (TIMED_BATCHES steps), so the
        # prefetcher's fill at a pass's start weighs less
        timed = ptt.data.batch(lambda: itertools.chain(samples, samples), B)
        ms = {2: [], 0: [], "bare": []}
        for kind in (2, 0, "bare", "bare", 0, 2) * 3:
            t0 = time.perf_counter()
            if kind == "bare":
                for feed in ptt.data.DevicePrefetcher(timed, feeder, depth=2):
                    timing.exe.run(main_p, feed, [loss.name], scope=sc_t, return_numpy=False)
                torch.cuda.synchronize()
            else:
                timing.train(timed, 1, feed_order=feed_order, prefetch_to_device=kind)
            ms[kind].append((time.perf_counter() - t0) * 1e3 / TIMED_BATCHES)
        m2, m0, mb = (statistics.median(ms[k]) for k in (2, 0, "bare"))
        print(f"  ms a step, a pass of {TIMED_BATCHES} each, in turns (2, 0, bare, bare, 0, 2) "
              f"x 3: the Trainer at prefetch depth 2 {[round(t, 3) for t in ms[2]]}, depth 0 "
              f"{[round(t, 3) for t in ms[0]]}, the bare prefetched loop "
              f"{[round(t, 3) for t in ms['bare']]}; medians {m2:.3f}, {m0:.3f}, {mb:.3f} "
              f"({B / m2 * 1e3:.1f}, {B / m0 * 1e3:.1f}, {B / mb * 1e3:.1f} images/s); phase "
              f"20's Executor.run step in this run {step_ms:.3f} ms, on {smi}")
        # the producer's host work a batch, here on the main thread: the
        # DataFeeder's stack of 128 samples, then the copy into pinned memory
        batch = next(iter(reader()))
        feed_ms, pin_ms = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            fd = feeder.feed(batch)
            t1 = time.perf_counter()
            pinned = [torch.as_tensor(v).pin_memory() for v in fd.values()]
            t2 = time.perf_counter()
            feed_ms.append((t1 - t0) * 1e3)
            pin_ms.append((t2 - t1) * 1e3)
        print(f"  a batch's host work, median of 3: DataFeeder.feed {statistics.median(feed_ms):.3f}"
              f" ms, the copy into pinned memory {statistics.median(pin_ms):.3f} ms "
              f"({sum(p.nbytes for p in pinned) / 2**20:.1f} MiB)")
        del pinned
        out.update(feed_ms=statistics.median(feed_ms), pin_ms=statistics.median(pin_ms))
        out.update(ms_depth2=m2, ms_depth0=m0, ms_bare_depth2=mb,
                   images_per_s_depth2=B / m2 * 1e3, phase20_step_ms=step_ms)

        # one pass at depth 2 under torch.profiler
        from torch.profiler import ProfilerActivity, profile

        prof_path = os.path.join(work, "resnet_trainer.trace.json")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            timing.train(timed, 1, feed_order=feed_order, prefetch_to_device=2)
            wall_us = (time.perf_counter() - t0) * 1e6
        prof.export_chrome_trace(prof_path)
        with open(prof_path) as f:
            evs = [e for e in json.load(f)["traceEvents"]
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]
        busy, end = 0.0, float("-inf")
        for s0, s1 in sorted((e["ts"], e["ts"] + e["dur"]) for e in evs):
            busy += max(0.0, s1 - max(s0, end))
            end = max(end, s1)
        ov = h2d_overlap(prof_path)
        print(f"  profiled pass: wall {wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms "
              f"({100 * busy / wall_us:.1f}%); host-to-device copies: {ov['copies']}, "
              f"{ov['copy_ms']:.3f} ms on stream(s) {ov['copy_streams']}, the kernels' main "
              f"stream {ov['compute_stream']}; {100 * ov['overlapped']:.1f}% of the copies' "
              f"time overlapped kernels on another stream")
        out.update(busy_share=busy / wall_us, h2d_copy_streams=ov["copy_streams"],
                   compute_stream=ov["compute_stream"], h2d_overlapped=ov["overlapped"])
        del sc_t, timing, prof
    return out, main_p, sc_a


def resnet_eval_program(ptt, hw, class_dim, fmt):
    """bench.py run_infer's eval-mode ResNet-50 (is_test) through the
    port's front end. Returns (program, logits)."""
    ptt.reset_default_programs()
    prog, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(prog, startup):
        shape = [hw, hw, 3] if fmt == "NHWC" else [3, hw, hw]
        img = ptt.layers.data("img", shape=shape)
        logits = ptt.models.resnet_imagenet(img, class_dim=class_dim, is_test=True,
                                            data_format=fmt)
    return prog, logits


def logit_reading(got, want):
    """(largest error over the largest logit, share beyond one bf16 ulp of
    `want`)."""
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
    return (float(np.abs(got - want).max() / np.abs(want).max()),
            float(np.mean(np.abs(got - want) > ulp)))


def hold_logits(got, want, amp, what):
    rel, share = logit_reading(got, want)
    zero = logit_reading(torch.zeros_like(want), want)
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite logits")
    if amp is None:
        print(f"  {what}: f32 logits within {rel:.3e} of the largest (max {INFER_F32_REL}; a "
              f"zero output reads {zero[0]:.1f})")
        check(rel <= INFER_F32_REL, f"{what}: {rel:.3e} apart")
    else:
        print(f"  {what}: bf16 logits within {rel:.3e} of the largest (max {INFER_BF16_REL}), "
              f"{share:.4f} of them beyond one bf16 ulp (max {INFER_BF16_SHARE}); a zero output "
              f"reads {zero[0]:.1f} and {zero[1]:.1f}")
        check(rel <= INFER_BF16_REL and share <= INFER_BF16_SHARE, f"{what}: {rel:.3e} apart, "
              f"{share:.4f} beyond one ulp")


def resnet_infer_phase(ptt, smi, seed, n, work, train_prog, train_scope):
    """Phase n: ResNet-50 served from the Trainer's weights (A6a); returns
    its readings."""
    from paddle_tpu_torch.ops import fused_conv_kernels as fk

    phase(n, "ResNet-50 inference (A6a) from the trained weights: the eval-mode NHWC artifact "
          "(B=128, bf16) saved, loaded, served; the graft entry's NCHW program and a small one, "
          "card against CPU")
    hw, classes, B = RESNET_BENCH["hw"], RESNET_BENCH["class_dim"], RESNET_INFER_BATCH
    eprog, logits = resnet_eval_program(ptt, hw, classes, "NHWC")
    eprog.set_amp("bfloat16")
    bound, by_order = bind_trained(eprog, train_prog, train_scope)
    esc = ptt.Scope()
    for k, v in bound.items():
        esc.set(k, v)
    art = os.path.join(work, "resnet_infer")
    ptt.io.save_inference_model(art, ["img"], [logits], main_program=eprog, scope=esc)
    lsc = ptt.Scope()
    iprog, feeds, fetches = ptt.io.load_inference_model(art, scope=lsc)
    iprog.set_amp("bfloat16")
    for k, v in bound.items():
        check(torch.equal(lsc.get(k), v), f"{k} did not round-trip through the artifact")
    print(f"  {len(bound)} persistables bound from the trained scope ({by_order} by creation "
          "order: the classifier's fc), saved, loaded, equal")
    exe = ptt.Executor()
    img = torch.as_tensor(np.random.RandomState(seed + 30).randn(B, hw, hw, 3)
                          .astype(np.float32), device=CARD)
    before = fk.fused_conv_bn_launches
    (out,) = exe.run(iprog, {feeds[0]: img}, fetches, scope=lsc, return_numpy=False)
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        (out,) = exe.run(iprog, {feeds[0]: img}, fetches, scope=lsc, return_numpy=False)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    check(fk.fused_conv_bn_launches == before, "the eval path launched B11")
    check(tuple(out.shape) == (B, classes), f"logits of shape {tuple(out.shape)}")
    med = statistics.median(times)
    print(f"  3 requests of B={B} (bf16, the feed on the card): ms {[round(t, 3) for t in times]},"
          f" median {med:.3f} ms, {B / med * 1e3:.1f} images/s; 0 B11 launches (cuDNN only) "
          f"on {smi}")
    breakdown(lambda: exe.run(iprog, {feeds[0]: img}, fetches, scope=lsc, return_numpy=False),
              med, "request", kinds=RESNET_KERNEL_KINDS)
    iprog.set_amp(None)
    (ref,) = exe.run(iprog, {feeds[0]: img}, fetches, scope=lsc, return_numpy=False)
    rel, _ = logit_reading(out, ref)
    print(f"  the bf16 logits against the artifact run in f32 on the card: within {rel:.3e} of "
          f"the largest (max {INFER_BF16_REL})")
    check(rel <= INFER_BF16_REL, f"bf16 request {rel:.3e} from its f32 run")
    readings = dict(ms=med, images_per_s=B / med * 1e3, bf16_vs_f32=rel)
    del img, out, ref, lsc

    # __graft_entry__.entry's NCHW is_test program, B=8, f32, card and CPU
    gprog, glogits = resnet_eval_program(ptt, hw, classes, "NCHW")
    gbound, _ = bind_trained(gprog, train_prog, train_scope)
    x = np.random.RandomState(seed + 31).randn(GRAFT_BATCH, 3, hw, hw).astype(np.float32)
    outs = {}
    for dev in (CARD, "cpu"):
        sc = ptt.Scope()
        for k, v in gbound.items():
            sc.set(k, v.to(dev))
        (outs[dev],) = ptt.Executor(device=dev).run(gprog, {"img": x}, [glogits], scope=sc,
                                                    return_numpy=False)
    hold_logits(outs[CARD], outs["cpu"], None, f"the graft entry's NCHW program (B="
                f"{GRAFT_BATCH}, 224x224), card against CPU")

    # a small eval-mode program, card against CPU, seeded weights
    s = RESNET_EVAL_SMALL
    sprog, slogits = resnet_eval_program(ptt, s["hw"], s["class_dim"], "NHWC")
    srng = np.random.RandomState(seed + 32)
    state = {}
    for v in sprog.persistables():
        shape = tuple(v.shape)
        if v.name.endswith(".mean"):
            a = 0.1 * srng.randn(*shape)
        elif v.name.endswith(".variance"):
            a = 1 + 0.2 * srng.rand(*shape)
        elif len(shape) == 1:
            a = 1 + 0.1 * srng.randn(*shape) if v.name.endswith("_bn.w_0") else \
                0.05 * srng.randn(*shape)
        else:
            fan_in = shape[0] if len(shape) == 2 else int(np.prod(shape[1:]))
            a = srng.randn(*shape) / np.sqrt(fan_in)
        state[v.name] = a.astype(np.float32)
    x = srng.randn(s["batch"], s["hw"], s["hw"], 3).astype(np.float32)
    for amp in (None, "bfloat16"):
        sprog.set_amp(amp)
        outs = {}
        for dev in (CARD, "cpu"):
            sc = ptt.Scope()
            ptt.io.params_from_numpy(sc, state, dev)
            (outs[dev],) = ptt.Executor(device=dev).run(sprog, {"img": x}, [slogits], scope=sc,
                                                        return_numpy=False)
        hold_logits(outs[CARD], outs["cpu"], amp, f"small eval program ({s['hw']}x{s['hw']}, "
                    f"B={s['batch']}, {s['class_dim']} classes), card against CPU")
    return readings

# the Trainer's scan window at full width (phases 35-37): the per-step async
# loop over WINDOW_RAGGED batches (its parameters also taken at step
# WINDOW_EVEN), scan_window=WINDOW_K over WINDOW_EVEN batches (one window:
# it warms up, captures and replays), then over WINDOW_RAGGED (a window and
# a ragged tail of 2, the same graph), the per-step loop again; then one
# profiled pass of each. Every run starts from one saved state and feeds the
# same batches.
WINDOW_K, WINDOW_EVEN, WINDOW_RAGGED = 4, 4, 6
# {path: {wrapper counter: (the kernel's name in a profile, launches a step)}}
WINDOW_KERNELS = {
    "lstm": {"lstm_fwd_launches": ("lstm_fwd_tc_kernel", 2),
             "lstm_bwd_launches": ("lstm_bwd_tc_kernel", 2)},
    "nmt": {"gru_fwd_launches": ("gru_fwd_tc_kernel", 2),
            "gru_bwd_launches": ("gru_bwd_tc_kernel", 2),
            "attn_fwd_launches": ("attn_fwd_row_kernel", 50),
            "attn_bwd_step_launches": ("attn_bwd_row_kernel", 50),
            "attn_phase2_launches": ("attn_dep_kernel", 1)},
    "resnet50": {"fused_conv_bn_launches": ("fused_conv_bn_tc_kernel", 36)},
    "transformer": {"flash_fwd_launches": ("flash_fwd_tc_kernel", 8),
                    "flash_bwd_dkv_launches": ("flash_bwd_dkv_tc_kernel", 8),
                    "flash_bwd_dq_launches": ("flash_bwd_dq_tc_kernel", 8)},
    # B10's post-walk pass runs B7's two kernels under one counter;
    # attn_dv_kernel is counted in the profile (SEQ_WINDOW_PROFILE_ONLY)
    "nmt_seq": {"gru_fwd_launches": ("gru_fwd_tc_kernel", 2),
                "gru_bwd_launches": ("gru_bwd_tc_kernel", 2),
                "decoder_seq_fwd_launches": ("decoder_seq_fwd_tc_kernel", 1),
                "decoder_seq_bwd_launches": ("decoder_seq_bwd_tc_kernel", 1),
                "decoder_seq_dep_launches": ("attn_dep_kernel", 1),
                "attn_fwd_launches": ("attn_fwd_row_kernel", 0),
                "attn_bwd_step_launches": ("attn_bwd_row_kernel", 0)},
    "sentiment": {"lstm_fwd_launches": ("lstm_fwd_tc_kernel", 3),
                  "lstm_bwd_launches": ("lstm_bwd_tc_kernel", 3)},
    "vgg": {},  # no hand-written kernel: cuDNN's convs, the dropout draws
}
# kernels a window's profile must show a step that no counter of their own
# counts: {path: {name: launches a step}}
WINDOW_PROFILE_ONLY = {"nmt_seq": {"attn_dv_kernel": 1}}
# the small program with a random op in its main program (phase 38)
RANDOM_PROG = dict(batch=16, features=16, hidden=32, steps=8, seed=5, noise=0.1)


def first_differing(got, want):
    """The first name (in want's order) whose tensors are not the same
    bits, or None."""
    return next((n for n, w in want.items() if not torch.equal(got[n], w)), None)


def profile_pass(run, kernel_names):
    """One call of `run` under torch.profiler (profiled_spans): (wall ms,
    device busy ms, {kernel name: launches recorded}, device ms of the
    multi-tensor copies, device events)."""
    wall_us, spans = profiled_spans(run)
    busy, end, copies = 0.0, float("-inf"), 0.0
    for s, e, name in spans:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
        if "multi_tensor_apply" in name:
            copies += e - s
    counts = {k: sum(1 for _, _, name in spans if k in name) for k in kernel_names}
    return wall_us / 1e3, busy / 1e3, counts, copies / 1e3, len(spans)


def profile_whole(run, kernel_names, want):
    """profile_pass, taken again (at most PROFILE_TRIES times) while a
    kernel of `want` ({name: launches the pass makes}) shows fewer: the
    profiler now and then drops an event of a pass of some 40000 (one
    flash_bwd_dkv_tc_kernel of 80 on an H100). A kernel the pass does not
    launch stays short in every try, and its check fails."""
    for _ in range(PROFILE_TRIES):
        res = profile_pass(run, kernel_names)
        short = {k: (res[2][k], n) for k, n in want.items() if res[2][k] < n}
        if not short:
            return res
        print(f"  profiler: (recorded, launched) {short} in a pass of {res[4]} device events; "
              "profiling again")
    return res


def graph_pool_gib(g):
    """The memory the caching allocator holds for a CUDA graph's private
    pool (its segments), or None where the snapshot does not say."""
    pool = tuple(g.pool())
    segs = torch.cuda.memory_snapshot()
    if not segs or "segment_pool_id" not in segs[0]:
        return None
    return sum(s["total_size"] for s in segs if tuple(s["segment_pool_id"]) == pool) / 2**30


def window_path_phase(ptt, smi, n, path, what, build, batches, flags):
    """Phase n: `path` at full width through the port's Trainer, per-step
    against scan_window=WINDOW_K (module constants above); returns its
    readings and, for the sync check, (executor, program, loss, scope)."""
    from paddle_tpu_torch.core import graph

    phase(n, f"{what} through the port's Trainer: the per-step async loop against "
             f"scan_window={WINDOW_K} (a CUDA graph of the step, replayed), "
             f"{WINDOW_EVEN} and {WINDOW_RAGGED} batches")
    kernels = WINDOW_KERNELS[path]
    torch.cuda.empty_cache()  # the earlier phases' cached blocks
    with _Flags(ptt.FLAGS, **flags):
        main_p, startup, loss = build()
        exe = ptt.Executor()
        scope0 = ptt.Scope()
        exe.run(startup, scope=scope0)
        state = {k: scope0.get(k).clone() for k in scope0.keys()}
        del scope0
        pnames = [p.name for p in main_p.parameters()]
        last = {}

        def run(window, nb, snap_at=None):
            scope = ptt.Scope()
            tr = ptt.Trainer(loss, main_program=main_p, startup_program=startup, scope=scope,
                             executor=exe)
            tr.init()
            for k, v in state.items():
                scope.set(k, v.clone())
            snap = {}

            def handler(e):
                if snap_at and isinstance(e, ptt.EndIteration) and e.step == snap_at:
                    snap.update({p: scope.get(p).clone() for p in pnames})

            torch.cuda.synchronize()
            # the blocks the last run cached: a capture allocates its own pool
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            before, cs0 = graph.counter_state(), dict(exe.cache_stats)
            t0 = time.perf_counter()
            tr.train(lambda: iter(batches[:nb]), 1, event_handler=handler, log_interval=nb,
                     scan_window=window)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / nb
            moved = graph.counter_delta(before, graph.counter_state())
            reading = dict(
                ms_per_step=ms, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                peak_reserved_gib=torch.cuda.max_memory_reserved() / 2**30,
                launches_per_step={k: moved.get((m, k), 0) / nb for m, names in
                                   graph.LAUNCH_COUNTERS for k in names if k in kernels},
                dispatches=tr.host_dispatch_count, host_syncs=tr.host_sync_count,
                **{k: exe.cache_stats[k] - cs0[k] for k in ("captures", "replays",
                                                             "eager_steps")})
            last.update(scope=scope)
            return reading, {p: scope.get(p).clone() for p in pnames}, snap

        p1, p1_params, p1_snap = run(0, WINDOW_RAGGED, snap_at=WINDOW_EVEN)
        a, a_params, _ = run(WINDOW_K, WINDOW_EVEN)
        sg = next(iter(exe._windows.values()))
        a["capture_s"] = sg.capture_s
        a["graph_pool_gib"] = graph_pool_gib(sg.graph)
        b, b_params, _ = run(WINDOW_K, WINDOW_RAGGED)
        p2, p2_params, _ = run(0, WINDOW_RAGGED)
        b2, b2_params, _ = run(WINDOW_K, WINDOW_RAGGED)
        names = [v for v, _ in kernels.values()] + list(WINDOW_PROFILE_ONLY.get(path, {}))
        want = {kname: b["launches_per_step"][counter] * WINDOW_RAGGED
                for counter, (kname, _) in kernels.items()}
        want.update({k: c * WINDOW_RAGGED for k, c in WINDOW_PROFILE_ONLY.get(path, {}).items()})
        prof_p = profile_whole(lambda: run(0, WINDOW_RAGGED), names, want)
        prof_w = profile_whole(lambda: run(WINDOW_K, WINDOW_RAGGED), names, want)
    out = {"per_step": p1, "per_step_again": p2, "window_even": a, "window_ragged": b,
           "window_ragged_again": b2, "graphs_held": len(exe._windows),
           "per_step_ms": statistics.mean([p1["ms_per_step"], p2["ms_per_step"]]),
           "window_ms": statistics.mean([b["ms_per_step"], b2["ms_per_step"]])}
    for label, r in (("per-step", p1), (f"window {WINDOW_K} x {WINDOW_EVEN // WINDOW_K}", a),
                     (f"window {WINDOW_K}, ragged tail", b), ("per-step again", p2),
                     ("the ragged window again", b2)):
        cap = (f", {r['captures']} capture in {r['capture_s']:.3f} s, its graph's pool "
               f"{r['graph_pool_gib'] if r['graph_pool_gib'] is None else round(r['graph_pool_gib'], 3)}"
               f" GiB" if r["captures"] else "")
        print(f"  {label}: {r['ms_per_step']:.3f} ms a step, {r['dispatches']} dispatches, "
              f"{r['host_syncs']} host syncs, {r['eager_steps']} eager steps, {r['replays']} "
              f"replays{cap}; peak {r['peak_gib']:.2f} GiB allocated, "
              f"{r['peak_reserved_gib']:.2f} GiB reserved; launches a step "
              f"{r['launches_per_step']} on {smi}")
    for label, (wall, busy, counts, copies, nev), steps in (
            ("per-step", prof_p, WINDOW_RAGGED), ("window", prof_w, WINDOW_RAGGED)):
        out[f"profiled_{label}"] = dict(wall_ms=wall, busy_ms=busy, busy_share=busy / wall,
                                        kernel_launches_per_step={k: c / steps for k, c in
                                                                  counts.items()},
                                        copies_ms=copies, device_events=nev)
        print(f"  profiled {label} pass: wall {wall:.3f} ms, device busy {busy:.3f} ms "
              f"({100 * busy / wall:.1f}%), {nev} device events, the multi-tensor copies "
              f"{copies:.3f} ms ({100 * copies / max(busy, 1e-9):.2f}% of busy); kernels a "
              f"step {out[f'profiled_{label}']['kernel_launches_per_step']}")
    print(f"  graphs held: {out['graphs_held']}; captures over the phase "
          f"{exe.cache_stats['captures']}; ms a step, the mean of the two turns: per-step "
          f"{out['per_step_ms']:.3f}, window {out['window_ms']:.3f} "
          f"({out['per_step_ms'] / out['window_ms']:.2f}x) on {smi}")
    for counter, (kname, want) in kernels.items():
        for label, r in (("per-step", p1), ("window", a), ("ragged window", b),
                         ("the ragged window again", b2)):
            check(r["launches_per_step"][counter] == want,
                  f"{path} {label}: {counter} {r['launches_per_step'][counter]} a step, not {want}")
        seen = out["profiled_window"]["kernel_launches_per_step"][kname]
        check(seen == b["launches_per_step"][counter],
              f"{path}: the window's profile shows {seen} {kname} a step, its counters "
              f"{b['launches_per_step'][counter]}")
    for kname, want in WINDOW_PROFILE_ONLY.get(path, {}).items():
        for label in ("per-step", "window"):
            seen = out[f"profiled_{label}"]["kernel_launches_per_step"][kname]
            check(seen == want, f"{path}: the {label} profile shows {seen} {kname} a step, "
                                f"not {want}")
    check(a["captures"] == 1 and a["eager_steps"] == 1 and a["replays"] == WINDOW_EVEN - 1,
          f"{path}: the first window run did not warm up once, capture once and replay: {a}")
    for r in (b, b2):
        check(r["captures"] == 0 and r["replays"] == WINDOW_RAGGED,
              f"{path}: a ragged run captured again or ran eagerly: {r}")
    d = first_differing(a_params, p1_snap)
    check(d is None, f"{path}: scan_window={WINDOW_K} over {WINDOW_EVEN} batches: parameter "
                     f"{d} differs from the per-step loop's at step {WINDOW_EVEN}")
    d = first_differing(b_params, p1_params)
    check(d is None, f"{path}: the ragged window run: parameter {d} differs from the "
                     f"per-step loop's")
    d = first_differing(b2_params, b_params)
    check(d is None, f"{path}: the two ragged window runs differ first at {d}")
    d = first_differing(p2_params, p1_params)
    out["per_step_runs_same_bits"] = d is None
    print(f"  the windows end on the per-step loop's bits ({len(pnames)} parameters); the two "
          f"per-step runs {'the same bits' if d is None else f'differ first at {d}'}")
    return out, (exe, main_p, loss, last["scope"], batches)


def window_sync_check(ptt, ctx):
    """One window (an already captured step) under
    torch.cuda.set_sync_debug_mode('error'): any synchronizing call raises."""
    exe, main_p, loss, scope, batches = ctx
    win = next(iter(ptt.data.DevicePrefetcher(lambda: iter(batches[:WINDOW_K]), depth=1,
                                              window=WINDOW_K)))
    cs0 = dict(exe.cache_stats)
    # the Trainer's key: its accumulator carried
    z = lambda dt: torch.zeros((), dtype=dt, device=CARD)  # noqa: E731
    acc = (z(torch.int32), z(torch.float32), [], z(torch.int32))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ys, _ = exe.run_window(main_p, win.feed, [loss], scope=scope, acc_state=acc)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check(exe.cache_stats["replays"] - cs0["replays"] == WINDOW_K
          and exe.cache_stats["captures"] == cs0["captures"],
          f"the sync-checked window did not replay the captured step {WINDOW_K} times")
    check(bool(torch.isfinite(ys[0]).all()), "the sync-checked window's costs are not finite")
    print(f"  one window of {WINDOW_K} replays under torch.cuda.set_sync_debug_mode('error'): "
          f"no synchronizing call; costs {[round(float(c), 4) for c in ys[0].float().cpu()]}")


def build_random_program(ptt):
    """A small regression program whose main program draws: tanh(fc(x) +
    gaussian_random noise), fc to 1, squared error, SGD; random_seed set on
    both programs."""
    from paddle_tpu_torch.layers.helper import LayerHelper

    rp = RANDOM_PROG
    ptt.reset_default_programs()
    prog, startup = ptt.Program(), ptt.Program()
    prog.random_seed = startup.random_seed = rp["seed"]
    with ptt.program_guard(prog, startup):
        x = ptt.layers.data("x", shape=[rp["batch"], rp["features"]], append_batch_size=False)
        y = ptt.layers.data("y", shape=[rp["batch"], 1], append_batch_size=False)
        h = ptt.layers.fc(x, size=rp["hidden"])
        helper = LayerHelper("noise")
        noise = helper.create_tmp_variable(np.float32, (rp["batch"], rp["hidden"]))
        helper.append_op(type="gaussian_random", outputs={"Out": [noise]},
                         attrs={"shape": [rp["batch"], rp["hidden"]], "mean": 0.0,
                                "std": rp["noise"], "dtype": "float32"})
        h = helper.append_activation(ptt.layers.elementwise_add(h, noise), "tanh")
        pred = ptt.layers.fc(h, size=1)
        loss = ptt.layers.mean(ptt.layers.square_error_cost(pred, y))
        ptt.optimizer.SGD(learning_rate=0.05).minimize(loss)
    return prog, startup, loss


def random_window_phase(ptt, smi, seed, n, sync_ctx):
    """Phase n: a program with a random op in its main program, its window
    against its per-step loop on the card (random_seed set); then one
    window under the sync debug mode."""
    phase(n, "a program drawing gaussian_random in its main program: scan_window=4 against "
             "the per-step loop on the card; one full-width window under "
             "set_sync_debug_mode('error')")
    rp = RANDOM_PROG
    rng = np.random.RandomState(seed + 60)
    data = [{"x": rng.randn(rp["batch"], rp["features"]).astype(np.float32),
             "y": rng.randn(rp["batch"], 1).astype(np.float32)} for _ in range(rp["steps"])]
    params, costs = {}, {}
    for mode, window in (("per_step", 0), ("window", 4)):
        prog, startup, loss = build_random_program(ptt)
        scope = ptt.Scope()
        tr = ptt.Trainer(loss, main_program=prog, startup_program=startup, scope=scope)
        events = []
        tr.train(lambda: iter(data), 1, event_handler=events.append,
                 log_interval=rp["steps"], scan_window=window)
        params[mode] = {p.name: scope.get(p.name).cpu() for p in prog.parameters()}
        costs[mode] = [float(e.cost) for e in events if isinstance(e, ptt.EndIteration)]
    d = first_differing(params["window"], params["per_step"])
    check(d is None, f"the random program's window: parameter {d} differs from the per-step "
                     "loop's")
    check(costs["window"] == costs["per_step"], f"the random program's costs differ: {costs}")
    print(f"  {rp['steps']} steps with gaussian_random noise (std {rp['noise']}): the window's "
          f"costs and {len(params['window'])} parameters are the per-step loop's bits; costs "
          f"{[round(c, 5) for c in costs['window']]}")
    window_sync_check(ptt, sync_ctx)
    return {"random_op_window_same_bits": True}


def window_phases(ptt, smi, seed, first_phase):
    """Phases first_phase..+5: the LSTM, NMT (per-step attention route) and
    ResNet-50 windows at full width, then the random op program and the
    sync check, then the transformer's and the NMT seq route's windows;
    returns the paths' readings."""
    n = first_phase
    rng = np.random.RandomState(seed + 40)
    lb = LSTM_BENCH
    lstm_batches = []
    for _ in range(WINDOW_RAGGED):
        seqs = [rng.randint(0, lb["vocab"], (lb["seqlen"],)).astype(np.int32)
                for _ in range(lb["batch"])]
        lstm_batches.append({
            "words": ptt.LoDArray.from_sequences(seqs, capacity=lb["batch"] * lb["seqlen"],
                                                 max_seqs=lb["batch"]),
            "label": rng.randint(0, 2, (lb["batch"], 1)).astype(np.int32)})

    def build_lstm():
        main_p, startup, loss = build_lstm_program(ptt, lb["vocab"], lb["emb"], lb["hidden"],
                                                   lb["seqlen"])
        main_p.set_amp("bfloat16")
        return main_p, startup, loss

    out = {}
    out["lstm_window"], sync_ctx = window_path_phase(
        ptt, smi, n, "lstm", f"the LSTM classifier (B={lb['batch']}, T={lb['seqlen']}, "
        f"H={lb['hidden']}, bf16)", build_lstm, lstm_batches, {})
    nb = NMT_BENCH
    pack = lambda seqs: ptt.LoDArray.from_sequences(  # noqa: E731
        seqs, capacity=nb["batch"] * nb["max_len"], max_seqs=nb["batch"])
    nmt_batches = []
    for _ in range(WINDOW_RAGGED):
        srcs = [rng.randint(2, nb["vocab"], (nb["max_len"],)).astype(np.int32)
                for _ in range(nb["batch"])]
        trgs = [rng.randint(2, nb["vocab"], (nb["max_len"],)).astype(np.int32)
                for _ in range(nb["batch"])]
        nmt_batches.append({"src": pack(srcs), "trg_in": pack(trgs), "label": pack(trgs)})

    def build_nmt():
        main_p, startup, loss = build_nmt_program(ptt, nb["vocab"], nb["emb"],
                                                  nb["enc_hidden"], nb["dec_hidden"],
                                                  nb["max_len"])
        main_p.set_amp("bfloat16")
        return main_p, startup, loss

    out["nmt_window"] = window_path_phase(
        ptt, smi, n + 1, "nmt", f"the NMT step on the per-step attention route (B={nb['batch']}, "
        f"S=T={nb['max_len']}, bf16)", build_nmt, nmt_batches,
        dict(fused_attention_seq_fwd=False, fused_attention_seq_bwd=False))[0]
    del nmt_batches
    rb = RESNET_BENCH
    resnet_batches = [resnet_feed(rng, rb["hw"], rb["class_dim"], rb["batch"])
                      for _ in range(WINDOW_RAGGED)]
    out["resnet50_window"] = window_path_phase(
        ptt, smi, n + 2, "resnet50", f"ResNet-50 (B={rb['batch']}, {rb['hw']}x{rb['hw']}, bf16, "
        "B11 route)", lambda: build_resnet_program(ptt, rb["hw"], rb["class_dim"], rb["lr"]),
        resnet_batches, dict(fused_conv_dot_max_n=RESNET_DOT_MAX_N, fused_conv_pallas=True))[0]
    del resnet_batches
    out.update(random_window_phase(ptt, smi, seed, n + 3, sync_ctx))
    del sync_ctx
    gc.collect()
    torch.cuda.empty_cache()
    tb = TFM_BENCH
    tfm_batches = [transformer_feed(rng, tb["vocab"], tb["seqlen"], tb["batch"])
                   for _ in range(WINDOW_RAGGED)]

    def build_tfm():
        main_p, startup, loss = build_transformer_program(ptt, **tb)
        main_p.set_amp("bfloat16")
        return main_p, startup, loss

    out["transformer_window"] = window_path_phase(
        ptt, smi, n + 4, "transformer", f"the transformer LM (dim {tb['dim']}, {tb['layers']} "
        f"layers, T={tb['seqlen']}, B={tb['batch']}, bf16; dense token batches with no LoD, "
        "so its ragged run is only the window's ragged tail)", build_tfm, tfm_batches, {})[0]
    del tfm_batches
    gc.collect()
    torch.cuda.empty_cache()
    seq_batches = [train_feed(ptt, rng, nb["batch"], nb["max_len"], nb["vocab"], min_len=10)
                   for _ in range(WINDOW_RAGGED)]
    out["nmt_seq_window"] = window_path_phase(
        ptt, smi, n + 5, "nmt_seq", f"the NMT step on the whole-sequence decoder (B={nb['batch']}, "
        f"S=T={nb['max_len']}, ragged lengths 10-{nb['max_len']} in one capacity, bf16)",
        build_nmt, seq_batches, SEQ_FLAGS)[0]
    del seq_batches
    gc.collect()
    torch.cuda.empty_cache()
    return out


# --------------------------------- the book's text models (A1b): phases 41-45 --
# understand_sentiment's stacked_lstm_net (paddle_tpu/models/text.py:41) at
# the JAX package's in-kernel widths (experiments/exp_stacked_book.py: vocab
# 30000, emb 128, hid 512, 3 layers, T=128, B=128), bf16, Adam(0.002) as
# the book trains it; ragged reviews of 16-128 tokens from --seed
SENT_BENCH = dict(vocab=30000, emb=128, hidden=512, stacked=3, max_len=128, batch=128,
                  min_len=16)
SENT_LR = 0.002
# the stacked op against the per-layer build from one state: in f32 the
# same arithmetic in another order, held to the bound tests/
# test_stacked_lstm.py:65 holds the JAX package's stacked op to (rtol 1e-5,
# atol 1e-6); in bf16 the per-layer build rounds each half of the
# inter-layer fc before their sum and the op rounds the sum once (printed
# beside that bound, not held)
SENT_FORMS_TOL = dict(rtol=1e-5, atol=1e-6)
# the launches of one step: one lstm_fwd and one lstm_bwd a layer
SENT_STEP_LAUNCHES = {"lstm_fwd": 3, "lstm_bwd": 3}
SENT_KERNEL_KINDS = {"B1 (lstm_fwd)": ("lstm_fwd",),
                     "B2 (lstm_bwd, its dW)": ("lstm_bwd", "dw_product"),
                     "matrix products": ("nvjet", "gemm", "cutlass"),
                     "elementwise": ("elementwise", "copy", "fill"),
                     "reductions and scatters": ("reduce", "scatter", "softmax", "index")}
# tests/book/'s three text programs at their widths, f32, by their
# reference tests' recipes (optimizer, batch, steps or passes, threshold)
BOOK_SENT = dict(vocab=5147, emb=32, hidden=32, stacked=2, max_len=128, batch=16, lr=0.002,
                 steps=50, last=10, acc=0.8)
BOOK_W2V = dict(n=5, emb=32, batch=64, lr=1e-2, passes=4, drop=0.8, perplexity=0.9)
BOOK_REC = dict(emb=16, batch=32, lr=5e-3, passes=3, drop=0.6)
# card against CPU, 3 steps from one state (f32): costs within 1e-5
# relative, parameters within 1e-5 of their largest or 1% of the learning
# rate a step (tests/test_torch_book.py's bounds: Adam divides a gradient
# near 0 by its own magnitude)
BOOK_LOSS_TOL = 1e-5
BOOK_PARAM_TOL = 1e-5
BOOK_ADAM_SHARE = 1e-2


def build_sentiment_program(ptt, vocab, emb, hidden, stacked, max_len, stacked_op=False,
                            lr=SENT_LR, **_):
    """The book's stacked_lstm_net through the port's front end, in the
    per-layer build or (stacked_op) as the one stacked_lstm op. Returns
    (main, startup, loss, accuracy)."""
    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        words = ptt.layers.data("words", shape=[-1], dtype=np.int32, lod_level=1,
                                append_batch_size=False)
        label = ptt.layers.data("label", shape=[1], dtype=np.int32)
        logits = ptt.models.stacked_lstm_net(words, vocab_size=vocab, emb_dim=emb,
                                             hid_dim=hidden, stacked_num=stacked,
                                             max_len=max_len, use_stacked_op=stacked_op)
        loss = ptt.layers.mean(ptt.layers.softmax_with_cross_entropy(logits, label))
        acc = ptt.layers.accuracy(logits, label)
        ptt.optimizer.Adam(learning_rate=lr).minimize(loss)
    return main, startup, loss, acc


def stack_roles(prog, stacked):
    """A stacked_lstm_net build's parameters in one order of roles: the
    embedding, fc1's W and b; each layer's LSTM W and b and, after the
    first, its inter-layer fc's W_fc, W_lstm and b; the output fc's two Ws
    and b."""
    ps = [p.name for p in prog.parameters()]
    if not any(p.endswith(".wa0") for p in ps):  # the per-layer build: creation order
        stack, rest = ps[3:5], ps[5:]
        for i in range(stacked - 1):
            stack += rest[5 * i:5 * i + 5]
        return ps[:3] + stack + rest[5 * (stacked - 1):]
    get = lambda suffix: next(p for p in ps if p.endswith(suffix))  # noqa: E731
    stack = [get(".w0"), get(".b0")]
    for i in range(stacked - 1):
        stack += [get(f".wa{i}"), get(f".wb{i}"), get(f".fb{i}"), get(f".w{i + 1}"),
                  get(f".b{i + 1}")]
    rest = [p for p in ps if p not in stack]
    return rest[:3] + stack + rest[3:]


def sentiment_feed(ptt, rng, batch, max_len, vocab, min_len, **_):
    """`batch` reviews of min_len..max_len tokens (the first of max_len) in
    one capacity of batch·max_len, and binary labels."""
    lens = rng.randint(min_len, max_len + 1, size=batch)
    lens[0] = max_len
    seqs = [rng.randint(0, vocab, (n,)).astype(np.int32) for n in lens]
    return {"words": ptt.LoDArray.from_sequences(seqs, capacity=batch * max_len,
                                                 max_seqs=batch),
            "label": rng.randint(0, 2, (batch, 1)).astype(np.int32)}


def sentiment_forms(ptt, state, feed, seed):
    """The per-layer build and the stacked op from one state (mapped by
    role), two Adam steps each on `feed`, in f32 and bf16: returns
    {amp: (per-layer losses, stacked-op losses)}."""
    sb = SENT_BENCH
    out = {}
    for amp in (None, "bfloat16"):
        losses = {}
        for stacked in (False, True):
            main_p, startup, loss, _ = build_sentiment_program(ptt, **sb, stacked_op=stacked)
            main_p.set_amp(amp)
            names = dict(zip(stack_roles(main_p, sb["stacked"]), state["roles"]))
            scope = ptt.Scope()
            exe = ptt.Executor()
            exe.run(startup, scope=scope, seed=seed)  # the optimizer's state
            for name, role in names.items():
                scope.set(name, state[role].clone())
            losses[stacked] = [float(exe.run(main_p, feed, [loss.name], scope=scope)[0])
                               for _ in range(2)]
        out[amp] = (losses[False], losses[True])
    return out


def sentiment_phases(ptt, smi, seed, first_phase):
    """Phases first_phase..+3: understand_sentiment's stacked_lstm_net at
    full width in bf16: startup and a warm-up step in both builds, B1 and
    B2 against plain, three timed steps, then its window. Returns
    (the paths' readings, the LSTM kernels' largest errors)."""
    from paddle_tpu_torch.ops import lstm_kernels as lk

    sb = SENT_BENCH
    n = first_phase
    phase(n, f"understand_sentiment's stacked_lstm_net at full width (vocab {sb['vocab']}, emb "
             f"{sb['emb']}, hid {sb['hidden']}, {sb['stacked']} layers, B={sb['batch']} ragged "
             f"reviews of {sb['min_len']}-{sb['max_len']} tokens, bf16, Adam({SENT_LR})), built "
             "by the port's front end: startup, a warm-up step, and the stacked_lstm op against "
             "the per-layer build")
    gc.collect()
    torch.cuda.empty_cache()
    rng = np.random.RandomState(seed + 70)
    main_p, startup, loss, acc = build_sentiment_program(ptt, **sb)
    main_p.set_amp("bfloat16")
    ops = [o.type for o in main_p.global_block().ops]
    print(f"  main program: {len(ops)} ops ({ops.count('dynamic_lstm')} dynamic_lstm, "
          f"{ops.count('sum')} sum, {ops.count('sequence_pool')} sequence_pool (max), "
          f"{ops.count('adam')} adam)")
    exe = ptt.Executor()
    scope = ptt.Scope()
    exe.run(startup, scope=scope, seed=seed)
    state = {p.name: scope.get(p.name).clone() for p in main_p.parameters()}
    state["roles"] = stack_roles(main_p, sb["stacked"])
    n_values = sum(scope.get(p.name).numel() for p in main_p.parameters())
    print(f"  startup: {len(main_p.parameters())} parameters with {n_values} values")
    feed = sentiment_feed(ptt, rng, **sb)
    tokens = int(feed["words"].lengths.sum())
    calls, restore = record_calls(lk, {"lstm_fwd": "all", "lstm_bwd": "all"})
    try:
        t0 = time.perf_counter()
        losses = [float(exe.run(main_p, feed, [loss.name], scope=scope)[0])]
        torch.cuda.synchronize()
    finally:
        restore()
    print(f"  warm-up step: loss {losses[0]:.6f}, {time.perf_counter() - t0:.3f} s; {tokens} "
          f"valid tokens of {sb['batch'] * sb['max_len']}; recorded {len(calls['lstm_fwd'])} "
          f"lstm_fwd and {len(calls['lstm_bwd'])} lstm_bwd calls")
    check(len(calls["lstm_fwd"]) == 3 and len(calls["lstm_bwd"]) == 3,
          "the warm-up step did not run 3 lstm_fwd and 3 lstm_bwd")
    forms = sentiment_forms(ptt, state, feed, seed)
    reading = {"tokens_per_step": tokens, "forms": {}}
    for amp, (per, one) in forms.items():
        diff = max(abs(a - b) / abs(a) for a, b in zip(per, one))
        reading["forms"][amp or "float32"] = dict(per_layer=per, stacked_op=one, rel_diff=diff)
        print(f"  {amp or 'f32'}: losses of 2 steps, per-layer build {per}, stacked_lstm op "
              f"{one}: {diff:.3e} apart relative (tests/test_stacked_lstm.py:65 holds the JAX "
              f"op to rtol {SENT_FORMS_TOL['rtol']:g}, atol {SENT_FORMS_TOL['atol']:g}"
              f"{', held here' if amp is None else '; not held in bf16'})")
        check(all(np.isfinite(per + one)), "a form's loss is not finite")
        if amp is None:
            check(np.allclose(one, per, **SENT_FORMS_TOL),
                  "the stacked_lstm op and the per-layer build differ in f32")

    n += 1
    phase(n, "B1 and B2 against plain on the sentiment step (its own ragged inputs of each "
             "layer, then seeded inputs at its shapes)")
    max_errs = {}
    for i, ((a, _), (ba, bk)) in enumerate(zip(calls["lstm_fwd"], calls["lstm_bwd"][::-1])):
        x, mask, w = a
        label = f"sentiment layer {i + 1} T={x.shape[0]} B={x.shape[1]} H={w.shape[0]}"
        for dt in (torch.bfloat16, torch.float32):
            fx, fw = x.to(dt), w.to(dt)
            lstm_check(lk, "lstm_fwd", (fx, mask, fw), False, label, max_errs, hold_share=False)
            bargs = tuple(t.to(dt) if t.is_floating_point() else t for t in ba)
            lstm_check(lk, "lstm_bwd", bargs, False, label, max_errs, hold_share=False)
            if i == 0 and dt == torch.bfloat16:
                k_ms = cuda_ms(lambda: lk.lstm_fwd(fx, mask, fw), 10)
                p_ms = cuda_ms(lambda: lk.lstm_fwd_plain(fx, mask, fw), 2)
                b_ms, b_by, _ = lstm_fwd_bound(fx, mask, fw)
                bk_ms = cuda_ms(lambda: lk.lstm_bwd(*bargs), 10)
                bp_ms = cuda_ms(lambda: lk.lstm_bwd_plain(*bargs), 2)
                bb_ms, bb_by, _ = lstm_bwd_bound(bargs)
                lib = cudnn_lstm_ms(fx, mask, fw)
                print(f"    lstm_fwd at the sentiment step's layer 1: kernel {k_ms:.4f} ms, plain "
                      f"{p_ms:.4f}, bound {b_ms:.5f} by {b_by}, cuDNN forward {lib['fwd_ms']:.4f}")
                print(f"    lstm_bwd there: kernel {bk_ms:.4f} ms, plain {bp_ms:.4f}, bound "
                      f"{bb_ms:.5f} by {bb_by}, cuDNN backward {lib['bwd_ms']:.4f}")
                reading["lstm_fwd"] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                                           library_ms=lib["fwd_ms"])
                reading["lstm_bwd"] = dict(ms=bk_ms, plain_ms=bp_ms, bound_ms=bb_ms,
                                           bound_by=bb_by, library_ms=lib["bwd_ms"])
    T_, B_, H_ = sb["max_len"], sb["batch"], sb["hidden"]
    lens = torch.as_tensor(rng.randint(sb["min_len"], T_ + 1, size=B_))
    lens[0] = T_
    smask = (torch.arange(T_)[:, None] < lens[None, :]).cuda()
    for dt in LSTM_TOL:
        x = torch.as_tensor(rng.standard_normal((T_, B_, 4 * H_)), dtype=dt).cuda()
        w = torch.as_tensor(rng.standard_normal((H_, 4 * H_)) / np.sqrt(H_), dtype=dt).cuda()
        tag = f"T={T_} B={B_} H={H_} (seeded, lengths {sb['min_len']}-{T_})"
        _, want, _ = lstm_check(lk, "lstm_fwd", (x, smask, w), False, tag, max_errs)
        gp, cp, hp = lk.lstm_bwd_inputs(x, w, want[0], want[1], False)
        dh, dhT, dcT = ((0.1 * torch.randn(*s_, device="cuda")).to(dt)
                        for s_ in ((T_, B_, H_), (B_, H_), (B_, H_)))
        lstm_check(lk, "lstm_bwd", (gp, cp, hp, dh, smask, w, dhT, dcT), False, tag, max_errs)

    n += 1
    phase(n, "the sentiment step at full width (bf16): 3 timed steps")
    torch.cuda.reset_peak_memory_stats()
    lk.lstm_fwd_launches = lk.lstm_bwd_launches = 0
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        losses.append(float(exe.run(main_p, feed, [loss.name], scope=scope)[0]))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = {"lstm_fwd": lk.lstm_fwd_launches, "lstm_bwd": lk.lstm_bwd_launches}
    print(f"  losses (warm-up, then timed): {losses}; launches in 3 steps {launches}")
    check(all(np.isfinite(losses)), "non-finite loss")
    # Adam's first steps move every weight by about the learning rate, and
    # the max-pooled 2048 + 512 features into the classifier overshoot on
    # one batch: the loss must fall below the first within the 4 steps,
    # not at the last
    check(min(losses[1:]) < losses[0], "the loss did not fall within 4 steps on one batch")
    for k, c in SENT_STEP_LAUNCHES.items():
        check(launches[k] == 3 * c, f"{k} launched {launches[k]} times in 3 steps, not {3 * c}")
    med = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  steps ms {[round(t, 3) for t in times]}; median {med:.3f} ms/step, "
          f"{tokens / med * 1e3:.1f} valid tokens/s; peak device memory {peak:.2f} GiB on {smi}")
    run = lambda: exe.run(main_p, feed, [loss.name], scope=scope)  # noqa: E731
    wall, busy, counts, _, nev = profile_pass(
        run, ["lstm_fwd_tc_kernel", "lstm_bwd_tc_kernel", "dw_product_kernel"])
    print(f"  profiled step: wall {wall:.3f} ms, device busy {busy:.3f} ms "
          f"({100 * busy / wall:.1f}%), {nev} device events; kernels {counts}")
    check(counts["lstm_fwd_tc_kernel"] == 3 and counts["lstm_bwd_tc_kernel"] == 3,
          f"the profiled step shows {counts}, not 3 lstm_fwd_tc_kernel and 3 lstm_bwd_tc_kernel")
    busy_bd, kinds = breakdown(run, med, "step", SENT_KERNEL_KINDS)
    lstm_us = sum(us for k, us in kinds.items() if k.startswith(("B1", "B2")))
    if busy_bd:
        print(f"  B1 and B2: {lstm_us / 1e3:.3f} ms of the step's {busy_bd / 1e3:.3f} ms device "
              f"time ({100 * lstm_us / busy_bd:.1f}%), the rest {(busy_bd - lstm_us) / 1e3:.3f} ms")
    reading.update(losses=losses, ms_per_step=med, steps_ms=times, tokens_per_s=tokens / med * 1e3,
                   peak_gib=peak, launches_per_step={k: v / 3 for k, v in launches.items()},
                   profiled=dict(wall_ms=wall, busy_ms=busy, busy_share=busy / wall,
                                 kernels_per_step=counts, device_events=nev),
                   device_ms_by_kind={k: us / 1e3 for k, us in kinds.items()})
    del scope, state, calls
    gc.collect()

    batches = [sentiment_feed(ptt, rng, **sb) for _ in range(WINDOW_RAGGED)]

    def build():
        main_w, startup_w, loss_w, _ = build_sentiment_program(ptt, **sb)
        main_w.set_amp("bfloat16")
        return main_w, startup_w, loss_w

    window = window_path_phase(
        ptt, smi, n + 1, "sentiment", f"the sentiment step (B={sb['batch']}, ragged reviews of "
        f"{sb['min_len']}-{sb['max_len']} tokens in one capacity, {sb['stacked']} layers of "
        f"H={sb['hidden']}, bf16)", build, batches, {})[0]
    return {"sentiment": reading, "sentiment_window": window}, max_errs


def book_programs(ptt):
    """tests/book/'s three text programs at their widths: {name: (build,
    learning rate)}, each build returning (main, startup, loss, accuracy
    or None, the feed variables)."""
    from paddle_tpu_torch.data.datasets import imikolov, movielens

    bs, bw, br = BOOK_SENT, BOOK_W2V, BOOK_REC

    def sentiment():
        main, startup, loss, acc = build_sentiment_program(ptt, **bs)
        block = main.global_block()
        return main, startup, loss, acc, [block.var("words"), block.var("label")]

    def word2vec():
        ptt.reset_default_programs()
        main, startup = ptt.Program(), ptt.Program()
        with ptt.program_guard(main, startup):
            words = [ptt.layers.data(f"w{i}", shape=[1], dtype=np.int32)
                     for i in range(bw["n"] - 1)]
            nxt = ptt.layers.data("next", shape=[1], dtype=np.int32)
            logits = ptt.models.word2vec_net(words, len(imikolov.build_dict()),
                                             emb_dim=bw["emb"])
            loss = ptt.layers.mean(ptt.layers.softmax_with_cross_entropy(logits, nxt))
            ptt.optimizer.Adam(learning_rate=bw["lr"]).minimize(loss)
        return main, startup, loss, None, None

    def recommender():
        ml, e = movielens, br["emb"]
        ptt.reset_default_programs()
        main, startup = ptt.Program(), ptt.Program()
        with ptt.program_guard(main, startup):
            d = lambda name: ptt.layers.data(name, shape=[1], dtype=np.int32)  # noqa: E731
            seq = lambda name: ptt.layers.data(name, shape=[-1], dtype=np.int32,  # noqa: E731
                                               lod_level=1, append_batch_size=False)
            uid, gender, age, job, mid = d("uid"), d("gender"), d("age"), d("job"), d("mid")
            cats, title = seq("cats"), seq("title")
            emb = ptt.layers.embedding
            feats = [emb(uid, size=[ml.max_user_id() + 1, e], is_sparse=True),
                     emb(gender, size=[2, e // 2]), emb(age, size=[len(ml.age_table), e // 2]),
                     emb(job, size=[ml.max_job_id() + 1, e // 2])]
            usr = ptt.layers.fc(ptt.layers.concat(
                [ptt.layers.reshape(f, (-1, f.shape[-1])) for f in feats], axis=1),
                size=32, act="tanh")
            mov = ptt.layers.fc(ptt.layers.concat([
                ptt.layers.reshape(emb(mid, size=[ml.max_movie_id() + 1, e], is_sparse=True),
                                   (-1, e)),
                ptt.layers.sequence_pool(emb(cats, size=[len(ml.movie_categories()), e // 2]),
                                         "sum"),
                ptt.layers.sequence_pool(emb(title, size=[len(ml.get_movie_title_dict()), e],
                                             is_sparse=True), "average")], axis=1),
                size=32, act="tanh")
            score = ptt.layers.data("score", shape=[1])
            sim = ptt.layers.cos_sim(usr, mov, scale=5.0)
            loss = ptt.layers.mean(ptt.layers.square_error_cost(sim, score))
            ptt.optimizer.Adam(learning_rate=br["lr"]).minimize(loss)
        return main, startup, loss, None, None

    return {"understand_sentiment": (sentiment, bs["lr"]), "word2vec": (word2vec, bw["lr"]),
            "recommender_system": (recommender, br["lr"])}


def book_batches(ptt, name, feed_vars):
    """A pass's feeds of the book program `name`, by its reference test's
    reader (shuffle seeds, batch size, drop_last), as a generator."""
    from paddle_tpu_torch.data import batch, shuffle
    from paddle_tpu_torch.data.datasets import imdb, imikolov, movielens
    from paddle_tpu_torch.data.feeder import DataFeeder

    if name == "understand_sentiment":
        feeder = DataFeeder(feed_vars, bucket=2048, max_seqs=BOOK_SENT["batch"])
        for data in batch(shuffle(imdb.train(), 1000, seed=0), BOOK_SENT["batch"],
                          drop_last=True)():
            yield feeder.feed(data)
    elif name == "word2vec":
        n = BOOK_W2V["n"]
        for data in batch(imikolov.train(imikolov.build_dict(), n), BOOK_W2V["batch"],
                          drop_last=True)():
            arr = np.array(data, np.int32)
            feed = {f"w{i}": arr[:, i:i + 1] for i in range(n - 1)}
            feed["next"] = arr[:, n - 1:]
            yield feed
    else:
        for data in batch(shuffle(movielens.train(), 512, seed=0), BOOK_REC["batch"],
                          drop_last=True)():
            k = len(data)
            col = lambda i: np.array([[d[i]] for d in data], np.int32)  # noqa: E731
            lod = lambda i: ptt.LoDArray.from_sequences(  # noqa: E731
                [np.array(d[i], np.int32) for d in data], bucket=256, max_seqs=k)
            yield {"uid": col(0), "gender": col(1), "age": col(2), "job": col(3),
                   "mid": col(4), "cats": lod(5), "title": lod(6),
                   "score": np.array([[d[7]] for d in data], np.float32)}


def book_text_phase(ptt, smi, seed, n, work):
    """Phase n: tests/book/'s understand_sentiment (hid 32, max_len 128),
    word2vec and recommender_system in f32: 3 steps card against CPU from
    one state, then each trained on the card by its reference test's
    recipe to its threshold, on the loaders' synthetic data."""
    from paddle_tpu_torch.data.datasets import imikolov
    from paddle_tpu_torch.ops import lstm_kernels as lk

    phase(n, "the book's text programs at tests/book/'s widths (f32): understand_sentiment "
             "(hid 32, 2 layers, max_len 128), word2vec and recommender_system: 3 steps card "
             "against CPU from one state, then trained on the card to their reference tests' "
             "thresholds")
    # the reference tests train on the loaders' synthetic data: the fixtures
    # (tests/fixtures/data) hold 4 reviews, 2 sentences and 3 ratings, too
    # few for one batch of any recipe
    home = os.environ.get("PADDLE_TPU_DATA_HOME")
    os.environ["PADDLE_TPU_DATA_HOME"] = os.path.join(work, "no_data")
    out = {}
    try:
        for name, (build, lr) in book_programs(ptt).items():
            main_p, startup, loss, acc, feed_vars = build()
            feeds = list(itertools.islice(book_batches(ptt, name, feed_vars), 3))
            cscope = ptt.Scope()
            ptt.Executor(device="cpu").run(startup, scope=cscope, seed=seed)
            persist = [v.name for v in main_p.persistables()]
            state = ptt.io.state_to_numpy(cscope, persist)
            res = {}
            for dev in ("cpu", CARD):
                sc = ptt.Scope()
                ptt.io.params_from_numpy(sc, state, dev)
                dexe = ptt.Executor(device=dev)
                ls = [float(dexe.run(main_p, f, [loss.name], scope=sc)[0]) for f in feeds]
                res[dev] = (ls, ptt.io.state_to_numpy(sc, [p.name for p in main_p.parameters()]))
            (cl, cs), (gl, gs) = res["cpu"], res[CARD]
            lerr = max(abs(a - b) / abs(a) for a, b in zip(cl, gl))
            perr = max(float(np.abs(gs[p] - w).max()) / max(
                BOOK_PARAM_TOL * float(np.abs(w).max()), BOOK_ADAM_SHARE * 3 * lr)
                for p, w in cs.items())
            print(f"  {name}: 3 steps, losses cpu {cl} card {gl}, rel {lerr:.3e} (tol "
                  f"{BOOK_LOSS_TOL:g}); parameters at {perr:.3f} of their bound")
            check(lerr <= BOOK_LOSS_TOL and perr <= 1.0, f"{name}: card and CPU differ")

            exe = ptt.Executor()
            scope = ptt.Scope()
            exe.run(startup, scope=scope, seed=seed)
            lk.lstm_fwd_launches = lk.lstm_bwd_launches = 0
            torch.cuda.reset_peak_memory_stats()
            fetch = [loss.name] + ([acc.name] if acc is not None else [])
            t0 = time.perf_counter()
            costs, accs = [], []
            if name == "understand_sentiment":
                while len(costs) < BOOK_SENT["steps"]:
                    for feed in book_batches(ptt, name, feed_vars):
                        c, a = exe.run(main_p, feed, fetch, scope=scope)
                        costs.append(float(c))
                        accs.append(float(a))
                        if len(costs) == BOOK_SENT["steps"]:
                            break
                metric = float(np.mean(accs[-BOOK_SENT["last"]:]))
                met = bool(metric > BOOK_SENT["acc"])
                want = f"accuracy over the last {BOOK_SENT['last']} steps above {BOOK_SENT['acc']}"
            else:
                passes = BOOK_W2V["passes"] if name == "word2vec" else BOOK_REC["passes"]
                for _ in range(passes):
                    for feed in book_batches(ptt, name, feed_vars):
                        costs.append(float(exe.run(main_p, feed, fetch, scope=scope)[0]))
                if name == "word2vec":
                    bound = np.log(len(imikolov.build_dict())) * BOOK_W2V["perplexity"]
                    metric = costs[-1]
                    met = bool(costs[-1] < costs[0] * BOOK_W2V["drop"] and costs[-1] < bound)
                    want = (f"the last cost below {BOOK_W2V['drop']} of the first "
                            f"({costs[0]:.4f}) and below {bound:.4f}")
                else:
                    k = max(1, len(costs) // 5)
                    metric = float(np.mean(costs[-k:]) / np.mean(costs[:k]))
                    met = bool(metric < BOOK_REC["drop"])
                    want = (f"the last fifth's mean cost below {BOOK_REC['drop']} of the "
                            f"first fifth's")
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            steps = len(costs)
            launches = {"lstm_fwd": lk.lstm_fwd_launches / steps,
                        "lstm_bwd": lk.lstm_bwd_launches / steps}
            print(f"  {name} on the card: {steps} steps in {secs:.2f} s "
                  f"({secs / steps * 1e3:.3f} ms a step, host-bound eager steps), reading "
                  f"{metric:.4f}: {want}; peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB"
                  + (f"; B1, B2 launches a step {launches}" if acc is not None else ""))
            check(met, f"{name} did not reach its threshold on the card: {metric}")
            if name == "understand_sentiment":
                check(launches == {"lstm_fwd": 2, "lstm_bwd": 2},
                      f"the book's sentiment step launched {launches}, not 2 + 2")
            out[name] = dict(card_vs_cpu=dict(loss_rel=lerr, param_share_of_bound=perr),
                             steps=steps, seconds=secs, reading=metric, threshold_met=met,
                             **({"launches_per_step": launches} if acc is not None else {}))
    finally:
        if home is None:
            os.environ.pop("PADDLE_TPU_DATA_HOME")
        else:
            os.environ["PADDLE_TPU_DATA_HOME"] = home
    return out


# ------------------------------------ the rest of the book (A1b): phases 46-49 --
# label_semantic_roles (tests/book/test_label_semantic_roles.py's db_lstm) at
# the reference book's widths, bf16 (phases 46-47), and at the book test's
# in f32 (phase 49): B ragged conll05 sentences of 6-19 words, max_len 20
SRL_BENCH = dict(word_dim=32, hidden=512, batch=128, lr=0.01, max_len=20)
SRL_BOOK = dict(word_dim=16, hidden=32, batch=16, lr=0.01, max_len=20, steps=320, drop=0.5,
                f1=0.7, test_batches=4)
SRL_FEATS = ("word", "ctx_n2", "ctx_n1", "ctx_0", "ctx_p1", "ctx_p2", "pred", "mark")
SRL_STEP_LAUNCHES = {"gru_fwd": 2, "gru_bwd": 2}
# B3 and B4 in f32 at the book test's H=32, seeded: (T, B, H)
SRL_F32_SHAPE = (20, 16, 32)
# image_classification at the reference book's widths (phase 48), bf16, and
# tests/book/test_image_classification.py's recipe in f32 (phase 49)
IMG_BENCH = dict(batch=128, lr=1e-3, resnet=32, vgg=16)
IMG_BOOK = dict(batch=32, lr=1e-3, resnet=20, vgg=11, passes=3, steps=25, drop=0.9, acc=0.2)
# vgg's dropout probability; its keep share is held within 4 sigma
DROPOUT_P = 0.5
# the book's programs card against CPU, 3 steps from one state (f32): the
# first loss within 1e-5 relative; the first step's gradients (Adam's
# first moments) within 1e-4 relative L2; label_semantic_roles's later
# losses and parameters as phase 45's. The image programs' gradient is
# ill-conditioned (BN's backward cancels: on the CPU resnet_cifar10(20)'s
# f32 gradient at B=32 lies 9.3e-4 from its float64 one, and moves 1.5e-3
# when the images move by one part in 1e7), and Adam moves an element
# whose gradient lies near 0 by about lr either way: so their later
# losses, gradients and updates (relative L2) are held within
# BOOK_NUDGE_FACTOR times the CPU's own distance under that nudge, and
# never tighter than the fixed bounds (updates 5e-2)
BOOK_GRAD_REL_L2 = 1e-4
BOOK_UPDATE_REL_L2 = 5e-2
BOOK_NUDGE = 1e-7
BOOK_NUDGE_FACTOR = 4.0


def build_srl_program(ptt, word_dim, hidden, lr, max_len, **_):
    """The book's db_lstm + CRF through the port's front end: (main,
    startup, loss, the decoded tags, the emission, the feed variables)."""
    from paddle_tpu_torch.data.datasets import conll05

    word_dict, verb_dict, label_dict = conll05.get_dict()
    L = ptt.layers
    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    startup.random_seed = 5
    with ptt.program_guard(main, startup):
        feats = [L.data(name, [-1], np.int32, lod_level=1, append_batch_size=False)
                 for name in SRL_FEATS]
        label = L.data("label", [-1], np.int32, lod_level=1, append_batch_size=False)
        embs = [L.embedding(w, size=[len(word_dict), word_dim], param_attr="srl_word_emb")
                for w in feats[:6]]
        embs.append(L.embedding(feats[6], size=[len(verb_dict), word_dim]))
        embs.append(L.embedding(feats[7], size=[2, word_dim]))
        h0 = L.fc(embs, size=hidden, act="tanh")
        fwd = L.dynamic_gru(L.fc(h0, size=3 * hidden, bias_attr=False), size=hidden,
                            max_len=max_len)
        bwd = L.dynamic_gru(L.fc(h0, size=3 * hidden, bias_attr=False), size=hidden,
                            is_reverse=True, max_len=max_len)
        emission = L.fc(L.sequence_concat([fwd, bwd]), size=len(label_dict))
        loss = L.mean(L.linear_chain_crf(emission, label, param_attr="srl_crf_w",
                                         max_len=max_len))
        decoded = L.crf_decoding(emission, param_attr="srl_crf_w", max_len=max_len)
        ptt.optimizer.Adam(learning_rate=lr).minimize(loss)
    return main, startup, loss, decoded, emission, feats + [label]


def srl_feeds(ptt, feed_vars, batch, n, split="train"):
    """The first n batches of conll05's `split` (passes repeated as the
    book's reader does): [(feed, the samples)]."""
    from paddle_tpu_torch.data import batch as rbatch
    from paddle_tpu_torch.data.datasets import conll05
    from paddle_tpu_torch.data.feeder import DataFeeder

    feeder = DataFeeder(feed_vars, bucket=512, max_seqs=batch)
    out = []
    while len(out) < n:
        for data in rbatch(getattr(conll05, split)(), batch, drop_last=True)():
            out.append((feeder.feed(data), data))
            if len(out) == n:
                break
    return out


def gru_pair_check(rk, fwd_calls, bwd_calls, what, max_errs, timed):
    """B3 and B4 against gru_fwd_plain and gru_bwd_plain on recorded calls,
    in bf16 and f32 (phase 7's bounds), their outputs the same bits in two
    runs; where `timed`, the bf16 kernel's, the plain version's and the
    bound's times on the first call of each. Returns those readings."""
    rows = {}
    for i, (a, k) in enumerate(fwd_calls):
        rev = k.get("reverse", False)
        for dt in (torch.bfloat16, torch.float32):
            x, mask, w = a[0].to(dt), a[1], a[2].to(dt)
            got = rk.gru_fwd(x, mask, w, reverse=rev)
            want = rk.gru_fwd_plain(x, mask, w, reverse=rev)
            torch.cuda.synchronize()
            err, differing = kernel_error(got, want, dt)
            same_bits(rk.gru_fwd(x, mask, w, reverse=rev), got, "gru_fwd")
            line = (f"  gru_fwd T={x.shape[0]} B={x.shape[1]} H={w.shape[0]} {str(dt)[6:]} "
                    f"{'rev' if rev else 'fwd'} ({what}): max_abs_err={err:.3e} (tol {TOL[dt]:g}), "
                    f"h_seq differing {differing:.4%}, the same bits in two runs")
            if timed and i == 0 and dt == torch.bfloat16:
                k_ms = cuda_ms(lambda: rk.gru_fwd(x, mask, w), 10)
                p_ms = cuda_ms(lambda: rk.gru_fwd_plain(x, mask, w), 2)
                b_ms, b_by, _, _ = bound(x, mask, w, *got)
                line += (f"; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.5f} ms "
                         f"by {b_by}")
                rows["gru_fwd"] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)
            print(line)
            max_errs["gru_fwd"] = max(max_errs.get("gru_fwd", 0.0), err)
    for i, (a, k) in enumerate(bwd_calls):
        rev = k.get("reverse", False)
        for dt in (torch.bfloat16, torch.float32):
            ins = [t.to(dt) if t.is_floating_point() else t for t in a]
            got = rk.gru_bwd(*ins, reverse=rev)
            want = rk.gru_bwd_plain(*ins, reverse=rev)
            torch.cuda.synchronize()
            scales = term_scales("gru_bwd", ins, want)
            abs_errs, errs = zip(*(rel_err(g, w_, sc) for g, w_, sc in zip(got, want, scales)))
            differing = float((got[0] != want[0]).float().mean())
            same_bits(rk.gru_bwd(*ins, reverse=rev), got, "gru_bwd")
            T_, B_, H_ = ins[2].shape
            line = (f"  gru_bwd T={T_} B={B_} H={H_} {str(dt)[6:]} {'rev' if rev else 'fwd'} "
                    f"({what}): rel err dx {errs[0]:.3e} dW {errs[1]:.3e} (tol {TRAIN_TOL[dt]:g}), "
                    f"dx differing {differing:.4%}, the same bits in two runs")
            check(all(torch.isfinite(t.float()).all() for t in got), "non-finite gru_bwd output")
            check(max(errs) <= TRAIN_TOL[dt], f"gru_bwd disagrees with its plain version ({what})")
            check(dt != torch.bfloat16 or differing <= BF16_MAX_DIFFERING_DX,
                  f"gru_bwd's dx differs in {differing:.4%} (max {BF16_MAX_DIFFERING_DX:.0%})")
            if timed and i == 0 and dt == torch.bfloat16:
                k_ms = cuda_ms(lambda: rk.gru_bwd(*ins, reverse=rev), 10)
                p_ms = cuda_ms(lambda: rk.gru_bwd_plain(*ins, reverse=rev), 2)
                b_ms, b_by, _ = gru_bwd_bound(ins)
                line += (f"; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.5f} ms "
                         f"by {b_by}")
                rows["gru_bwd"] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)
            print(line)
            max_errs["gru_bwd"] = max(max_errs.get("gru_bwd", 0.0), *abs_errs)
    return rows


def srl_phases(ptt, smi, seed, first_phase):
    """Phases first_phase..+1: label_semantic_roles at the reference book's
    widths in bf16: startup, a warm-up step, B3 and B4 against plain on its
    inputs; then 3 timed steps, the CRF's share, and the for-test clone's
    decoding. Returns (the path's readings, the GRU kernels' largest
    errors)."""
    from paddle_tpu_torch.core import registry as treg
    from paddle_tpu_torch.ops import crf_ops
    from paddle_tpu_torch.ops import rnn_kernels as rk

    sb = SRL_BENCH
    n = first_phase
    phase(n, f"label_semantic_roles at the reference book's widths (word_dim {sb['word_dim']}, "
             f"hidden {sb['hidden']}, B={sb['batch']} ragged conll05 sentences, bf16, "
             f"Adam({sb['lr']})), built by the port's front end: startup, a warm-up step, then "
             "B3 and B4 against plain on its own inputs")
    gc.collect()
    torch.cuda.empty_cache()
    main_p, startup, loss, decoded, emission, feed_vars = build_srl_program(ptt, **sb)
    main_p.set_amp("bfloat16")
    test_p = main_p.clone(for_test=True)
    ops = [o.type for o in main_p.global_block().ops]
    print(f"  main program: {len(ops)} ops ({ops.count('lookup_table')} lookup_table, "
          f"{ops.count('dynamic_gru')} dynamic_gru, {ops.count('linear_chain_crf')} "
          f"linear_chain_crf, {ops.count('crf_decoding')} crf_decoding, {ops.count('adam')} "
          f"adam); the for-test clone {len(test_p.global_block().ops)} ops")
    exe = ptt.Executor()
    scope = ptt.Scope()
    exe.run(startup, scope=scope, seed=seed)
    n_values = sum(scope.get(p.name).numel() for p in main_p.parameters())
    feed, data = srl_feeds(ptt, feed_vars, sb["batch"], 1)[0]
    tokens = sum(len(d[0]) for d in data)
    calls, restore = record_calls(rk, {"gru_fwd": "all", "gru_bwd": "all"})
    crf_calls, crf_restore = record_ops(treg, ("linear_chain_crf",))
    try:
        t0 = time.perf_counter()
        losses = [float(exe.run(main_p, feed, [loss.name], scope=scope)[0])]
        torch.cuda.synchronize()
    finally:
        restore()
        crf_restore()
    print(f"  startup: {len(main_p.parameters())} parameters with {n_values} values; warm-up "
          f"step: loss {losses[0]:.6f}, {time.perf_counter() - t0:.3f} s; {tokens} valid tokens "
          f"of {sb['batch']} sentences; recorded {len(calls['gru_fwd'])} gru_fwd and "
          f"{len(calls['gru_bwd'])} gru_bwd calls")
    check(len(calls["gru_fwd"]) == 2 and len(calls["gru_bwd"]) == 2,
          "the warm-up step did not run 2 gru_fwd and 2 gru_bwd")
    check(sorted(k.get("reverse", False) for _, k in calls["gru_fwd"]) == [False, True],
          "the SRL step's GRUs are not one forward and one reversed")
    print_plan(rk, "gru_fwd", sb["batch"], sb["hidden"], "the SRL step")
    max_errs = {}
    rows = gru_pair_check(rk, calls["gru_fwd"], calls["gru_bwd"], "the SRL step's", max_errs,
                          timed=True)
    T_, B_, H_ = SRL_F32_SHAPE
    rng = np.random.RandomState(seed + 80)
    fwd_seeded, bwd_seeded = [], []
    for rev in (False, True):
        mask = gru_edge_mask(rng, T_, B_, False)
        x = torch.as_tensor(rng.standard_normal((T_, B_, 3 * H_)), dtype=torch.float32).cuda()
        w = torch.as_tensor(rng.standard_normal((H_, 3 * H_)) / np.sqrt(H_),
                            dtype=torch.float32).cuda()
        fwd_seeded.append(((x, mask, w), {"reverse": rev}))
        h_seq, _ = rk.gru_fwd_plain(x, mask, w, rev)
        h_prev, ur, c, rh = rk.gru_bwd_inputs(x, w, h_seq, rev)
        dh = 0.1 * torch.randn(T_, B_, H_, device=x.device)
        dhT = 0.1 * torch.randn(B_, H_, device=x.device)
        bwd_seeded.append(((ur, c, h_prev, rh, dh, mask, w, dhT), {"reverse": rev}))
    gru_pair_check(rk, fwd_seeded, bwd_seeded, f"the book's H={H_}, seeded", max_errs,
                   timed=False)

    n += 1
    phase(n, "the SRL step at full width (bf16): 3 timed steps, the CRF's share, then "
             "crf_decoding on the for-test clone")
    torch.cuda.reset_peak_memory_stats()
    rk.gru_fwd_launches = rk.gru_bwd_launches = 0
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        losses.append(float(exe.run(main_p, feed, [loss.name], scope=scope)[0]))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = {"gru_fwd": rk.gru_fwd_launches, "gru_bwd": rk.gru_bwd_launches}
    print(f"  losses (warm-up, then timed): {losses}; launches in 3 steps {launches}")
    check(all(np.isfinite(losses)), "non-finite SRL loss")
    for k, c in SRL_STEP_LAUNCHES.items():
        check(launches[k] == 3 * c, f"{k} launched {launches[k]} times in 3 steps, not {3 * c}")
    med = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  steps ms {[round(t, 3) for t in times]}; median {med:.3f} ms/step, "
          f"{tokens / med * 1e3:.1f} valid tokens/s; peak device memory {peak:.2f} GiB on {smi}")
    run = lambda: exe.run(main_p, feed, [loss.name], scope=scope)  # noqa: E731
    wall, busy, counts, _, nev = profile_pass(run, ["gru_fwd_tc_kernel", "gru_bwd_tc_kernel"])
    print(f"  profiled step: wall {wall:.3f} ms, device busy {busy:.3f} ms "
          f"({100 * busy / wall:.1f}%), {nev} device events; kernels {counts}")
    check(counts == {"gru_fwd_tc_kernel": 2, "gru_bwd_tc_kernel": 2},
          f"the profiled SRL step shows {counts}, not 2 gru_fwd_tc_kernel and 2 gru_bwd_tc_kernel")
    # the CRF alone, forward and its gradient, on the step's own inputs
    op, ins = crf_calls["linear_chain_crf"][0]
    em, lbl = ins[op.inputs["Emission"][0]], ins[op.inputs["Label"][0]]
    trans = ins[op.inputs["Transition"][0]]

    def crf_step():
        e = em.data.detach().requires_grad_(True)
        t = trans.detach().requires_grad_(True)
        nll = crf_ops.crf_nll(em.with_data(e), lbl, t, max_len=op.attrs["max_len"])
        torch.autograd.grad(nll.mean(), [e, t])

    crf_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        crf_step()
    torch.cuda.synchronize()
    crf_ms = (time.perf_counter() - t0) * 1e3 / 5
    cwall, cbusy, _, _, cnev = profile_pass(crf_step, [])
    print(f"  the CRF alone (linear_chain_crf and its gradient, T={op.attrs['max_len']}, an "
          f"eager loop): {crf_ms:.3f} ms of host time ({100 * crf_ms / med:.1f}% of the "
          f"step's {med:.3f}), {cbusy:.3f} ms of device time ({100 * cbusy / busy:.1f}% of the "
          f"step's {busy:.3f}), {cnev} device events (the step's {nev})")
    em_out, dec = exe.run(test_p, feed, [emission.name, decoded.name], scope=scope,
                          return_numpy=False)
    tags, mask = crf_ops.crf_viterbi(em_out.to("cpu"), scope.get("srl_crf_w").cpu(),
                                     max_len=sb["max_len"])
    want = ptt.LoDArray.from_batch(tags[..., None], mask, em_out.to("cpu")).data
    check(torch.equal(dec.data.cpu(), want),
          "crf_decoding on the card differs from the CPU's Viterbi on the card's emissions")
    cscope = ptt.Scope()
    ptt.io.params_from_numpy(cscope, ptt.io.state_to_numpy(
        scope, [v.name for v in test_p.persistables() if scope.has(v.name)]), "cpu")
    (cdec,) = ptt.Executor(device="cpu").run(test_p, feed, [decoded.name], scope=cscope,
                                             return_numpy=False)
    valid = cdec.token_mask
    agree = float((cdec.data[valid] == dec.data.cpu()[valid]).float().mean())
    print(f"  crf_decoding on the for-test clone: the card's {int(valid.sum())} tags equal the "
          f"CPU's Viterbi on the card's emissions; the clone run on the CPU from the card's "
          f"state (bf16 GEMMs summed in other orders) gives the same tag for {agree:.4%}")
    reading = dict(tokens_per_step=tokens, losses=losses, ms_per_step=med, steps_ms=times,
                   tokens_per_s=tokens / med * 1e3, peak_gib=peak,
                   launches_per_step={k: v / 3 for k, v in launches.items()},
                   profiled=dict(wall_ms=wall, busy_ms=busy, busy_share=busy / wall,
                                 kernels_per_step=counts, device_events=nev),
                   crf=dict(host_ms=crf_ms, host_share=crf_ms / med, device_ms=cbusy,
                            device_share=cbusy / busy, device_events=cnev),
                   decode_cpu_agree=agree, kernels=rows)
    del scope, calls, crf_calls
    gc.collect()
    return reading, max_errs


def image_program(ptt, model, depth, lr):
    """tests/book/test_image_classification.py's program around
    models.<model>(depth): (main, startup, loss, accuracy)."""
    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        img = ptt.layers.data("img", shape=[3, 32, 32])
        label = ptt.layers.data("label", shape=[1], dtype=np.int32)
        logits = getattr(ptt.models, model)(img, class_dim=10, depth=depth)
        loss = ptt.layers.mean(ptt.layers.softmax_with_cross_entropy(logits, label))
        acc = ptt.layers.accuracy(ptt.layers.softmax(logits), label)
        ptt.optimizer.Adam(learning_rate=lr).minimize(loss)
    return main, startup, loss, acc


def image_feed(rng, batch):
    return {"img": rng.rand(batch, 3, 32, 32).astype(np.float32),
            "label": rng.randint(0, 10, (batch, 1)).astype(np.int32)}


def image_phase(ptt, smi, seed, n):
    """Phase n: resnet_cifar10(32) and vgg(16) at B=128 in bf16, 3 timed
    steps each; vgg's dropout keep share; then vgg's window against its
    per-step loop (phase n + 1's lines, window_path_phase)."""
    from paddle_tpu_torch.core import registry as treg

    ib = IMG_BENCH
    phase(n, f"image_classification at the reference book's widths: resnet_cifar10({ib['resnet']}) "
             f"and vgg({ib['vgg']}) at B={ib['batch']}, 3x32x32, Adam({ib['lr']}), bf16: 3 timed "
             "steps each, then vgg's dropout on the card")
    rng = np.random.RandomState(seed + 90)
    feed = image_feed(rng, ib["batch"])
    out = {}
    for model in ("resnet_cifar10", "vgg"):
        gc.collect()
        torch.cuda.empty_cache()
        main_p, startup, loss, _ = image_program(ptt, model, ib["resnet" if model != "vgg"
                                                             else "vgg"], ib["lr"])
        main_p.set_amp("bfloat16")
        exe, scope = ptt.Executor(), ptt.Scope()
        exe.run(startup, scope=scope, seed=seed)
        n_values = sum(scope.get(p.name).numel() for p in main_p.parameters())
        drops, restore = record_ops(treg, ("dropout",) if model == "vgg" else (), outputs=True)
        try:
            t0 = time.perf_counter()
            losses = [float(exe.run(main_p, feed, [loss.name], scope=scope)[0])]
            torch.cuda.synchronize()
        finally:
            restore()
        warm_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            losses.append(float(exe.run(main_p, feed, [loss.name], scope=scope)[0]))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        check(all(np.isfinite(losses)), f"{model}: non-finite loss")
        med = statistics.median(times)
        peak = torch.cuda.max_memory_allocated() / 2**30
        wall, busy, _, _, nev = profile_pass(
            lambda: exe.run(main_p, feed, [loss.name], scope=scope), [])
        print(f"  {model}: {len(main_p.parameters())} parameters with {n_values} values; warm-up "
              f"{warm_s:.3f} s; losses {losses}; steps ms {[round(t, 3) for t in times]}, median "
              f"{med:.3f} ms, {ib['batch'] / med * 1e3:.1f} images/s; profiled step wall "
              f"{wall:.3f} ms, busy {busy:.3f} ms ({100 * busy / wall:.1f}%), {nev} device "
              f"events; peak {peak:.2f} GiB on {smi}")
        out[model] = dict(losses=losses, ms_per_step=med, steps_ms=times,
                          images_per_s=ib["batch"] / med * 1e3, peak_gib=peak,
                          profiled=dict(wall_ms=wall, busy_ms=busy, busy_share=busy / wall,
                                        device_events=nev))
        if model == "vgg":
            drops = drops["dropout"]
            check(len(drops) == 2, f"vgg's step ran {len(drops)} dropout ops, not 2")
            kept, nonzero = 0, 0
            for op, vals in drops:  # the warm-up step's own draws
                x, y = vals[op.inputs["X"][0]], vals[op.outputs["Out"][0]]
                live = x != 0
                kept += int((y != 0)[live].sum())
                nonzero += int(live.sum())
            share = kept / nonzero
            sigma = math.sqrt(DROPOUT_P * (1 - DROPOUT_P) / nonzero)
            print(f"  vgg's dropout on the card: kept {kept} of {nonzero} nonzero inputs "
                  f"({share:.5f}; 1 - p = {1 - DROPOUT_P}, sigma {sigma:.5f})")
            check(abs(share - (1 - DROPOUT_P)) <= 4 * sigma,
                  f"vgg's dropout kept {share:.5f}, beyond 4 sigma of {1 - DROPOUT_P}")
            out[model]["dropout_keep_share"] = share
        del scope, exe
    return out


def vgg_window_phase(ptt, smi, seed, n):
    """Phase n (its second half): vgg(16) at B=128 through the Trainer,
    per-step against scan_window=4, from one state and one seed."""
    ib = IMG_BENCH
    rng = np.random.RandomState(seed + 91)
    batches = [image_feed(rng, ib["batch"]) for _ in range(WINDOW_RAGGED)]

    def build():
        main_w, startup_w, loss_w, _ = image_program(ptt, "vgg", ib["vgg"], ib["lr"])
        main_w.set_amp("bfloat16")
        main_w.random_seed = seed + 7  # each step's masks: the same draws in both loops
        return main_w, startup_w, loss_w

    return window_path_phase(ptt, smi, n, "vgg", f"vgg({ib['vgg']}) at B={ib['batch']} (bf16, "
                             "two train-mode dropouts drawn from the step's generator)", build,
                             batches, {})[0]


def _one_mask_dropout(treg, nn_ops, masks):
    """The port's dropout kernel replaced by one applying a host mask a
    dropout op (by its output's name; drawn from a seeded RandomState on
    first use) through dropout_apply: CPU and CUDA generators draw
    different streams. Returns the restore."""
    orig = treg._KERNELS["dropout"]

    def kernel(ctx):
        x = ctx.input("X")
        name = ctx.op.outputs["Out"][0]
        if name not in masks:
            masks[name] = np.random.RandomState(len(masks) + 1).rand(*x.shape) >= DROPOUT_P
        ctx.set_output("Out", nn_ops.dropout_apply(x, torch.as_tensor(masks[name],
                                                                       device=x.device)))

    treg._KERNELS["dropout"] = kernel
    return lambda: treg._KERNELS.update({"dropout": orig})


def book_card_vs_cpu(ptt, main_p, startup, loss, feeds, seed, lr, nudge):
    """3 steps card against CPU from one state (f32): losses, the first
    step's gradients (Adam's first moments) and the parameters. With
    `nudge` (the image programs: BN's backward cancels, so their gradient
    is ill-conditioned) the CPU also runs the images moved by one part in
    1e7 (BOOK_NUDGE), and the card is held to the CPU within
    BOOK_NUDGE_FACTOR times that run's distance from the CPU's (and never
    closer than the fixed bounds). Returns (ok, the readings)."""
    cscope = ptt.Scope()
    ptt.Executor(device="cpu").run(startup, scope=cscope, seed=seed)
    persist = [v.name for v in main_p.persistables() if cscope.has(v.name)]
    state = ptt.io.state_to_numpy(cscope, persist)
    rng = np.random.RandomState(seed + 5)
    nudged = [dict(f, img=(f["img"] * (1 + BOOK_NUDGE * rng.standard_normal(f["img"].shape)))
                   .astype(np.float32)) for f in feeds] if nudge else None
    res = {}
    for run, dev, fs in (("cpu", "cpu", feeds), ("nudged", "cpu", nudged), ("card", CARD, feeds)):
        if fs is None:
            continue
        sc = ptt.Scope()
        ptt.io.params_from_numpy(sc, state, dev)
        dexe = ptt.Executor(device=dev)
        ls, grads = [], None
        for i, f in enumerate(fs):
            ls.append(float(dexe.run(main_p, f, [loss.name], scope=sc)[0]))
            if i == 0:
                grads = ptt.io.state_to_numpy(sc, [p for p in persist if ".moment1." in p])
        res[run] = (ls, grads, ptt.io.state_to_numpy(sc, [p.name for p in main_p.parameters()]))
    rel = lambda a, b: float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))  # noqa: E731

    def apart(run):
        (cl, cg, cp), (ol, og, op_) = res["cpu"], res[run]
        return (abs(ol[0] - cl[0]) / abs(cl[0]),
                max(abs(a - b) / abs(b) for a, b in zip(ol[1:], cl[1:])),
                max(rel(og[k], v) for k, v in cg.items()),
                max(rel(op_[k] - state[k], v - state[k]) for k, v in cp.items()),
                max(float(np.abs(op_[k] - w).max()) / max(BOOK_PARAM_TOL * float(np.abs(w).max()),
                                                          BOOK_ADAM_SHARE * 3 * lr)
                    for k, w in cp.items()))

    card = apart("card")
    names = ("first loss", "later losses", "first gradients", "updates", "parameters")
    if nudge:
        noise = apart("nudged")
        tol = (BOOK_LOSS_TOL, max(BOOK_LOSS_TOL, BOOK_NUDGE_FACTOR * noise[1]),
               max(BOOK_GRAD_REL_L2, BOOK_NUDGE_FACTOR * noise[2]),
               max(BOOK_UPDATE_REL_L2, BOOK_NUDGE_FACTOR * noise[3]), None)
        print(f"    the CPU with the images nudged by {BOOK_NUDGE:g}: "
              + ", ".join(f"{k} {v:.3e}" for k, v in zip(names[:4], noise)))
    else:
        noise = None
        tol = (BOOK_LOSS_TOL, BOOK_LOSS_TOL, BOOK_GRAD_REL_L2, None, 1.0)
    print(f"    3 steps card against CPU: losses cpu {res['cpu'][0]} card {res['card'][0]}; "
          + ", ".join(f"{k} {v:.3e} (tol {t:.3g})" for k, v, t in zip(names, card, tol)
                      if t is not None))
    return (all(t is None or v <= t for v, t in zip(card, tol)),
            dict(zip(names, card), tolerances=dict(zip(names, tol)),
                 nudged_cpu=None if noise is None else dict(zip(names, noise))))


def book_image_srl_phase(ptt, smi, seed, n, work):
    """Phase n: tests/book/'s image_classification (resnet_cifar10(20) and
    vgg(11)) and label_semantic_roles in f32: 3 steps card against CPU
    from one state, then each trained on the card to its reference test's
    threshold."""
    from paddle_tpu_torch.core import registry as treg
    from paddle_tpu_torch.data import batch, map_readers, shuffle
    from paddle_tpu_torch.data import image as pimg
    from paddle_tpu_torch.data.datasets import cifar
    from paddle_tpu_torch.evaluator import ChunkEvaluator
    from paddle_tpu_torch.ops import nn_ops
    from paddle_tpu_torch.ops import rnn_kernels as rk

    ib, sb = IMG_BOOK, SRL_BOOK
    phase(n, f"the book's image_classification (resnet_cifar10({ib['resnet']}), vgg({ib['vgg']}), "
             f"B={ib['batch']}, {ib['passes']} passes x {ib['steps']} steps with _augment) and "
             f"label_semantic_roles (word_dim {sb['word_dim']}, H={sb['hidden']}, B={sb['batch']}, "
             f"{sb['steps']} steps) in f32: 3 steps card against CPU from one state, then trained "
             "on the card to their reference tests' thresholds")
    home = os.environ.get("PADDLE_TPU_DATA_HOME")
    os.environ["PADDLE_TPU_DATA_HOME"] = os.path.join(work, "no_data")  # synthetic cifar
    counter = [0]

    def augment(sample):  # tests/book/test_image_classification.py's _augment
        im, label = sample
        counter[0] += 1
        hwc = np.asarray(im, np.float32).reshape(3, 32, 32).transpose(1, 2, 0)
        return pimg.simple_transform(hwc, resize_size=36, crop_size=32, is_train=True,
                                     rng=np.random.RandomState(counter[0])), label

    def image_batches():
        reader = batch(map_readers(augment, shuffle(cifar.train10(), 256, seed=0)),
                       ib["batch"], drop_last=True)
        for _ in range(ib["passes"]):
            for step, data in enumerate(reader()):
                if step >= ib["steps"]:
                    break
                yield {"img": np.stack([d[0] for d in data]).reshape(-1, 3, 32, 32),
                       "label": np.array([[d[1]] for d in data], np.int32)}

    out = {}
    try:
        for model in ("resnet_cifar10", "vgg"):
            main_p, startup, loss, acc = image_program(ptt, model, ib["resnet" if model != "vgg"
                                                                   else "vgg"], ib["lr"])
            print(f"  {model}({ib['resnet' if model != 'vgg' else 'vgg']}):")
            counter[0] = 0
            feeds = list(itertools.islice(image_batches(), 3))
            restore = _one_mask_dropout(treg, nn_ops, {})
            try:
                ok, cvc = book_card_vs_cpu(ptt, main_p, startup, loss, feeds, seed, ib["lr"],
                                           nudge=True)
            finally:
                restore()
            check(ok, f"{model}: card and CPU differ")
            exe, scope = ptt.Executor(), ptt.Scope()
            exe.run(startup, scope=scope, seed=seed)
            counter[0] = 0
            losses, accs = [], []
            t0 = time.perf_counter()
            for f in image_batches():
                c, a = exe.run(main_p, f, [loss.name, acc.name], scope=scope)
                losses.append(float(c))
                accs.append(float(a))
            secs = time.perf_counter() - t0
            k = max(1, len(accs) // 4)
            first, last, acc_last = (float(np.mean(losses[:k])), float(np.mean(losses[-k:])),
                                     float(np.mean(accs[-k:])))
            met = bool(last < first * ib["drop"] and acc_last > ib["acc"])
            print(f"    on the card: {len(losses)} steps in {secs:.2f} s "
                  f"({secs / len(losses) * 1e3:.3f} ms a step with the host's augmentation); mean loss of the first and last "
                  f"{k} {first:.4f} -> {last:.4f} (below {ib['drop']} of the first), accuracy of "
                  f"the last {k} {acc_last:.4f} (above {ib['acc']})")
            check(met, f"{model} did not reach the book's thresholds on the card")
            out[model] = dict(card_vs_cpu=cvc, steps=len(losses), seconds=secs,
                              first_loss=first, last_loss=last, last_acc=acc_last,
                              threshold_met=met)
            del scope, exe

        print(f"  label_semantic_roles (word_dim {sb['word_dim']}, H={sb['hidden']}):")
        main_p, startup, loss, decoded, _, feed_vars = build_srl_program(ptt, **sb)
        test_p = main_p.clone(for_test=True)
        train = srl_feeds(ptt, feed_vars, sb["batch"], sb["steps"])
        ok, cvc = book_card_vs_cpu(ptt, main_p, startup, loss, [f for f, _ in train[:3]], seed,
                                   sb["lr"], nudge=False)
        check(ok, "label_semantic_roles: card and CPU differ")
        exe, scope = ptt.Executor(), ptt.Scope()
        exe.run(startup, scope=scope, seed=seed)
        rk.gru_fwd_launches = rk.gru_bwd_launches = 0
        t0 = time.perf_counter()
        costs = [float(exe.run(main_p, f, [loss.name], scope=scope)[0]) for f, _ in train]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {"gru_fwd": rk.gru_fwd_launches / len(costs),
                    "gru_bwd": rk.gru_bwd_launches / len(costs)}
        chunk = ChunkEvaluator(num_chunk_types=4, chunk_scheme="iob")
        for f, data in srl_feeds(ptt, feed_vars, sb["batch"], sb["test_batches"], "test"):
            (dec,) = exe.run(test_p, f, [decoded.name], scope=scope, return_numpy=False)
            pred = dec.data.cpu().numpy()[:, 0]
            offs = np.concatenate([[0], np.cumsum(dec.lengths.cpu().numpy())])
            chunk.update([pred[offs[i]:offs[i + 1]] for i in range(len(data))],
                         [np.asarray(row[-1]) for row in data])
        precision, recall, f1 = chunk.eval()
        first, last = float(np.mean(costs[:5])), float(np.mean(costs[-5:]))
        met = bool(last < sb["drop"] * first and f1 > sb["f1"])
        print(f"    on the card: {len(costs)} steps in {secs:.2f} s "
              f"({secs / len(costs) * 1e3:.3f} ms a step, host-bound eager steps); mean cost of the first and last 5 {first:.4f} "
              f"-> {last:.4f} (below {sb['drop']} of the first); chunk F1 {f1:.4f} (p "
              f"{precision:.4f}, r {recall:.4f}; above {sb['f1']}); B3, B4 launches a step "
              f"{launches}")
        check(met, f"label_semantic_roles did not reach the book's thresholds: {last}, {f1}")
        check(launches == {"gru_fwd": 2, "gru_bwd": 2},
              f"the book's SRL step launched {launches}, not 2 + 2")
        out["label_semantic_roles"] = dict(card_vs_cpu=cvc, steps=len(costs), seconds=secs,
                                           first_cost=first, last_cost=last, chunk_f1=f1,
                                           threshold_met=met, launches_per_step=launches)
    finally:
        if home is None:
            os.environ.pop("PADDLE_TPU_DATA_HOME")
        else:
            os.environ["PADDLE_TPU_DATA_HOME"] = home
    return out


# ------------------------------- serving (A4b, A8a, A8b, A8c): phases 50-55 --
# phase 50: phase 28's int8 transformer artifact behind the HTTP server: 4
# clients post 12 /predict requests of these rows in turn, 1024 tokens each
SERVE_ROWS = (1, 2, 3, 5, 8)
SERVE_REQUESTS = 12
SERVE_CLIENTS = 4
SERVE_MAX_BATCH = 8  # MicroBatcher(max_batch_size=8), buckets 1, 2, 4, 8
HTTP_TIMEOUT = 600  # seconds, every client's bound
# phase 51: bench.py run_serving_gen (bench.py:1108-1188) at its widths
SGEN = dict(beams=4, max_len=32, slots=8, requests=48, hidden=3072)
SGEN_BONUS, SGEN_BETA = 10.0, 1.0  # the chain's control logits
POOL_SYNC_STEPS = 10  # pool steps run under torch.cuda.set_sync_debug_mode('warn')
# phase 52: bench.py run_serving_gen_v3 (bench.py:1280-1530): its target
# (ctx 16 -> 3 x fc 4096 tanh -> fc 256 tanh, the prefix; K=2) and its
# draft (the chain control alone), draft_k 4, on its shared-prefix trace
SGEN3 = dict(beams=2, max_len=32, slots=8, requests=48, prefix_hidden=4096, ctx_mem=256,
             ctx=16, draft_k=4)
SGEN3_TRACE = dict(duration_s=30.0, seed=17, base_rps=4.0, diurnal_amplitude=0.3,
                   flash_crowds=(), shared_prefix_fraction=0.6, prefix_groups=3)
SGEN3_CACHE_MB = 8.0
# the int8 cache pass's scores against v2 mode's: the bound
# tests/test_gen_v3.py:162 holds (bench.py:1530 asserts only 0.5)
INT8_HIT_SCORE_BOUND = 0.05
# phase 54: the disaggregated fleet's streamed requests come from this many
# clients; int8 handoffs hold the ids, their scores within this
DISAGG_CLIENTS = 8
DISAGG_INT8_SCORE_TOL = 0.05
SERVE_START_S = 300  # seconds for a spawned fleet to come up
# phase 55: the replica fleet under a SIGKILL (seconds of load before the
# kill and after the standby's admission)
FLEET = dict(clients=16, before_s=3.0, after_s=3.0)
# phase 53: tests/test_gen_serving.py:47-71's decoder, f32, card against
# CPU: ids exact; scores within 1e-5, f32 GEMMs summed in other orders
TGEN = dict(V=12, E=8, H=16, K=3, T=6)
TGEN_SCORE_TOL = 1e-5


# B12 where a tile's last output chunks store nothing (N % 256 != 0, M %
# 128 != 0, one k-stage): the float64 plain version's bits in each of
# QMM_CHUNK_REPS runs. A chunk whose store was skipped committed no bulk
# group, so the next chunk's staging could overwrite a buffer still being
# stored (ROADMAP.md C5, fixed in csrc/quant_matmul.cu).
QMM_CHUNK_EDGE = [(m, k, n) for m in (80, 128) for k in (64, 256) for n in (24, 64, 128, 1000)]
QMM_CHUNK_REPS = 20


def qmm_chunk_check(qk, seed):
    """B12 on the wgmma route at QMM_CHUNK_EDGE, each QMM_CHUNK_REPS times
    against the plain version (launches not counted)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    bad = []
    for M, K, N in QMM_CHUNK_EDGE:
        a = torch.randint(-127, 128, (M, K), dtype=torch.int8, device="cuda", generator=gen)
        b = torch.randint(-127, 128, (K, N), dtype=torch.int8, device="cuda", generator=gen)
        want = qk.quant_matmul_plain(a, b)
        runs = [qmm_on(qk, qk.WGMMA, a, b) for _ in range(QMM_CHUNK_REPS)]
        torch.cuda.synchronize()
        wrong = sum(not torch.equal(r, want) for r in runs)
        if wrong:
            bad.append(((M, K, N), wrong))
    print(f"  B12 (wgmma route) at the {len(QMM_CHUNK_EDGE)} shapes whose tiles end in chunks "
          f"that store nothing, {QMM_CHUNK_REPS} runs each against plain: "
          f"{'every run the same bits' if not bad else f'runs that differ {bad}'}")
    check(not bad, f"B12 differs from its plain version (runs that differ by shape): {bad}")


def post_json(url, payload, timeout=HTTP_TIMEOUT):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def get_json(url):
    with urllib.request.urlopen(url, timeout=HTTP_TIMEOUT) as r:
        return json.load(r)


def parse_exposition(text):
    """The samples of a Prometheus text exposition; fails on a line that is
    neither a comment nor `name{labels} value`."""
    samples = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = re.fullmatch(r"([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})? (\S+)", line)
        check(m is not None, f"/metrics line does not parse: {line!r}")
        samples[m.group(1) + (m.group(2) or "")] = float(m.group(3))
    return samples


def pct(xs, q):
    return float(np.percentile(np.asarray(xs, np.float64), q))


def int8_serve_phase(ptt, smi, seed, n, q_dir):
    """Phase 39: phase 28's int8 artifact served over HTTP; returns the
    path's readings."""
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.ops import flash_kernels as fk
    from paddle_tpu_torch.ops import quant_kernels as qk

    phase(n, "the int8 transformer LM (phase 28's artifact, not quantized again) served over "
          f"HTTP in bf16: ServingEngine(quantize='int8'), MicroBatcher(max_batch_size="
          f"{SERVE_MAX_BATCH}), make_server on 127.0.0.1; {SERVE_CLIENTS} clients post "
          f"{SERVE_REQUESTS} /predict requests of {SERVE_ROWS} rows x {QTFM['seqlen']} tokens")
    qmm_chunk_check(qk, seed + 39)
    reg = serving.ModelRegistry()
    t0 = time.perf_counter()
    eng, batcher = reg.add("lm", model_dir=q_dir, quantize="int8",
                           policy=serving.BucketPolicy(max_batch_size=SERVE_MAX_BATCH),
                           max_batch_size=SERVE_MAX_BATCH, max_wait_ms=50.0, max_queue=64,
                           timeout_ms=HTTP_TIMEOUT * 1e3)
    eng.program.set_amp("bfloat16")
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    warmed = eng.warmup()
    torch.cuda.synchronize()
    print(f"  loaded (the quant sidecar checked) in {load_s:.2f} s; warmup ran the {warmed} "
          f"batch buckets {eng.policy.batch_buckets} in {time.perf_counter() - t0:.2f} s")
    rng = np.random.RandomState(seed + 39)
    rows = [SERVE_ROWS[i % len(SERVE_ROWS)] for i in range(SERVE_REQUESTS)]
    reqs = [rng.randint(0, QTFM["vocab"], (r, QTFM["seqlen"])).astype(np.int32) for r in rows]
    fetch = eng.fetch_names[0]
    srv = serving.make_server(reg)
    srv.serve_background()
    url = f"http://127.0.0.1:{srv.port}/predict/lm"

    def request(x):
        with post_json(url, {"inputs": {"toks": x.tolist()}, "format": "npz"}) as r:
            return np.load(io.BytesIO(r.read()))[fetch]

    results, lat, errs = {}, {}, []
    todo = queue.Queue()
    for i in range(len(reqs)):
        todo.put(i)

    def client():
        while True:
            try:
                i = todo.get_nowait()
            except queue.Empty:
                return
            t = time.perf_counter()
            try:
                results[i] = request(reqs[i])
                lat[i] = time.perf_counter() - t
            except Exception as e:  # reported below
                errs.append(f"request {i}: {type(e).__name__}: {e}")

    try:
        qk.quant_matmul_launches = fk.flash_fwd_launches = 0
        calls0, coalesced0 = eng.dispatches_total, batcher._batch_hist.count
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client) for _ in range(SERVE_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=HTTP_TIMEOUT)
        wall = time.perf_counter() - t0
        check(not any(t.is_alive() for t in threads), "a client is still waiting")
        check(not errs, f"requests failed: {errs}")
        calls = eng.dispatches_total - calls0
        launches = (qk.quant_matmul_launches, fk.flash_fwd_launches)
        check(launches == (QTFM_SITES * calls, QTFM["layers"] * calls),
              f"{calls} engine calls launched quant_matmul and flash_fwd {launches} times")
        check(calls < SERVE_REQUESTS, f"the batcher coalesced nothing: {calls} engine calls")
        check(eng.compiled_programs() <= len(eng.policy.batch_buckets),
              f"{eng.compiled_programs()} bucket signatures ran")
        check(batcher._batch_hist.count - coalesced0 == calls, "batch histogram")
        buckets = eng.compiled_programs()
        served_rows = sum(rows)
        ms = [lat[i] * 1e3 for i in range(len(reqs))]
        print(f"  {SERVE_REQUESTS} requests ({served_rows} rows) in {wall:.3f} s: "
              f"{served_rows / wall:.2f} rows/s; latency p50 {pct(ms, 50):.1f} ms, p99 "
              f"{pct(ms, 99):.1f} ms (the npz reply of [n, {QTFM['seqlen']}, {QTFM['vocab']}] f32 "
              f"logits included); {calls} engine calls (coalesced), {buckets} bucket signatures "
              f"(of {len(eng.policy.batch_buckets)}); launches quant_matmul {launches[0]} = "
              f"{QTFM_SITES} x {calls}, flash_fwd {launches[1]} = {QTFM['layers']} x {calls}")
        qk.quant_matmul_launches = fk.flash_fwd_launches = 0
        request(reqs[0])
        per_request = (qk.quant_matmul_launches, fk.flash_fwd_launches)
        check(per_request == (QTFM_SITES, QTFM["layers"]),
              f"one request launched quant_matmul and flash_fwd {per_request} times")
        print(f"  one request alone: quant_matmul {per_request[0]}, flash_fwd {per_request[1]} "
              f"launches (the wrappers' counters)")
        health = get_json(url.replace("/predict/lm", "/healthz"))
        check(health["status"] == "ok" and health["versions"]["lm"] == eng.fingerprint,
              f"/healthz {health['status']} {health['versions']}")
        stats = get_json(url.replace("/predict/lm", "/stats"))["lm"]
        check(stats["quant"]["mode"] == "int8", "/stats quant block")
        with urllib.request.urlopen(url.replace("/predict/lm", "/metrics"),
                                    timeout=HTTP_TIMEOUT) as r:
            samples = parse_exposition(r.read().decode())
        check(samples.get("ptserving_dispatches_total") == eng.dispatches_total
              and "ptserving_engine_run_seconds_count" in samples,
              "/metrics lacks the engine's families")
        print(f"  /healthz {health['status']} (load: {health['load']['dispatches_total']} "
              f"dispatches, {health['load']['syncs_total']} syncs), /stats hit rate "
              f"{stats['hit_rate']:.3f}, /metrics {len(samples)} samples, each line parsed")
        big = [i for i, r in enumerate(rows) if r == SERVE_MAX_BATCH]
        busy, _ = breakdown(lambda: request(reqs[big[0]]), statistics.median(ms[i] for i in big),
                            f"served request ({SERVE_MAX_BATCH} rows over HTTP)",
                            kinds=QTFM_KERNEL_KINDS)
    finally:
        srv.shutdown()
        reg.stop()
        srv.server_close()
    # every answer against the engine's exact-shape path on the card, bits:
    # each op of the int8 LM is row-independent, B12's int8 products exact
    differ = []
    for i, x in enumerate(reqs):
        want = eng.predict({"toks": x}, bucketed=False)[0]
        check(results[i].shape == want.shape == (rows[i], QTFM["seqlen"], QTFM["vocab"]),
              f"request {i}: logits {results[i].shape}")
        if not np.array_equal(results[i], want):
            differ.append((i, float(np.abs(results[i] - want).max())))
    check(all(np.isfinite(r).all() for r in results.values()), "non-finite logits")
    print(f"  every answer against predict(bucketed=False) on the card: "
          f"{'the same bits' if not differ else f'differ {differ}'}")
    check(not differ, f"served logits differ from the exact-shape path: {differ}")
    del results
    return {"requests": SERVE_REQUESTS, "rows": served_rows, "wall_s": wall,
            "rows_per_s": served_rows / wall, "latency_ms_p50": pct(ms, 50),
            "latency_ms_p99": pct(ms, 99), "engine_calls": calls,
            "bucket_signatures": buckets,
            "quant_matmul_launches_per_request": per_request[0],
            "flash_fwd_launches_per_request": per_request[1],
            "busy_us_profiled_request": busy, "bits_equal_exact_shape": not differ,
            "device": smi}


def chain_ctl(V, K):
    """bench.py's handcrafted control logits: token v chains to v+1 at the
    bonus, EOS at beta * (v - thr), K staggered tracks."""
    w = np.full((V + 1, V), -30.0, np.float32)
    w[:, 0] = -60.0
    for v in range(2, V - 1):
        for j in range(K):
            w[v, min(v + 1 + j, V - 1)] = SGEN_BONUS - j
        w[v, 1] = SGEN_BETA * v
    for j in range(K):
        w[0, 2 + j] = SGEN_BONUS - j
    w[V - 1, 1] = SGEN_BONUS + 5.0
    w[V, :] = 0.0
    w[V, 1] = -SGEN_BETA
    return w


def build_serving_gen(ptt, beams, max_len, hidden):
    """bench.py run_serving_gen's decoder through the port's front end:
    (main, startup, outputs, V)."""
    V = max_len + 8
    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        thr = ptt.layers.data("thr", shape=[-1, 1], append_batch_size=False)
        gen = ptt.layers.BeamSearchDecoder(beam_size=beams, max_len=max_len, bos_id=0, eos_id=1)
        with gen.step():
            prev = gen.prev_ids()
            thr_m = gen.memory(init=thr)
            emb = ptt.layers.embedding(prev, size=[V, V], param_attr="sg_emb")
            ctl = ptt.layers.fc(ptt.layers.concat([emb, thr_m], axis=1), size=V,
                                param_attr="sg_ctl", bias_attr=False)
            bal = ptt.layers.fc(
                ptt.layers.fc(ptt.layers.fc(emb, size=hidden, act="tanh", param_attr="sg_b1",
                                            bias_attr=False),
                              size=hidden, act="tanh", param_attr="sg_bm", bias_attr=False),
                size=V, param_attr="sg_b2", bias_attr=False)
            gen.update_memory(thr_m, thr_m)
            gen.output_logits(ptt.layers.elementwise_add(ctl, ptt.layers.scale(bal, 1e-30)))
        outs = gen()
    return main, startup, outs, V


def drain(h, t0):
    """A handle's events: (outputs of row 0, first-token seconds from t0)."""
    first = out = None
    for ev in h.events(timeout=HTTP_TIMEOUT):
        if ev["event"] == "token" and first is None:
            first = time.perf_counter() - t0
        check(ev["event"] != "error", f"generation failed: {ev}")
        if ev["event"] == "done":
            o = ev["outputs"]
            out = (o["ids"][0], o["scores"][0], o["lengths"][0])
    return out, first


def same_outputs(a, b):
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def serving_gen_phase(ptt, smi, seed, n, work):
    """Phase 51: bench.py's serving_gen, batch mode against continuous
    mode; returns the path's readings."""
    from paddle_tpu_torch import serving

    K, T, S, N, Hd = (SGEN[k] for k in ("beams", "max_len", "slots", "requests", "hidden"))
    phase(n, f"bench.py's serving_gen at its widths (K={K}, T={T}, {S} slots, {N} requests, "
          f"hidden {Hd}, f32): batch mode through engine.predict in FIFO groups of {S}, then "
          "continuous mode through ContinuousScheduler.submit, the pool step a CUDA graph")
    main, startup, outs, V = build_serving_gen(ptt, K, T, Hd)
    scope = ptt.Scope()
    ptt.Executor().run(startup, scope=scope, seed=seed + 40)
    ptt.io.params_from_numpy(scope, {"sg_emb": np.eye(V, dtype=np.float32),
                                     "sg_ctl": chain_ctl(V, K)}, "cuda")
    d = os.path.join(work, "serving_gen")
    ptt.io.save_inference_model(d, ["thr"], list(outs), main_program=main, scope=scope)
    rng = np.random.RandomState(7)
    lens = np.clip(np.round(np.exp(rng.normal(np.log(T * 0.4), 0.45, size=N))), 4, T - 4)
    thrs = (lens - (SGEN_BONUS / SGEN_BETA + 1.0)).astype(np.float32)[:, None]
    reg = serving.ModelRegistry()
    engine = serving.ServingEngine(d, policy=serving.BucketPolicy(max_batch_size=S),
                                   model_name="serving_gen", metrics=reg.metrics)
    reg.add("serving_gen", engine=engine,
            scheduler_kw=dict(max_slots=S, max_queue=N + 8, timeout_ms=HTTP_TIMEOUT * 1e3))
    sched = engine.scheduler()
    pool_warm0 = time.perf_counter()
    engine.warmup()
    warm_s = time.perf_counter() - pool_warm0
    pool = sched._pool
    check(pool is not None and pool.captures == 1, "warmup did not capture the pool step")
    pool_gib = graph_pool_gib(pool.graph)
    print(f"  warmup (the 4 batch buckets, then the pool sized from the generation sidecar, "
          f"its step run once and captured) {warm_s:.2f} s; the capture {pool.capture_s:.3f} s, "
          f"its graph's pool "
          f"{'not measured' if pool_gib is None else f'{pool_gib * 2**30:.0f} bytes'}")

    def batch_mode():
        res, first = [], []
        t0 = time.perf_counter()
        for i in range(0, N, S):
            out = engine.predict({"thr": thrs[i:i + S]})
            done = time.perf_counter() - t0
            for r in range(len(thrs[i:i + S])):
                res.append((out[0][r], out[1][r], out[2][r]))
                first.append(done)  # no streaming: a token shows when its batch drains
        return time.perf_counter() - t0, res, first

    def continuous():
        t0 = time.perf_counter()
        hs = [sched.submit({"thr": thrs[i:i + 1]}, timeout_ms=HTTP_TIMEOUT * 1e3)
              for i in range(N)]
        res, first = zip(*(drain(h, t0) for h in hs))
        return time.perf_counter() - t0, list(res), list(first)

    import warnings

    batch_mode()  # untimed: every bucket and the pool warm
    sched.generate({"thr": thrs[:1]}, timeout_ms=HTTP_TIMEOUT * 1e3)
    steps0, occ0, syncs0 = sched.steps_total, sched._occupancy_steps, sched.syncs_total
    replays0, prefixes0 = pool.replays, sched.prefixes_total
    bt, bout, bft = batch_mode()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ct, cout, cft = continuous()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    steps = sched.steps_total - steps0
    occupancy = (sched._occupancy_steps - occ0) / (steps * S)
    same = [same_outputs(b, c) for b, c in zip(bout, cout)]
    print(f"  continuous against batch mode, all {N} requests: "
          f"{sum(same)} of {N} equal in ids, scores and lengths (the pool and the batch bucket "
          f"run S*K = {S * K} rows)")
    check(all(same), f"continuous answers differ from batch mode at requests "
                     f"{[i for i, s in enumerate(same) if not s]}")
    check(pool.captures == 1 and pool.replays - replays0 == steps,
          f"{pool.captures} captures, {pool.replays - replays0} replays over {steps} pool steps")
    check(sched.syncs_total - syncs0 == steps, "host syncs a pool step != 1")
    flagged = len(caught)
    true_toks = int(sum(int(o[2][0]) for o in bout))
    print(f"  continuous run: {steps} pool steps, each a replay of the one capture and one "
          f"counted host sync; torch's sync debug mode reported {flagged} synchronizing calls "
          f"over the run's {steps} steps and {sched.prefixes_total - prefixes0} admissions")
    # the pool step's own syncs, counted alone: POOL_SYNC_STEPS steps
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for _ in range(POOL_SYNC_STEPS):
                with engine._lock, torch.no_grad():
                    pool.step()
                    sched._packed.to("cpu", copy=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(len(caught) == POOL_SYNC_STEPS,
          f"{len(caught)} synchronizing calls in {POOL_SYNC_STEPS} pool steps: "
          f"{sorted({str(w.message).splitlines()[0] for w in caught})[:3]}")
    print(f"  {POOL_SYNC_STEPS} pool steps alone under set_sync_debug_mode('warn'): "
          f"{len(caught)} synchronizing calls, the packed readback's")
    host_ms = []
    for _ in range(20):
        t0 = time.perf_counter()
        pool.graph.replay()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
    launch_ms = []
    for _ in range(20):
        t0 = time.perf_counter()
        pool.graph.replay()
        launch_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    dev_ms = cuda_ms(pool.graph.replay, 50)
    _, busy_ms, _, _, events = profile_pass(pool.graph.replay, ())
    eff_b, eff_c = true_toks / bt, true_toks / ct
    res = {"requests": N, "true_tokens": true_toks,
           "batch": {"effective_tok_per_s": eff_b, "wall_s": bt,
                     "first_token_s_p50": pct(bft, 50), "first_token_s_p99": pct(bft, 99)},
           "continuous": {"effective_tok_per_s": eff_c, "wall_s": ct,
                          "first_token_s_p50": pct(cft, 50), "first_token_s_p99": pct(cft, 99),
                          "slot_occupancy": occupancy, "pool_steps": steps,
                          "sync_debug_calls": flagged},
           "speedup_vs_batch_mode": eff_c / eff_b, "bits_equal_batch_mode": all(same),
           "pool_step": {"captures": pool.captures, "capture_s": pool.capture_s,
                         "graph_pool_bytes": None if pool_gib is None else pool_gib * 2**30,
                         "replay_ms_host": statistics.median(host_ms),
                         "replay_launch_ms_host": statistics.median(launch_ms),
                         "replay_ms_device": dev_ms, "device_events_a_replay": events,
                         "busy_ms_profiled_replay": busy_ms, "host_syncs_a_step": 1},
           "device": smi}
    print(f"  effective tokens/s: batch {eff_b:.1f} ({bt:.3f} s), continuous {eff_c:.1f} "
          f"({ct:.3f} s), {eff_c / eff_b:.3f}x; first token p50/p99: batch "
          f"{pct(bft, 50) * 1e3:.1f}/{pct(bft, 99) * 1e3:.1f} ms, continuous "
          f"{pct(cft, 50) * 1e3:.1f}/{pct(cft, 99) * 1e3:.1f} ms; slot occupancy "
          f"{occupancy:.3f} ({true_toks} true tokens, mean length {lens.mean():.2f})")
    print(f"  the pool step: replay {statistics.median(host_ms):.4f} ms on the host with its "
          f"synchronize ({statistics.median(launch_ms):.4f} ms to launch), {dev_ms:.4f} ms on "
          f"the device (CUDA events, 50 replays); {events} device events in one profiled replay "
          f"(busy {busy_ms:.4f} ms)")
    # one streamed /generate over HTTP against the batch-mode answer
    srv = serving.make_server(reg)
    srv.serve_background()
    try:
        with post_json(f"http://127.0.0.1:{srv.port}/generate/serving_gen",
                       {"inputs": {"thr": thrs[:1].tolist()}, "stream": True,
                        "timeout_ms": HTTP_TIMEOUT * 1e3}) as r:
            check(r.headers["Content-Type"] == "application/x-ndjson", "not NDJSON")
            events_ = [json.loads(line) for line in r]
    finally:
        srv.shutdown()
        reg.stop()
        srv.server_close()
    toks = [e for e in events_ if e["event"] == "token"]
    done = events_[-1]
    check(done["event"] == "done" and len(toks) == len(events_) - 1 and toks, "stream events")
    got = tuple(np.asarray(done["outputs"][k], dt)[0] for k, dt in
                (("ids", np.int32), ("scores", np.float32), ("lengths", np.int32)))
    check(same_outputs(got, bout[0]), "the streamed done event differs from batch mode")
    check([e["step"] for e in toks] == list(range(len(toks))), "token steps")
    print(f"  POST /generate with stream: {len(toks)} NDJSON token events, then a done event "
          "equal to the batch-mode answer")
    res["stream_token_events"] = len(toks)
    return res


def build_serving_gen_v3(ptt, beams, max_len, prefix_hidden, ctx_mem, ctx):
    """bench.py run_serving_gen_v3's target model through the port's front
    end: (main, startup, outputs, V)."""
    V = max_len + 8
    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        c = ptt.layers.data("ctx", shape=[-1, ctx], append_batch_size=False)
        thr = ptt.layers.fc(c, size=1, param_attr="v3_thr", bias_attr=False)
        h = c
        for name in ("v3_p1", "v3_p2", "v3_p3"):
            h = ptt.layers.fc(h, size=prefix_hidden, act="tanh", param_attr=name,
                              bias_attr=False)
        hctx = ptt.layers.fc(h, size=ctx_mem, act="tanh", param_attr="v3_hc", bias_attr=False)
        gen = ptt.layers.BeamSearchDecoder(beam_size=beams, max_len=max_len, bos_id=0, eos_id=1)
        with gen.step():
            prev = gen.prev_ids()
            thr_m = gen.memory(init=thr)
            hctx_m = gen.memory(init=hctx)
            emb = ptt.layers.embedding(prev, size=[V, V], param_attr="v3_emb")
            ctl = ptt.layers.fc(ptt.layers.concat([emb, thr_m], axis=1), size=V,
                                param_attr="v3_ctl", bias_attr=False)
            side = ptt.layers.fc(hctx_m, size=V, param_attr="v3_ho", bias_attr=False)
            gen.update_memory(thr_m, thr_m)
            gen.update_memory(hctx_m, hctx_m)
            gen.output_logits(ptt.layers.elementwise_add(ctl, ptt.layers.scale(side, 1e-30)))
        outs = gen()
    return main, startup, outs, V


def sgen3_events(n_req):
    """The first n_req events of bench.py run_serving_gen_v3's trace
    (bench.py:1424-1432), from the port's fleetctl.traces."""
    from paddle_tpu_torch.fleetctl.traces import TraceSpec, generate_trace, trace_digest

    events = generate_trace(TraceSpec(**SGEN3_TRACE))
    check(len(events) >= n_req, f"the trace has {len(events)} events, fewer than {n_req}")
    return events[:n_req], trace_digest(events[:n_req])


def build_serving_gen_v3_draft(ptt, max_len, ctx):
    """bench.py run_serving_gen_v3's draft (bench.py:1397-1418): the same
    chain control with no prefix MLP, K=2; (main, startup, outputs)."""
    V = max_len + 8
    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        c = ptt.layers.data("ctx", shape=[-1, ctx], append_batch_size=False)
        thr = ptt.layers.fc(c, size=1, param_attr="dg_thr", bias_attr=False)
        gen = ptt.layers.BeamSearchDecoder(beam_size=2, max_len=max_len, bos_id=0, eos_id=1)
        with gen.step():
            prev = gen.prev_ids()
            thr_m = gen.memory(init=thr)
            emb = ptt.layers.embedding(prev, size=[V, V], param_attr="dg_emb")
            gen.update_memory(thr_m, thr_m)
            gen.output_logits(ptt.layers.fc(ptt.layers.concat([emb, thr_m], axis=1), size=V,
                                            param_attr="dg_ctl", bias_attr=False))
        outs = gen()
    return main, startup, outs


def serving_gen_v3_setup(ptt, seed, work):
    """The target and draft artifacts (bench.py's weights) and the trace's
    requests: a dict the v3 and disaggregated phases share."""
    K, T, N, P, Hc, C = (SGEN3[k] for k in ("beams", "max_len", "requests", "prefix_hidden",
                                             "ctx_mem", "ctx"))
    main, startup, outs, V = build_serving_gen_v3(ptt, K, T, P, Hc, C)
    scope = ptt.Scope()
    ptt.Executor().run(startup, scope=scope, seed=seed + 41)
    wrng = np.random.RandomState(5)
    thr_w = np.zeros((C, 1), np.float32)
    thr_w[0, 0] = 1.0  # thr = ctx[:, 0]
    weights = {"v3_thr": thr_w, "v3_emb": np.eye(V, dtype=np.float32), "v3_ctl": chain_ctl(V, K)}
    for name, shp in (("v3_p1", (C, P)), ("v3_p2", (P, P)), ("v3_p3", (P, P)),
                      ("v3_hc", (P, Hc)), ("v3_ho", (Hc, V))):
        weights[name] = (0.05 * wrng.standard_normal(shp)).astype(np.float32)
    ptt.io.params_from_numpy(scope, weights, "cuda")
    d = os.path.join(work, "serving_gen_v3")
    ptt.io.save_inference_model(d, ["ctx"], list(outs), main_program=main, scope=scope)
    dmain, dstartup, douts = build_serving_gen_v3_draft(ptt, T, C)
    dscope = ptt.Scope()
    ptt.Executor().run(dstartup, scope=dscope, seed=seed + 43)
    ptt.io.params_from_numpy(dscope, {"dg_thr": thr_w, "dg_emb": np.eye(V, dtype=np.float32),
                                      "dg_ctl": chain_ctl(V, 2)}, "cuda")
    draft = os.path.join(work, "serving_gen_v3_draft")
    ptt.io.save_inference_model(draft, ["ctx"], list(douts), main_program=dmain, scope=dscope)
    events, digest = sgen3_events(N)
    rng = np.random.RandomState(7)
    group_ctx = {}
    for g in range(SGEN3_TRACE["prefix_groups"]):
        row = rng.normal(0.0, 1.0, C).astype(np.float32)
        row[0] = (8.0 + 7.0 * g) - (SGEN_BONUS / SGEN_BETA + 1.5)  # half-integer margins
        group_ctx[g] = row
    ctxs, hit_class, seen = [], [], set()
    for ev in events:
        g = ev.get("prefix_group")
        if g is None:
            L = float(np.clip(np.round(np.exp(rng.normal(np.log(T * 0.4), 0.45))), 6, T - 6))
            row = rng.normal(0.0, 1.0, C).astype(np.float32)
            row[0] = L - (SGEN_BONUS / SGEN_BETA + 1.5)
            hit_class.append(False)
        else:
            row = group_ctx[g]
            hit_class.append(g in seen)
            seen.add(g)
        ctxs.append(row)
    hits = [i for i, h in enumerate(hit_class) if h]
    check(len(hits) >= 8, f"degenerate trace: {len(hits)} hits")
    warm = rng.normal(0.0, 1.0, (1, C)).astype(np.float32)
    warm[0, 0] = 12.0 - (SGEN_BONUS / SGEN_BETA + 1.5)  # not in the trace
    return {"dir": d, "draft": draft, "ctxs": np.stack(ctxs), "hits": hits,
            "misses": [i for i, h in enumerate(hit_class) if not h], "warm": warm,
            "digest": digest}


def serving_gen_v3_phase(ptt, smi, n, v3):
    """Phase 52: bench.py's serving_gen_v3, its three passes over one
    engine; returns the path's readings."""
    from paddle_tpu_torch import serving

    K, T, S, N, P, Hc, D = (SGEN3[k] for k in ("beams", "max_len", "slots", "requests",
                                                 "prefix_hidden", "ctx_mem", "draft_k"))
    phase(n, f"bench.py's serving_gen_v3 (K={K}, T={T}, {S} slots, {N} requests of its "
          f"shared-prefix trace, prefix hidden {P}, context memory {Hc}, draft_k {D}, f32): v2 "
          f"mode, then the fp prefix cache with the draft, then the int8 cache with the draft; "
          f"each closed loop, then open loop")
    ctxs, hits, misses = v3["ctxs"], v3["hits"], v3["misses"]
    engine = serving.ServingEngine(v3["dir"], policy=serving.BucketPolicy(max_batch_size=S),
                                   model_name="serving_gen_v3")

    def run_pass(mb, quant, draft):
        sched = serving.ContinuousScheduler(
            engine, max_slots=S, max_queue=N + 8, timeout_ms=HTTP_TIMEOUT * 1e3,
            prefix_cache_mb=mb, prefix_cache_quant=quant, draft_model=draft, draft_k=D).start()
        try:
            sched.warmup()
            sched.generate({"ctx": v3["warm"]}, timeout_ms=HTTP_TIMEOUT * 1e3)
            closed, firsts = [], []
            for i in range(N):  # closed loop: one request in flight
                t0 = time.perf_counter()
                out, first = drain(sched.submit({"ctx": ctxs[i:i + 1]},
                                                timeout_ms=HTTP_TIMEOUT * 1e3), t0)
                closed.append(out)
                firsts.append(first)
            t0 = time.perf_counter()  # open loop: every request at once
            hs = [sched.submit({"ctx": ctxs[i:i + 1]}, timeout_ms=HTTP_TIMEOUT * 1e3)
                  for i in range(N)]
            opened = [drain(h, t0)[0] for h in hs]
            wall = time.perf_counter() - t0
            # the target's cached state a key, dequantized: the logits barely
            # read the context memory, so the answers alone cannot hold it
            entries = {} if not mb else {
                key: tuple(x.cpu() for part in sched._cached_rows(
                    pay["t"], sched._mem_specs, sched._pe_specs) for x in part)
                for key, (pay, _) in sched._pcache._entries.items()}
            return closed, opened, firsts, wall, sched.stats(), sched.syncs_total, entries
        finally:
            sched.stop()

    passes = {"v2_mode": run_pass(0.0, None, None),
              "fp_cached": run_pass(SGEN3_CACHE_MB, None, v3["draft"]),
              "int8_cached": run_pass(SGEN3_CACHE_MB, "int8", v3["draft"])}
    a, b, c = passes["v2_mode"], passes["fp_cached"], passes["int8_cached"]
    for loop, i in (("closed", 0), ("open", 1)):
        same = [same_outputs(x, y) for x, y in zip(a[i], b[i])]
        check(all(same), f"fp_cached with the draft differs from v2 mode ({loop} loop) at "
                         f"{[j for j, s in enumerate(same) if not s]}")
    q_shape = all(np.array_equal(x[0], y[0]) and np.array_equal(x[2], y[2])
                  for x, y in zip(a[0] + a[1], c[0] + c[1]))
    q_delta = max(float(np.abs(x[1] - y[1]).max()) for x, y in zip(a[0] + a[1], c[0] + c[1]))
    check(q_shape and q_delta < INT8_HIT_SCORE_BOUND,
          f"int8_cached: ids/lengths equal {q_shape}, score drift {q_delta}")
    # every int8 entry within half a step (absmax/127 of the row's tensor)
    # of the fp entry of the same key
    fp_ent, q_ent = b[6], c[6]
    check(fp_ent and sorted(fp_ent) == sorted(q_ent),
          f"the cached passes hold {len(fp_ent)} and {len(q_ent)} entries, not the same keys")
    q_steps = 0.0
    for key, rows in fp_ent.items():
        for j, (w, g) in enumerate(zip(rows, q_ent[key])):
            step = max(float(w.float().abs().max()), 1e-30) / 127.0
            err = float((g.float() - w.float()).abs().max()) / step
            check(err <= 0.5 + 1e-4, f"int8_cached: entry state {j} off by {err} steps")
            q_steps = max(q_steps, err)
    true_toks = int(sum(int(o[2][0]) for o in a[0]))
    res = {"requests": N, "hits": len(hits), "trace_digest": v3["digest"], "draft_k": D,
           "true_tokens": true_toks, "device": smi}
    for label, (closed, opened, firsts, wall, st, syncs, _) in passes.items():
        r = {"first_token_s_p50": pct(firsts, 50), "first_token_s_p99": pct(firsts, 99),
             "hit_first_token_s_p50": pct([firsts[i] for i in hits], 50),
             "hit_first_token_s_p99": pct([firsts[i] for i in hits], 99),
             "miss_first_token_s_p50": pct([firsts[i] for i in misses], 50),
             "miss_first_token_s_p99": pct([firsts[i] for i in misses], 99),
             "open_loop_wall_s": wall, "effective_tok_per_s": true_toks / wall,
             "prefix_runs": st["prefixes_total"], "host_syncs": syncs,
             "pool_step": st["pool_step"]}
        pc = st.get("prefix_cache")
        if pc:
            # a cached pass must hit: fewer prefix runs than v2 mode's
            check(pc["hits"] > 0 and st["prefixes_total"] < passes["v2_mode"][4]["prefixes_total"],
                  f"{label}: the prefix cache never hit ({pc['hits']} hits, "
                  f"{st['prefixes_total']} prefix runs against v2 mode's "
                  f"{passes['v2_mode'][4]['prefixes_total']})")
            r.update(hit_rate=pc["hit_rate"], hits=pc["hits"], cache_bytes=pc["bytes"],
                     cache_entries=pc["entries"])
        spec = st.get("speculative")
        if spec:
            rounds = spec["verify_rounds_total"]
            for step in ("propose_step", "verify_step"):
                check(spec[step]["captures"] == 1 and spec[step]["replays"] == rounds,
                      f"{label}: the {step} captured {spec[step]['captures']} times, replayed "
                      f"{spec[step]['replays']} times over {rounds} rounds")
            check(syncs == rounds, f"{label}: {syncs} host syncs over {rounds} rounds")
            slot_rounds = spec["proposed_total"] / D
            r.update(verify_rounds=rounds,
                     tokens_per_slot_round=spec["accepted_total"] / slot_rounds,
                     accept_rate=spec["accept_rate"], propose_step=spec["propose_step"],
                     verify_step=spec["verify_step"])
        else:
            check(st["pool_step"]["captures"] == 1 and syncs == st["steps_total"],
                  f"{label}: pool captures {st['pool_step']['captures']}, {syncs} host syncs "
                  f"over {st['steps_total']} steps")
        res[label] = r
        print(f"  {label}: first token p50/p99 {r['first_token_s_p50'] * 1e3:.2f}/"
              f"{r['first_token_s_p99'] * 1e3:.2f} ms (the {len(hits)} hit requests "
              f"{r['hit_first_token_s_p50'] * 1e3:.2f}/{r['hit_first_token_s_p99'] * 1e3:.2f} "
              f"ms, the {len(misses)} others {r['miss_first_token_s_p50'] * 1e3:.2f}/"
              f"{r['miss_first_token_s_p99'] * 1e3:.2f} ms); open loop {wall:.3f} s, "
              f"{r['effective_tok_per_s']:.1f} effective tokens/s; {r['prefix_runs']} prefix "
              f"runs, {syncs} host syncs"
              + (f"; {r['verify_rounds']} rounds, {r['tokens_per_slot_round']:.3f} tokens "
                 f"accepted a slot a round (of {D} proposed), accept rate "
                 f"{r['accept_rate']:.3f}; propose and verify each captured once and replayed "
                 f"every round" if spec else "")
              + (f"; hit rate {pc['hit_rate']:.3f}, {pc['entries']} entries, {pc['bytes']} "
                 "bytes" if pc else ""))
    res.update(fp_bits_equal_v2_mode=True, int8_score_delta_max=q_delta,
               int8_entry_err_steps_max=q_steps)
    print(f"  fp_cached: every answer v2 mode's bits (closed and open loop); int8_cached: ids "
          f"and lengths equal, scores within {q_delta:.3g} (bound {INT8_HIT_SCORE_BOUND}); "
          f"its {len(q_ent)} entries within {q_steps:.4f} of a step of the fp entries (bound "
          f"0.5)")
    return res


def tiny_gen_phase(ptt, seed, n, work):
    """Phase 53: the tiny decoder, continuous answers card against CPU."""
    from paddle_tpu_torch import serving

    V, E, Hh, K, T = (TGEN[k] for k in ("V", "E", "H", "K", "T"))
    phase(n, f"the tiny generation model (V={V}, E={E}, H={Hh}, K={K}, T={T}, f32), "
          "continuous answers: card against CPU")
    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        h0 = ptt.layers.data("h0", shape=[-1, Hh], append_batch_size=False)
        gen = ptt.layers.BeamSearchDecoder(beam_size=K, max_len=T, bos_id=0, eos_id=1)
        with gen.step():
            prev = gen.prev_ids()
            h_prev = gen.memory(init=h0)
            emb = ptt.layers.embedding(prev, size=[V, E], param_attr="g_emb")
            h = ptt.layers.fc(ptt.layers.concat([emb, h_prev], axis=1), size=Hh, act="tanh",
                              param_attr="g_w", bias_attr=ptt.ParamAttr(name="g_b"))
            gen.update_memory(h_prev, h)
            gen.output_logits(ptt.layers.fc(h, size=V, param_attr="g_wo",
                                            bias_attr=ptt.ParamAttr(name="g_bo")))
        outs = gen()
    scope = ptt.Scope()
    ptt.Executor(device="cpu").run(startup, scope=scope, seed=seed + 42)
    d = os.path.join(work, "tiny_gen")
    ptt.io.save_inference_model(d, ["h0"], list(outs), main_program=main, scope=scope)
    rng = np.random.RandomState(seed + 42)
    feeds = [{"h0": rng.standard_normal((r, Hh)).astype(np.float32)} for r in (1, 2, 3, 5)]
    got, batch = {}, None
    for dev in ("cpu", "cuda"):
        eng = serving.ServingEngine(d, policy=serving.BucketPolicy(max_batch_size=8),
                                    model_name=f"tiny_{dev}", device=dev)
        sched = eng.scheduler(max_slots=4)
        try:
            eng.warmup()
            got[dev] = [sched.generate(f, timeout_ms=HTTP_TIMEOUT * 1e3) for f in feeds]
            if dev == "cuda":
                batch = [eng.predict(f) for f in feeds]
                captures = sched.stats()["pool_step"]["captures"]
        finally:
            sched.stop()
    err = 0.0
    for a, b in zip(got["cpu"], got["cuda"]):
        check(np.array_equal(a["ids"], b["ids"]) and np.array_equal(a["lengths"], b["lengths"]),
              "card and CPU ids differ")
        err = max(err, float(np.abs(a["scores"] - b["scores"]).max()))
    check(err <= TGEN_SCORE_TOL, f"card and CPU scores {err:.3g} apart")
    same = [np.array_equal(g["ids"], w[0]) and np.array_equal(g["scores"], w[1])
            for g, w in zip(got["cuda"], batch)]
    apart = [(f["h0"].shape[0], bool(np.array_equal(g["ids"], w[0])),
              float(np.abs(g["scores"] - w[1]).max()))
             for f, g, w, s_ in zip(feeds, got["cuda"], batch, same) if not s_]
    print(f"  rows {[f['h0'].shape[0] for f in feeds]}: ids and lengths equal, scores at most "
          f"{err:.3g} apart (tol {TGEN_SCORE_TOL:g}); the card's pool captured {captures} time; "
          f"card continuous (a pool of 4 slots: 12 rows) against card batch mode (each "
          f"request's batch bucket, 8 for the 5-row one: 24 rows): the same bits for {sum(same)} of {len(same)} requests"
          + (f"; where the shapes differ, (rows, ids equal, max |score diff|) {apart}"
             if apart else ""))
    return {"score_err_max": err, "continuous_equal_batch_on_card": same,
            "differing_shapes": apart}


LOG_DIR = os.path.join(ROOT, "chiprun_out", "chip_smoke_logs")


class ServeProcess:
    """`python -m paddle_tpu_torch serve ...` in a process group of its own
    (the router and its replicas), its output in LOG_DIR/<name>.log and its
    replicas' in LOG_DIR/<name>_replicas/; `url` from its `routing ... on`
    line."""

    def __init__(self, args, name):
        os.makedirs(LOG_DIR, exist_ok=True)
        self.name = name
        self.log_path = os.path.join(LOG_DIR, f"{name}.log")
        self.replica_logs = os.path.join(LOG_DIR, f"{name}_replicas")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch", "serve", *args, "--port", "0",
             "--replica_log_dir", self.replica_logs],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            start_new_session=True)
        self.url = None
        self._seen = threading.Event()
        threading.Thread(target=self._drain, daemon=True).start()

    def _drain(self):
        with open(self.log_path, "w") as log:
            for line in self.proc.stdout:
                log.write(line)
                log.flush()
                if self.url is None and line.startswith("routing "):
                    self.url = line.split(" on ")[-1].strip()
                    self._seen.set()
        self._seen.set()

    def wait_url(self, timeout):
        self._seen.wait(timeout)
        check(self.url is not None, f"{self.name}: no `routing ... on` line within {timeout} s "
                                    f"(exit {self.proc.poll()})")
        return self.url

    def tails(self, n=25):
        out = []
        paths = [self.log_path] + sorted(
            os.path.join(self.replica_logs, f) for f in (
                os.listdir(self.replica_logs) if os.path.isdir(self.replica_logs) else ()))
        for path in paths:
            with open(path, errors="replace") as f:
                lines = f.readlines()[-n:]
            out.append(f"---- {os.path.relpath(path, ROOT)} (last {len(lines)} lines)\n"
                       + "".join(lines))
        return "\n".join(out)

    def terminate(self, timeout=180):
        """SIGTERM to the router; its exit code."""
        self.proc.send_signal(signal.SIGTERM)
        try:
            return self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            return None

    def close(self):
        """Every process of the group killed, the router reaped."""
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        try:
            self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            pass


def with_logs(sp, fn):
    """fn(), printing the serve processes' log tails if it fails."""
    try:
        return fn()
    except BaseException:
        print(sp.tails(), flush=True)
        raise


def wait_for(pred, timeout, what, poll=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            if pred():
                return time.monotonic()
        except (OSError, ValueError, KeyError):
            pass
        time.sleep(poll)
    fail(f"timed out after {timeout} s waiting for {what}")


def gen_outputs(o):
    return (np.asarray(o["ids"], np.int32)[0], np.asarray(o["scores"], np.float32)[0],
            np.asarray(o["lengths"], np.int32)[0])


def handoff_rows_check(label, payloads, ref, schema):
    """Phase 54: the prefill replica's /prefill payloads against the
    in-process scheduler's prefill() rows of the same requests: each payload
    byte for byte the packing of those rows, and unpacked, fp rows bit for
    bit and int8 rows within half a step of each row's scale (absmax/127).
    Returns the largest int8 error in steps (0 for fp)."""
    from paddle_tpu_torch.serving.disagg.handoff import pack_handoff, unpack_handoff

    quant = "int8" if label == "int8" else None
    worst, moving = 0.0, False
    for i, (data, (boots, pes)) in enumerate(zip(payloads, ref)):
        header, got_b, got_p = unpack_handoff(data)
        want = pack_handoff(boots, pes, schema, header["model"], request_id=header["request_id"],
                            quant=quant)
        check(data == want, f"{label}: request {i}'s /prefill payload ({len(data)} bytes) is not "
                            f"the in-process rows packed ({len(want)} bytes)")
        for j, (g, w) in enumerate(zip(got_b + got_p, boots + pes)):
            check(g.dtype == w.dtype and g.shape == w.shape,
                  f"{label}: request {i} state {j}: {g.dtype}{tuple(g.shape)} unpacked, "
                  f"{w.dtype}{tuple(w.shape)} in process")
            if quant and w.is_floating_point():
                x = w.float().reshape(w.shape[0], -1)
                step = x.abs().amax(dim=1).clamp(min=1e-30) / 127.0
                err = float(((g.float().reshape_as(x) - x).abs() / step[:, None]).max())
                # half a step, and the f32 roundings of x/scale and q*scale
                check(err <= 0.5 + 1e-4, f"int8: request {i} state {j} off by {err} steps")
                worst = max(worst, err)
            else:
                check(torch.equal(g.contiguous().view(torch.uint8),
                                  w.contiguous().view(torch.uint8)),
                      f"{label}: request {i} state {j} differs from the in-process rows")
            moving = moving or (w.is_floating_point() and w.numel() > 1
                                and bool((w != w.reshape(-1)[0]).any()))
    check(moving, f"{label}: no handoff state varies within a row; the check would see nothing")
    return worst


def disagg_phase(ptt, smi, n, v3):
    """Phase 54: the v3 target behind `serve --disaggregate`, fp then int8
    handoffs; returns the path's readings."""
    from paddle_tpu_torch import serving

    N, clients = SGEN3["requests"], DISAGG_CLIENTS
    phase(n, f"disaggregated serving: `python -m paddle_tpu_torch serve --disaggregate "
          f"--prefill_replicas 1 --decode_replicas 1` over phase 52's target (its prefix the "
          f"heavy part), two processes sharing the card; the trace's {N} requests buffered, "
          f"then streamed by {clients} clients, against an in-process scheduler on the card; "
          "then the same with --handoff_quant int8; each prefill replica's /prefill payloads "
          "against the in-process rows")
    from paddle_tpu_torch.serving.disagg.handoff import payload_schema

    ctxs = v3["ctxs"]
    eng = serving.ServingEngine(v3["dir"], policy=serving.BucketPolicy(max_batch_size=8),
                                model_name="disagg_oracle")
    sched = eng.scheduler()
    try:
        want = [tuple(a[0] for a in (o["ids"], o["scores"], o["lengths"])) for o in (
            sched.generate({"ctx": ctxs[i:i + 1]}, timeout_ms=HTTP_TIMEOUT * 1e3)
            for i in range(N))]
        # the handoff state (threshold and context memory) the decode
        # replica must receive: the target's logits barely read the memory
        ref_rows = [sched.prefill({"ctx": ctxs[i:i + 1]}) for i in range(N)]
        schema = payload_schema(eng.generation_meta)
    finally:
        sched.stop()
    del eng, sched
    runs = {}
    for label, extra in (("fp", []), ("int8", ["--handoff_quant", "int8"])):
        sp = ServeProcess(["--model_dir", v3["dir"], "--disaggregate", "--prefill_replicas", "1",
                           "--decode_replicas", "1", "--max_batch_size", "8",
                           "--probe_interval_ms", "200", *extra], f"disagg_{label}")

        def run(sp=sp, label=label):
            t_spawn = time.perf_counter()
            url = sp.wait_url(SERVE_START_S)
            wait_for(lambda: sum(r["up"] for r in get_json(url + "/healthz")["replicas"]
                                 .values()) == 2, SERVE_START_S, "both replicas up")
            start_s = time.perf_counter() - t_spawn
            phases_ = sorted(r["phase"] for r in get_json(url + "/healthz")["replicas"].values())
            check(phases_ == ["decode", "prefill"], f"replica phases {phases_}")
            buffered = []
            for i in range(N):
                with post_json(url + "/generate", {"inputs": {"ctx": ctxs[i:i + 1].tolist()},
                                                   "timeout_ms": HTTP_TIMEOUT * 1e3}) as r:
                    buffered.append(gen_outputs(json.load(r)["outputs"]))
            todo = queue.Queue()
            for i in range(N):
                todo.put(i)
            streamed, firsts, errors = [None] * N, [None] * N, []

            def client():
                while True:
                    try:
                        i = todo.get_nowait()
                    except queue.Empty:
                        return
                    t0 = time.perf_counter()
                    try:
                        with post_json(url + "/generate",
                                       {"inputs": {"ctx": ctxs[i:i + 1].tolist()},
                                        "stream": True, "timeout_ms": HTTP_TIMEOUT * 1e3}) as r:
                            for line in r:
                                ev = json.loads(line)
                                if ev["event"] == "token" and firsts[i] is None:
                                    firsts[i] = time.perf_counter() - t0
                                elif ev["event"] == "done":
                                    streamed[i] = gen_outputs(ev["outputs"])
                                elif ev["event"] == "error":
                                    errors.append((i, ev))
                    except Exception as e:  # recorded; the phase fails below
                        errors.append((i, repr(e)))

            t0 = time.perf_counter()
            threads = [threading.Thread(target=client) for _ in range(clients)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(HTTP_TIMEOUT)
            wall = time.perf_counter() - t0
            check(not errors and all(s is not None for s in streamed),
                  f"{label}: streamed requests failed: {errors[:3]}")
            pf_url = next(r["url"] for r in get_json(url + "/healthz")["replicas"].values()
                          if r["phase"] == "prefill")
            body = {"handoff_quant": "int8"} if label == "int8" else {}
            payloads = []
            for i in range(N):
                with post_json(pf_url + "/prefill",
                               {"inputs": {"ctx": ctxs[i:i + 1].tolist()}, **body}) as r:
                    payloads.append(r.read())
            with urllib.request.urlopen(url + "/metrics", timeout=HTTP_TIMEOUT) as r:
                m = parse_exposition(r.read().decode())
            fleet = get_json(url + "/admin/fleet")
            rc = sp.terminate()
            check(rc == 0, f"{label}: SIGTERM exit code {rc}")
            return {"buffered": buffered, "streamed": streamed, "firsts": firsts, "wall": wall,
                    "handoffs": m["pt_handoff_total"], "bytes": m["pt_handoff_bytes_total"],
                    "seconds_sum": m["pt_handoff_seconds_sum"],
                    "seconds_count": m["pt_handoff_seconds_count"],
                    "reprefills": m.get("pt_disagg_reprefills_total", 0.0),
                    "phases": sorted(fleet["fleet"]["phases"]), "start_s": start_s,
                    "payloads": payloads}

        try:
            runs[label] = with_logs(sp, run)
        finally:
            sp.close()
    fp, q8 = runs["fp"], runs["int8"]
    handoff_rows_check("fp", fp["payloads"], ref_rows, schema)
    q_steps = handoff_rows_check("int8", q8["payloads"], ref_rows, schema)
    for loop in ("buffered", "streamed"):
        same = [same_outputs(g, w) for g, w in zip(fp[loop], want)]
        check(all(same), f"disaggregated ({loop}) differs from the in-process scheduler at "
                         f"{[i for i, s in enumerate(same) if not s]}")
    q_ids = all(np.array_equal(g[0], w[0]) and np.array_equal(g[2], w[2])
                for g, w in zip(q8["buffered"] + q8["streamed"], want + want))
    q_delta = max(float(np.abs(g[1] - w[1]).max())
                  for g, w in zip(q8["buffered"] + q8["streamed"], want + want))
    check(q_ids and q_delta <= DISAGG_INT8_SCORE_TOL,
          f"int8 handoffs: ids and lengths equal {q_ids}, scores {q_delta:.3g} apart")
    per_fp, per_q8 = fp["bytes"] / fp["handoffs"], q8["bytes"] / q8["handoffs"]
    check(fp["handoffs"] == q8["handoffs"] == 2 * N and per_q8 < per_fp,
          f"handoffs {fp['handoffs']}, {q8['handoffs']}; bytes a handoff {per_fp}, {per_q8}")
    true_toks = int(sum(int(w[2][0]) for w in want))
    res = {"requests": N, "clients": clients, "device": smi, "true_tokens": true_toks,
           "fp_bits_equal_in_process": True, "int8_score_delta_max": q_delta,
           "payloads_equal_in_process_rows": True, "int8_state_err_steps_max": q_steps}
    for label, r in runs.items():
        res[label] = {"handoffs": r["handoffs"], "handoff_bytes_total": r["bytes"],
                      "handoff_bytes_each": r["bytes"] / r["handoffs"],
                      "handoff_s_mean": r["seconds_sum"] / r["seconds_count"],
                      "reprefills": r["reprefills"], "phases": r["phases"],
                      "first_token_s_p50": pct(r["firsts"], 50),
                      "first_token_s_p99": pct(r["firsts"], 99),
                      "streamed_wall_s": r["wall"], "decode_tok_per_s": true_toks / r["wall"],
                      "fleet_start_s": r["start_s"], "sigterm_exit": 0}
        x = res[label]
        print(f"  {label} handoffs: {x['handoffs']:.0f}, {x['handoff_bytes_each']:.0f} bytes "
              f"and {x['handoff_s_mean'] * 1e3:.3f} ms each (pt_handoff_* on the router's "
              f"/metrics); streamed first token p50/p99 {x['first_token_s_p50'] * 1e3:.2f}/"
              f"{x['first_token_s_p99'] * 1e3:.2f} ms, {x['decode_tok_per_s']:.1f} tokens/s "
              f"({N} requests by {clients} clients in {x['streamed_wall_s']:.3f} s); the fleet "
              f"up in {x['fleet_start_s']:.1f} s; SIGTERM exit 0")
    print(f"  fp: every buffered and streamed answer the in-process scheduler's bits; int8: "
          f"ids and lengths equal, scores within {q_delta:.3g} (tol {DISAGG_INT8_SCORE_TOL}), "
          f"{per_q8:.0f} bytes a handoff against {per_fp:.0f}; the prefill replica's {N} "
          f"payloads each the in-process rows packed, byte for byte, fp rows bit for bit, int8 "
          f"rows within {q_steps:.4f} of a step of each row's scale (bound 0.5)")
    return res


def mlp_artifacts(ptt, seed, work):
    """Two int8 serving_quant MLP artifacts (bench.py:2106-2140), quantized by
    the port's quant.convert from seeds `seed` and `seed + 1`."""
    dirs = []
    for k in range(2):
        fp_dir = os.path.join(work, f"fleet_mlp_fp_{k}")
        q_dir = os.path.join(work, f"fleet_mlp_int8_{k}")
        save_fp_artifact(ptt, lambda: build_qmlp(ptt, QMLP["in_dim"], QMLP["hidden"],
                                                 QMLP["out_dim"]), "x", fp_dir, seed + k, "cuda")
        quantize_artifact(ptt, fp_dir, q_dir, mlp_samples(), "cuda", None)
        dirs.append(q_dir)
    return dirs


def fleet_phase(ptt, smi, seed, n, work):
    """Phase 55: the int8 MLP behind `serve --replicas 2 --standby 1 --quant
    int8`, a replica SIGKILLed under load, fleetctl status and a rollout;
    returns the path's readings."""
    from paddle_tpu_torch import serving

    C, R = FLEET["clients"], QMLP["batch"]
    phase(n, f"the replica fleet: `python -m paddle_tpu_torch serve --replicas 2 --standby 1 "
          f"--quant int8` over bench.py's serving_quant MLP ({QMLP['in_dim']}-"
          f"{QMLP['hidden']}-{QMLP['hidden']}-{QMLP['out_dim']}, int8 by quant.convert), {C} "
          f"closed-loop clients of {R}-row requests; one replica SIGKILLed under load; then "
          "`fleetctl status` and a `fleetctl rollout` to a second artifact under the same load")
    q1, q2 = mlp_artifacts(ptt, seed + 50, work)
    fps = {json.load(open(os.path.join(q, "meta.json")))["program_fingerprint"]: k
           for k, q in enumerate((q1, q2))}
    rng = np.random.RandomState(seed + 52)
    feeds = [rng.standard_normal((R, QMLP["in_dim"])).astype(np.float32) for _ in range(C)]
    want = []
    for q in (q1, q2):
        eng = serving.ServingEngine(q, quantize="int8", model_name="fleet_oracle",
                                    policy=serving.BucketPolicy(max_batch_size=R))
        want.append([eng.predict({"x": f})[0] for f in feeds])
    sp = ServeProcess(["--model_dir", q1, "--replicas", "2", "--standby", "1", "--quant", "int8",
                       "--max_batch_size", str(R), "--probe_interval_ms", "100"], "fleet")

    def run():
        url = sp.wait_url(SERVE_START_S)
        wait_for(lambda: get_json(url + "/admin/fleet")["fleet"]["warm_ready"] == 1,
                 SERVE_START_S, "the standby warm")
        reps = get_json(url + "/healthz")["replicas"]
        check(len(reps) == 2, f"replicas {sorted(reps)}")
        stats0 = {name: get_json(r["url"] + "/stats")["default"] for name, r in reps.items()}
        done, errors, retryable = [], [], [0]
        stop = threading.Event()
        # the artifact each answer may come from: before the rollout only
        # the first
        allowed = {"set": {0}}

        def client(c):
            feed = {"inputs": {"x": feeds[c].tolist()}, "timeout_ms": 60000}
            while not stop.is_set():
                try:
                    with post_json(url + "/predict", feed, timeout=120) as r:
                        (out,) = json.load(r)["outputs"].values()  # the one fetch
                    out = np.asarray(out, np.float32)
                except urllib.error.HTTPError as e:
                    (retryable.__setitem__(0, retryable[0] + 1) if e.code == 503
                     else errors.append(f"HTTP {e.code}"))
                    e.close()
                    continue
                except Exception as e:
                    errors.append(repr(e))
                    continue
                which = [k for k in (0, 1) if np.array_equal(out, want[k][c])]
                if not which or not set(which) & allowed["set"]:
                    errors.append(f"client {c}: an answer of no allowed artifact {which}")
                done.append((time.monotonic(), which[0] if which else -1))

        threads = [threading.Thread(target=client, args=(c,), daemon=True) for c in range(C)]
        t_start = time.monotonic()
        for t in threads:
            t.start()
        time.sleep(FLEET["before_s"])
        name = sorted(reps)[0]
        pid = get_json(reps[name]["url"] + "/healthz")["pid"]
        t_kill = time.monotonic()
        os.kill(pid, signal.SIGKILL)
        t_trip = wait_for(lambda: name not in get_json(url + "/healthz")["replicas"] or
                          get_json(url + "/healthz")["replicas"][name]["breaker"] != "closed",
                          60, "the killed replica's breaker")
        t_admit = wait_for(lambda: get_json(url + "/admin/fleet")["fleet"]["replaced_total"]
                           == 1 and len(get_json(url + "/healthz")["replicas"]) == 2,
                           60, "the standby's admission")
        time.sleep(FLEET["after_s"])
        t_after = time.monotonic()
        survivor = next(k for k in sorted(reps) if k != name)
        stats1 = get_json(reps[survivor]["url"] + "/stats")["default"]
        d_launch = (stats1["kernel_launches"]["quant_matmul_launches"]
                    - stats0[survivor]["kernel_launches"]["quant_matmul_launches"])
        d_req = stats1["dispatches_total"] - stats0[survivor]["dispatches_total"]
        kill_errors = list(errors)
        status = subprocess.run([sys.executable, "-m", "paddle_tpu_torch", "fleetctl", "status",
                                 "--router", url], cwd=ROOT, capture_output=True, text=True,
                                timeout=120, env=dict(os.environ, PYTHONPATH=ROOT))
        check(status.returncode == 0, f"fleetctl status: {status.stderr[-2000:]}")
        status_doc = json.loads(status.stdout)
        n_before_rollout = len(done)
        allowed["set"] = {0, 1}
        t_roll = time.monotonic()
        roll = subprocess.run([sys.executable, "-m", "paddle_tpu_torch", "fleetctl", "rollout",
                               "--router", url, "--model_dir", q2], cwd=ROOT,
                              capture_output=True, text=True, timeout=600,
                              env=dict(os.environ, PYTHONPATH=ROOT))
        roll_s = time.monotonic() - t_roll
        check(roll.returncode == 0, f"fleetctl rollout: {roll.stderr[-2000:]}")
        report = json.loads(roll.stdout)
        allowed["set"] = {1}
        n_flip = len(done)
        time.sleep(1.0)
        stop.set()
        for t in threads:
            t.join(120)
        versions = {r["versions"]["default"] for r in
                    get_json(url + "/healthz")["replicas"].values()}
        rc = sp.terminate()
        return dict(t_start=t_start, t_kill=t_kill, t_trip=t_trip, t_admit=t_admit,
                    t_after=t_after, done=list(done), errors=list(errors),
                    kill_errors=kill_errors, retryable=retryable[0], d_launch=d_launch,
                    d_req=d_req, status=status_doc, report=report, roll_s=roll_s,
                    n_before_rollout=n_before_rollout, n_flip=n_flip, versions=versions, rc=rc)

    try:
        r = with_logs(sp, run)
    finally:
        sp.close()
    check(not r["errors"], f"failed requests: {r['errors'][:5]}")
    check(r["rc"] == 0, f"SIGTERM exit code {r['rc']}")
    check(r["report"]["status"] == "ok" and fps.get(r["report"]["fingerprint"]) == 1,
          f"rollout report {r['report']}")
    check(r["versions"] == {r["report"]["fingerprint"]}, f"versions after the rollout "
                                                         f"{r['versions']}")
    check(r["status"]["fleet"]["replaced_total"] == 1, f"status {r['status']['fleet']}")
    per_req = r["d_launch"] / max(r["d_req"], 1)
    check(r["d_req"] > 0 and per_req == QMLP_SITES,
          f"B12 launches a request on a replica: {r['d_launch']} over {r['d_req']}")
    times = [t for t, _ in r["done"]]

    def rate(a, b):
        return sum(a <= t < b for t in times) / (b - a)

    before = rate(r["t_start"] + 0.5, r["t_kill"])
    after = rate(r["t_admit"], r["t_after"])
    res = {"clients": C, "rows_a_request": R, "requests": len(times),
           "retryable_503": r["retryable"], "non_retryable_errors": 0,
           "breaker_trip_s": r["t_trip"] - r["t_kill"], "admission_s": r["t_admit"] - r["t_kill"],
           "req_per_s_before_kill": before, "req_per_s_after_recovery": after,
           "b12_launches_a_request": per_req, "rollout_s": r["roll_s"],
           "rollout_requests": r["n_flip"] - r["n_before_rollout"],
           "rollout": {k: r["report"].get(k) for k in ("status", "fingerprint", "old", "new")},
           "device": smi}
    print(f"  {len(times)} requests by {C} clients, {r['retryable']} retryable 503s, no "
          f"non-retryable error; the killed replica out of rotation {res['breaker_trip_s']:.3f} s "
          f"after SIGKILL, the standby admitted after {res['admission_s']:.3f} s; "
          f"{before:.1f} requests/s before the kill, {after:.1f} after recovery "
          f"({R} rows each)")
    print(f"  B12 launches a request by the surviving replica's /stats counters: {per_req:g} "
          f"({r['d_launch']} over {r['d_req']} requests); fleetctl status exit 0; fleetctl "
          f"rollout ok in {r['roll_s']:.2f} s with {res['rollout_requests']} requests served "
          f"meanwhile, none failed, every replica then on {r['report']['fingerprint']}; SIGTERM "
          "exit 0")
    return res


# ------------ memory_optimize, the general ops and networks.py: phases 56-59 --
# bench.py's transformer row (TFM_BENCH) under each remat policy
# (memory_optimize, core/remat.py), each from the same startup state; None
# is the plain step. Every policy recomputes each checkpointed segment's
# forward in the backward, the flash forward included (a hand kernel is no
# aten product, so no policy keeps its output): 16 flash_fwd a step.
REMAT_RUNS = (None, "full", "dots", "dots_no_batch")
REMAT_FLASH = {None: TFM_STEP_LAUNCHES,
               **{p: {"flash_fwd": 16, "flash_bwd_dkv": 8, "flash_bwd_dq": 8}
                  for p in REMAT_RUNS[1:]}}
# the transformer's window without remat (PERF.md's table of windows):
# peak allocated and the graph's pool, GiB, on an H100 80GB HBM3 at 700 W
TFM_WINDOW_NO_REMAT_GIB = (41.16, 17.678)
# the op sweep: [128 x 1024] inputs, dense and ragged (8 sequences of 1..31
# rows of 1024); each op's outputs and input gradients card against CPU,
# within OPS_TOL of each output's largest |value| (at least 1): f32 1e-5;
# bf16 2e-2, a bf16 ulp at that scale (the CPU's and the card's
# transcendentals may round a bf16 result one ulp apart)
OPS_ROWS, OPS_WIDTH = 128, 1024
OPS_TOL = {None: 1e-5, "bfloat16": 2e-2}
# conv2d_transpose at the slice's shape, held to float64 on the card: f32
# with TF32 off within 1e-5 of the output's largest |value| (TF32 would
# miss it by orders), bf16 operands within 2e-2
CONVT = dict(batch=128, cin=256, cout=128, hw=16, k=4, stride=2, pad=1)
CONVT_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# networks.py at the sentiment phase's widths (SENT_BENCH: B=128, T <= 128,
# emb 128), f32: the book's convolution_net (two sequence_conv_pool, filter
# sizes 3 and 4, 512 filters each), and bidirectional_lstm and
# bidirectional_gru classifiers at hidden 512; B1-B4 launches a step
NET_FILTERS = 512
NET_HIDDEN = 512
NET_LR = 0.002
NET_LAUNCHES = {"bidirectional_lstm": {"lstm_fwd": 2, "lstm_bwd": 2},
                "bidirectional_gru": {"gru_fwd": 2, "gru_bwd": 2}}
# BatchNorm programs under each remat policy (phase 57's second half):
# resnet_cifar10(32) at IMG_BENCH's B=128, and ResNet-50 on the B11 route
# (every 1x1 conv the hand kernel) at 64x64, B=16, 10 classes; 2 steps
REMAT_BN_RESNET50 = dict(hw=64, class_dim=10, batch=16, lr=0.1)
REMAT_BN_STEPS = 2


def host_state(scope, names):
    """The named scope tensors copied to the host."""
    return {n: scope.get(n).detach().to("cpu", copy=True) for n in names}


def remat_phases(ptt, smi, seed, first_phase):
    """Phases first_phase.. : bench.py's transformer row under each remat
    policy, then through scan_window under `full`; returns its readings and
    the flash launches a step by policy."""
    from paddle_tpu_torch.core import graph
    from paddle_tpu_torch.ops import flash_kernels as fk
    from paddle_tpu_torch.ops import flash_ops

    n = first_phase
    phase(n, "memory_optimize on bench.py's transformer row (dim 2048, 8 layers, B=8, T=1024, "
             "bf16): no remat, full, dots, dots_no_batch, each 3 timed steps from one state")
    t_start = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    main_p, startup, loss = build_transformer_program(ptt, **TFM_BENCH)
    main_p.set_amp("bfloat16")
    exe = ptt.Executor()
    names = [p.name for p in main_p.parameters()]

    def fresh_scope():
        # the startup's draws are the same bits from the same seed
        sc = ptt.Scope()
        exe.run(startup, scope=sc, seed=seed)
        return sc
    feed = transformer_feed(np.random.RandomState(0), TFM_BENCH["vocab"], TFM_BENCH["seqlen"],
                            TFM_BENCH["batch"])
    tokens = TFM_BENCH["batch"] * TFM_BENCH["seqlen"]
    fwd = [o for o in main_p.global_block().ops]
    fwd = fwd[:[o.type for o in fwd].index("autodiff")]
    out, ref = {"policies": {}}, None

    def run(policy, steps=3):
        main_p.remat_policy = policy
        sc = fresh_scope()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        losses = [float(exe.run(main_p, feed, [loss.name], scope=sc)[0])]
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        for k in TFM_STEP_LAUNCHES:
            setattr(fk, f"{k}_launches", 0)
        flash_ops.plain_routes = 0
        times = []
        for _ in range(steps):
            t0 = time.perf_counter()
            losses.append(float(exe.run(main_p, feed, [loss.name], scope=sc)[0]))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        med = statistics.median(times)
        r = dict(losses=losses, warm_up_s=warm_s, steps_ms=times, ms_per_step=med,
                 tokens_per_s=tokens / med * 1e3,
                 peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                 launches_per_step={k: getattr(fk, f"{k}_launches") / steps
                                    for k in TFM_STEP_LAUNCHES},
                 plain_routes=flash_ops.plain_routes)
        return r, host_state(sc, names)

    for i, policy in enumerate(REMAT_RUNS):
        r, st = run(policy)
        label = policy or "no remat"
        if policy:
            from paddle_tpu_torch.core import remat
            r["segments"] = len(remat.segments(fwd))
        print(f"  {label}: warm-up {r['warm_up_s']:.2f} s; steps ms "
              f"{[round(t, 3) for t in r['steps_ms']]}, median {r['ms_per_step']:.3f} ms a step, "
              f"{r['tokens_per_s']:.1f} tokens/s; peak {r['peak_gib']:.2f} GiB allocated; "
              f"flash launches a step {r['launches_per_step']} (expected "
              f"{REMAT_FLASH[policy]}), plain routes {r['plain_routes']}"
              + (f"; {r['segments']} segments of the {len(fwd)} forward ops" if policy else "")
              + f" on {smi}")
        check(all(np.isfinite(r["losses"])), f"{label}: non-finite loss")
        check(r["plain_routes"] == 0, f"{label}: attention routed to the plain formula")
        for k, c in REMAT_FLASH[policy].items():
            check(r["launches_per_step"][k] == c,
                  f"{label}: {k} {r['launches_per_step'][k]} a step, not {c}")
        if ref is None:
            ref = (r["losses"], st)
            again, st2 = run(None)
            d = next((k for k in names if not torch.equal(st2[k], st[k])), None)
            check(again["losses"] == r["losses"] and d is None,
                  f"two plain runs differ (losses {again['losses']} and {r['losses']}, state "
                  f"first at {d}): the step is not deterministic run to run")
            print(f"  no remat again: the same losses and parameter bits ({len(names)} "
                  f"parameters), peak {again['peak_gib']:.2f} GiB")
            del st2
        else:
            d = next((k for k in names if not torch.equal(st[k], ref[1][k])), None)
            check(r["losses"] == ref[0], f"{label}: losses {r['losses']} are not the plain "
                                         f"step's {ref[0]}")
            check(d is None, f"{label}: the parameters after {len(r['losses'])} steps differ "
                             f"from the plain step's first at {d}")
            print(f"  {label}: the plain step's losses and parameter bits ({len(names)} "
                  f"parameters, torch.equal)")
        del st
        out["policies"][label] = r
    plain = out["policies"]["no remat"]["peak_gib"]
    for p in ("full", "dots"):
        check(out["policies"][p]["peak_gib"] < plain,
              f"{p}: peak {out['policies'][p]['peak_gib']:.2f} GiB is not below the plain "
              f"step's {plain:.2f}")

    n += 1
    phase(n, "the same row through scan_window under full: 4 steps, one captured step "
             "replayed, against 4 per-step remat steps from one state; then BatchNorm "
             "programs under each policy")
    main_p.remat_policy = "full"
    win = {k: np.stack([v] * 4) for k, v in feed.items()}
    sc = fresh_scope()
    per_step = [float(exe.run(main_p, feed, [loss.name], scope=sc)[0]) for _ in range(4)]
    want = host_state(sc, names)
    del sc
    wexe = ptt.Executor()
    sc = fresh_scope()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = graph.counter_state()
    t0 = time.perf_counter()
    (ys,), _ = wexe.run_window(main_p, win, [loss.name], scope=sc)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    moved = graph.counter_delta(before, graph.counter_state())
    sg = next(iter(wexe._windows.values()))
    pool = graph_pool_gib(sg.graph)
    peak = torch.cuda.max_memory_allocated() / 2**30
    wl = [float(v) for v in ys.cpu()]
    got = host_state(sc, names)
    d = next((k for k in names if not torch.equal(got[k], want[k])), None)
    launches = {k: moved.get(("paddle_tpu_torch.ops.flash_kernels", f"{k}_launches"), 0) / 4
                for k in TFM_STEP_LAUNCHES}
    out["window_full"] = dict(losses=wl, per_step_losses=per_step, ms_per_step=wall / 4,
                              peak_gib=peak, graph_pool_gib=pool,
                              stats=dict(wexe.cache_stats), capture_s=sg.capture_s,
                              launches_per_step=launches)
    print(f"  window losses {wl}, per-step {per_step}; {wall / 4:.3f} ms a step over the 4 "
          f"(its warm-up and capture included); cache {wexe.cache_stats}; capture "
          f"{sg.capture_s:.3f} s; flash launches a step {launches}")
    print(f"  peak {peak:.2f} GiB allocated + the graph's pool "
          f"{pool if pool is None else round(pool, 3)} GiB, against "
          f"{TFM_WINDOW_NO_REMAT_GIB[0]} + {TFM_WINDOW_NO_REMAT_GIB[1]} GiB without remat "
          f"(PERF.md) on {smi}")
    check(wl == per_step, f"the full window's losses {wl} are not the per-step loop's {per_step}")
    check(d is None, f"the full window's parameters differ from the per-step loop's first at "
                     f"{d}")
    check(wexe.cache_stats["captures"] == 1 and wexe.cache_stats["replays"] == 3,
          f"the window did not capture once and replay: {wexe.cache_stats}")
    for k, c in REMAT_FLASH["full"].items():
        check(launches[k] == c, f"the full window: {k} {launches[k]} a step, not {c}")
    print(f"  the window ends on the per-step loop's bits ({len(names)} parameters)")
    del sc, wexe, sg, want, got
    main_p.remat_policy = None
    del main_p, startup, exe
    out["batch_norm"] = remat_bn_check(ptt, smi, seed)
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_start
    print(f"  phases {first_phase}-{n}: {out['seconds']:.1f} s")
    return out, {k: {p or "none": out["policies"][p or "no remat"]["launches_per_step"][k]
                     for p in REMAT_RUNS} for k in TFM_STEP_LAUNCHES}


def remat_bn_check(ptt, smi, seed):
    """Phase 57's second half: each BatchNorm program's plain step twice,
    then under each policy, all from one startup state. A BN op writes its
    new running statistics under its Mean and Variance inputs' names; each
    policy must hand them back from the segment that computes them: the
    losses and the whole scope the plain step's bits, the statistics moved
    from their startup values. B11 launches twice a step under remat."""
    from paddle_tpu_torch.ops import fused_conv_kernels as fck

    ib, rb = IMG_BENCH, REMAT_BN_RESNET50
    rng = np.random.RandomState(seed + 57)
    cases = (("resnet_cifar10", lambda: image_program(ptt, "resnet_cifar10", ib["resnet"],
                                                      ib["lr"])[:3],
              image_feed(rng, ib["batch"]), {}),
             ("resnet50_b11", lambda: build_resnet_program(ptt, rb["hw"], rb["class_dim"],
                                                           rb["lr"]),
              resnet_feed(rng, rb["hw"], rb["class_dim"], rb["batch"]),
              dict(fused_conv_dot_max_n=RESNET_DOT_MAX_N, fused_conv_pallas=True)))
    out = {}
    for name, build, feed, flags in cases:
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        main_p, startup, loss = build()
        main_p.set_amp("bfloat16")
        ops = main_p.global_block().ops
        names = [v.name for v in main_p.persistables()]
        stats = sorted({n for op in ops for slot in ("Mean", "Variance")
                        for n in op.inputs.get(slot, ()) if op.type != "bn_apply"})
        exe = ptt.Executor()

        def run(policy):
            main_p.remat_policy = policy
            sc = ptt.Scope()
            exe.run(startup, scope=sc, seed=seed)
            init = host_state(sc, stats)
            fck.fused_conv_bn_launches = 0
            with _Flags(ptt.FLAGS, **flags):
                losses = [float(exe.run(main_p, feed, [loss.name], scope=sc)[0])
                          for _ in range(REMAT_BN_STEPS)]
            return (losses, host_state(sc, names), init,
                    fck.fused_conv_bn_launches / REMAT_BN_STEPS)

        ref = run(None)
        r = {"stats": len(stats), "losses": {"none": ref[0]}, "b11_launches_per_step":
             {"none": ref[3]}}
        moved = [k for k in stats if not torch.equal(ref[1][k], ref[2][k])]
        check(all(np.isfinite(ref[0])), f"{name}: non-finite loss")
        check(not flags or ref[3] > 0, f"{name}: B11 never launched")
        check(len(moved) == len(stats), f"{name}: {len(stats) - len(moved)} of {len(stats)} "
                                        "running statistics kept their startup values")
        for policy in REMAT_RUNS:
            got = run(policy)
            label = policy or "no remat again"
            d = next((k for k in names if not torch.equal(got[1][k], ref[1][k])), None)
            check(got[0] == ref[0] and d is None,
                  f"{name} under {label}: losses {got[0]} against the plain step's {ref[0]}, "
                  f"the scope first differs at {d}")
            r["losses"][policy or "none_again"] = got[0]
            r["b11_launches_per_step"][policy or "none_again"] = got[3]
            want = ref[3] * (2 if policy else 1)
            check(got[3] == want, f"{name} under {label}: B11 {got[3]} a step, not {want}")
        main_p.remat_policy = None
        r["seconds"] = time.perf_counter() - t0
        out[name] = r
        print(f"  {name} (bf16, {len(names)} persistables, {len(stats)} running statistics): "
              f"under no remat twice, full, dots and dots_no_batch the plain step's losses "
              f"{ref[0]} and scope bits (torch.equal), every running statistic moved; B11 "
              f"launches a step {r['b11_launches_per_step']}; {r['seconds']:.1f} s on {smi}")
        del exe, ref
    return out


def _op_inputs(rng, spec):
    """numpy inputs of the sweep: spec maps a slot to a shape, ("lod",
    width) or a ready array."""
    out = {}
    for slot, s in spec.items():
        if isinstance(s, np.ndarray):
            out[slot] = s
        elif isinstance(s, tuple) and s and s[0] == "lod":
            lens = rng.randint(1, OPS_ROWS // 8 + 1, 8)
            seqs = [rng.standard_normal((int(m), s[1])).astype(np.float32) for m in lens]
            if len(s) > 2:  # positive values (a log, a square root)
                seqs = [np.abs(q) + 0.25 for q in seqs]
            out[slot] = ("lod", seqs)
        else:
            out[slot] = rng.standard_normal(s).astype(np.float32)
    return out


# the slots that carry activations: under amp they hold bf16 (an op under
# amp reads the bf16 output of a product), the others stay f32 (masters,
# labels, probabilities)
AMP_SLOTS = ("X", "Logits", "Input")


def run_op(ptt, dev, op_type, inputs, attrs, amp, n_out, out_slot, grad, cot_seed):
    """One op on `dev` through the port's registry: its outputs and the
    gradients of Σ out·cot for its float inputs (`grad`), as numpy."""
    from paddle_tpu_torch.core import registry as treg
    from paddle_tpu_torch.core.program import Operator

    env, leaves = {"@AMP@": amp, "@RNG@": torch.Generator(device=dev).manual_seed(0)}, []
    slots = {}
    for slot, v in inputs.items():
        name = f"{slot}_0"
        slots[slot] = [name]
        low = amp is not None and slot in AMP_SLOTS
        if isinstance(v, tuple):
            t = ptt.LoDArray.from_sequences(v[1], capacity=OPS_ROWS, max_seqs=8).to(dev)
            if low:
                t = t.with_data(t.data.to(torch.bfloat16))
            if grad:
                t = t.with_data(t.data.clone().requires_grad_(True))
                leaves.append(t.data)
        else:
            t = torch.as_tensor(v, device=dev)
            if low and t.is_floating_point():
                t = t.to(torch.bfloat16)
            if grad and t.is_floating_point():
                t = t.clone().requires_grad_(True)
                leaves.append(t)
        env[name] = t
    outs = {out_slot: [f"out{i}" for i in range(n_out)]}
    with torch.enable_grad():
        treg.get_kernel(op_type)(treg.OpContext(Operator(op_type, slots, outs, dict(attrs)),
                                                env))
        vals = [env[f"out{i}"] for i in range(n_out)]
        vals = [v.data if isinstance(v, ptt.LoDArray) else v for v in vals]
        grads = []
        if grad:
            rng = np.random.RandomState(cot_seed)
            loss = sum((v.float() * torch.as_tensor(
                rng.standard_normal(tuple(v.shape)).astype(np.float32), device=dev)).sum()
                for v in vals if v.is_floating_point() and v.requires_grad)
            grads = list(torch.autograd.grad(loss, leaves, allow_unused=True))
    host = lambda t: None if t is None else (t.detach().float() if t.is_floating_point()  # noqa: E731
                                             else t.detach()).cpu().numpy()
    return [host(v) for v in vals], [host(g) for g in grads], [str(v.dtype) for v in vals]


def op_sweep_cases():
    """(op, inputs spec, attrs, outputs, output slot, differentiable, amp
    cast, label) for every op of the sweep."""
    R, W = OPS_ROWS, OPS_WIDTH
    acts = ["logsigmoid", "exp", "exponential", "tanh_shrink", "softshrink", "sqrt", "abs",
            "ceil", "floor", "round", "reciprocal", "log", "square", "softplus", "softsign",
            "brelu", "leaky_relu", "soft_relu", "softrelu", "elu", "relu6", "pow", "stanh",
            "hard_shrink", "thresholded_relu", "hard_sigmoid", "swish", "softmax_activation"]
    rng = np.random.RandomState(3)
    pos = (np.abs(rng.standard_normal((R, W))) + 0.25).astype(np.float32)
    kinked = {"ceil", "floor", "round"}  # their gradient is 0 almost everywhere
    cases = []
    for a in acts:
        positive = a in {"sqrt", "log", "reciprocal", "pow"}
        attrs = {"factor": 2.5} if a == "pow" else {}
        cases.append((a, {"X": pos if positive else (R, W)}, attrs, 1, "Out", a not in kinked,
                      "dense"))
        cases.append((a, {"X": ("lod", W, True) if positive else ("lod", W)}, attrs, 1, "Out",
                      a not in kinked, "lod"))
    for op in ("elementwise_sub", "elementwise_mul", "elementwise_div", "elementwise_max",
               "elementwise_min", "elementwise_pow"):
        y = pos if op in ("elementwise_div", "elementwise_pow") else (R, W)
        x = pos if op == "elementwise_pow" else (R, W)
        cases.append((op, {"X": x, "Y": y}, {}, 1, "Out", True, "dense"))
        cases.append((op, {"X": ("lod", W) if op != "elementwise_pow" else x,
                           "Y": (pos[0] if op in ("elementwise_div", "elementwise_pow")
                                 else (W,))}, {"axis": -1}, 1, "Out", True, "lod / broadcast"))
    for op in ("reduce_sum", "reduce_mean", "reduce_max", "reduce_min"):
        for dim in (0, 1):
            for keep in (False, True):
                cases.append((op, {"X": (R, W)}, {"dim": dim, "keep_dim": keep}, 1, "Out",
                              True, f"dim {dim}{' keep' if keep else ''}"))
        cases.append((op, {"X": (R, W)}, {"reduce_all": True}, 1, "Out", True, "all"))
    cases += [
        ("transpose", {"X": (R, W)}, {"axis": [1, 0]}, 1, "Out", True, "dense"),
        ("split", {"X": (R, W)}, {"num": 4, "axis": 1}, 4, "Out", True, "num 4"),
        ("split", {"X": (R, W)}, {"sections": [W // 4, W - W // 4], "axis": 1}, 2, "Out", True,
         "sections"),
        ("expand", {"X": (R, W // 4)}, {"expand_times": [2, 4]}, 1, "Out", True, "dense"),
        ("slice", {"X": (R, W)}, {"axes": [0, 1], "starts": [3, W // 10], "ends": [R - 8, -W // 10]},
         1, "Out", True, "dense"),
        ("clip", {"X": (R, W)}, {"min": -0.5, "max": 0.7}, 1, "Out", True, "dense"),
        ("clip", {"X": ("lod", W)}, {"min": -0.5, "max": 0.7}, 1, "Out", True, "lod"),
        ("cast", {"X": (R, W)}, {"dtype": "int32"}, 1, "Out", False, "to int32"),
        ("cast", {"X": (R, W)}, {"dtype": "bfloat16"}, 1, "Out", True, "to bfloat16"),
        ("clip_by_norm", {"X": (R, W)}, {"max_norm": 1.0}, 1, "Out", True, "dense"),
        ("squared_l2_norm", {"X": (R, W)}, {}, 1, "Out", True, "dense"),
        ("assign", {"X": (R, W)}, {}, 1, "Out", True, "dense"),
        ("increment", {"X": (R, W)}, {"step": 0.5}, 1, "Out", True, "dense"),
        ("increment", {"X": np.arange(4, dtype=np.int32)}, {"step": 1.0}, 1, "Out", False,
         "int counter"),
        ("argmax", {"X": (R, W)}, {"axis": 1}, 1, "Out", False, "dense"),
        ("huber_loss", {"X": (R, 1), "Y": (R, 1)}, {"delta": 0.5}, 1, "Out", True, "dense"),
        ("sequence_conv", {"X": ("lod", W), "Filter": (3 * W, 256), "Bias": (256,)},
         {"context_length": 3, "context_start": -1}, 1, "Out", True, "lod"),
    ]
    p = rng.rand(R, W).astype(np.float32) + 0.05
    p /= p.sum(-1, keepdims=True)
    soft = rng.rand(R, W).astype(np.float32)
    soft /= soft.sum(-1, keepdims=True)
    cases += [
        ("cross_entropy", {"X": p, "Label": rng.randint(0, W, (R, 1)).astype(np.int32)},
         {}, 1, "Y", True, "hard label"),
        ("cross_entropy", {"X": p, "Label": soft}, {"soft_label": True}, 1, "Y", True,
         "soft label"),
        ("softmax_with_cross_entropy", {"Logits": (R, W), "Label": soft}, {"soft_label": True},
         1, "Loss", True, "soft label"),
    ]
    cmp_x = rng.randint(-2, 3, (R, W)).astype(np.float32)
    cmp_y = rng.randint(-2, 3, (R, W)).astype(np.float32)
    for op in ("less_than", "less_equal", "greater_than", "greater_equal", "equal", "not_equal"):
        cases.append((op, {"X": cmp_x, "Y": cmp_y}, {}, 1, "Out", False, "dense"))
    cases.append(("logical_and", {"X": cmp_x > 0, "Y": cmp_y > 0}, {}, 1, "Out", False,
                  "dense"))
    cases.append(("logical_not", {"X": cmp_x > 0}, {}, 1, "Out", False, "dense"))
    return cases


def op_sweep_phase(ptt, smi, seed, n):
    """Phase n: every op the slice adds, card against CPU; then
    conv2d_transpose at the slice's shape against float64 on the card."""
    import torch.nn.functional as F

    from paddle_tpu_torch.core import registry as treg
    from paddle_tpu_torch.core.program import Operator

    phase(n, f"the general ops, card against CPU: [{OPS_ROWS} x {OPS_WIDTH}] inputs, dense "
             "and ragged, forward and the gradients of the differentiable ones, f32 and bf16 "
             "amp; then conv2d_transpose at B=128, 256 -> 128 channels, 16x16 -> 32x32")
    ptt.Executor()  # the card's settings: no TF32 in cuDNN, f32 GEMM reductions
    t_start = time.perf_counter()
    cases = op_sweep_cases()
    ops_seen, worst, n_runs = set(), {None: 0.0, "bfloat16": 0.0}, 0
    for i, (op, spec, attrs, n_out, slot, grad, label) in enumerate(cases):
        ops_seen.add(op)
        rng = np.random.RandomState(seed + i)
        ins = _op_inputs(rng, spec)
        for amp in (None, "bfloat16"):
            res = {}
            for dev in ("cpu", CARD):
                res[dev] = run_op(ptt, dev, op, ins, attrs, amp, n_out, slot, grad, seed + i)
            (co, cg, cdt), (go, gg, gdt) = res["cpu"], res[CARD]
            check(cdt == gdt, f"{op} ({label}, {amp or 'f32'}): dtypes {gdt} on the card, {cdt} "
                              f"on the CPU")
            tol = OPS_TOL["bfloat16" if amp or any("bfloat16" in d for d in gdt) else None]
            for what, cs, gs in (("output", co, go), ("gradient", cg, gg)):
                for c, g in zip(cs, gs):
                    if c is None:
                        check(g is None, f"{op}: a gradient on the card only")
                        continue
                    if not np.issubdtype(c.dtype, np.floating):
                        check(np.array_equal(c, g), f"{op} ({label}, {amp or 'f32'}): the "
                                                    f"{what} differs card against CPU")
                        continue
                    finite = np.isfinite(c)  # a ragged input's zero padding: log(0)
                    check(np.array_equal(finite, np.isfinite(g)),
                          f"{op} ({label}, {amp or 'f32'}): the {what}'s non-finite values "
                          f"differ card against CPU")
                    c, g = c[finite], g[finite]
                    scale = max(1.0, float(np.abs(c).max()) if c.size else 1.0)
                    err = float(np.abs(g - c).max()) / scale if c.size else 0.0
                    worst[amp] = max(worst[amp], err)
                    check(err <= tol, f"{op} ({label}, {amp or 'f32'}): {what} {err:.3e} of its "
                                      f"scale apart, card against CPU (tol {tol:g})")
            n_runs += 1
    # truncated_gaussian_random draws from each device's own generator:
    # held to its law on the card
    env = {"@RNG@": torch.Generator(device=CARD).manual_seed(seed)}
    treg.get_kernel("truncated_gaussian_random")(treg.OpContext(Operator(
        "truncated_gaussian_random", {}, {"Out": ["o"]},
        {"shape": [OPS_ROWS, OPS_WIDTH], "mean": 1.0, "std": 0.5, "dtype": "float32"}), env))
    o = env["o"].float().cpu().numpy()
    ops_seen.add("truncated_gaussian_random")
    print(f"  truncated_gaussian_random on the card: [{OPS_ROWS}, {OPS_WIDTH}] in "
          f"[{o.min():.4f}, {o.max():.4f}], mean {o.mean():.5f}, std {o.std():.5f} (the law's "
          f"1.0 and {0.5 * 0.8796:.5f})")
    check(o.min() >= 0.0 and o.max() <= 2.0 and abs(o.mean() - 1.0) < 0.005
          and abs(o.std() - 0.5 * 0.8796) < 0.005, "truncated_gaussian_random off its law")
    print(f"  {len(ops_seen)} op types, {n_runs} runs: the largest error card against CPU, "
          f"over its output's scale, f32 {worst[None]:.3e} (tol {OPS_TOL[None]:g}), bf16 amp "
          f"{worst['bfloat16']:.3e} (tol {OPS_TOL['bfloat16']:g})")

    c = CONVT
    rng = np.random.RandomState(seed + 99)
    x = torch.as_tensor(rng.standard_normal((c["batch"], c["cin"], c["hw"], c["hw"]))
                        .astype(np.float32), device=CARD)
    w = torch.as_tensor((rng.standard_normal((c["cin"], c["cout"], c["k"], c["k"]))
                         / np.sqrt(c["cin"] * c["k"] ** 2)).astype(np.float32), device=CARD)
    b = torch.as_tensor(rng.standard_normal(c["cout"]).astype(np.float32), device=CARD)
    out = {"ops": len(ops_seen), "runs": n_runs, "worst_f32": worst[None],
           "worst_bf16": worst["bfloat16"]}
    for dt, amp in ((torch.float32, None), (torch.bfloat16, "bfloat16")):
        xi = x.to(dt).requires_grad_(True)
        wi = w.clone().requires_grad_(True)

        def once():
            env = {"@AMP@": amp, "x": xi, "w": wi, "b": b}
            treg.get_kernel("conv2d_transpose")(treg.OpContext(Operator(
                "conv2d_transpose", {"Input": ["x"], "Filter": ["w"], "Bias": ["b"]},
                {"Output": ["y"]}, {"strides": c["stride"], "paddings": c["pad"]}), env))
            return env["y"]

        with torch.enable_grad():
            got = once()
            ggrads = torch.autograd.grad(got, [xi, wi], torch.ones_like(got))
        with torch.no_grad():
            ms = cuda_ms(once, 20)
        x64 = xi.detach().double().requires_grad_(True)
        w64 = w.to(dt).double().requires_grad_(True)
        with torch.enable_grad():
            want = (F.conv_transpose2d(x64, w64, stride=c["stride"], padding=c["pad"])
                    + b.double().reshape(1, -1, 1, 1))
            wgrads = torch.autograd.grad(want, [x64, w64], torch.ones_like(want))
        errs = [float((g.detach().double() - r.detach()).abs().max())
                / max(1.0, float(r.detach().abs().max()))
                for g, r in zip((got,) + tuple(ggrads), (want,) + tuple(wgrads))]
        label = "f32 (TF32 off)" if dt == torch.float32 else "bf16 amp"
        out[f"conv2d_transpose_{'f32' if amp is None else 'bf16'}"] = dict(
            ms=ms, shape=list(got.shape), errors=dict(zip(("output", "dx", "dw"), errs)))
        print(f"  conv2d_transpose {label}: output {list(got.shape)} {got.dtype}; errors "
              f"against float64 over their scales: output {errs[0]:.3e}, dx {errs[1]:.3e}, "
              f"dw {errs[2]:.3e} (tol {CONVT_TOL[dt]:g}); forward {ms:.4f} ms on {smi}")
        check(list(got.shape) == [c["batch"], c["cout"], 2 * c["hw"], 2 * c["hw"]],
              f"conv2d_transpose: output {list(got.shape)}")
        check(max(errs) <= CONVT_TOL[dt], f"conv2d_transpose {label}: {max(errs):.3e} from "
                                          f"float64")
    out["seconds"] = time.perf_counter() - t_start
    print(f"  phase {n}: {out['seconds']:.1f} s")
    return out


def build_text_cnn(ptt, vocab, emb, filters, lr):
    """tests/book's convolution_net: two sequence_conv_pool over the
    embedded words (filter sizes 3 and 4), an fc softmax over both,
    cross_entropy, Adam."""
    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        words = ptt.layers.data("words", shape=[-1], dtype=np.int32, lod_level=1,
                                append_batch_size=False)
        label = ptt.layers.data("label", shape=[1], dtype=np.int32)
        e = ptt.layers.embedding(words, size=[vocab, emb])
        c3 = ptt.networks.sequence_conv_pool(e, num_filters=filters, filter_size=3, act="tanh",
                                             pool_type="sqrt")
        c4 = ptt.networks.sequence_conv_pool(e, num_filters=filters, filter_size=4, act="tanh",
                                             pool_type="sqrt")
        pred = ptt.layers.fc([c3, c4], size=2, act="softmax")
        loss = ptt.layers.mean(ptt.layers.cross_entropy(pred, label))
        ptt.optimizer.Adam(learning_rate=lr).minimize(loss)
    return main, startup, loss


def build_bi_rnn(ptt, vocab, emb, hidden, lr, kind, max_len):
    """An embedding, networks.bidirectional_lstm or _gru over `max_len`
    steps, max-pooled, an fc softmax, cross_entropy, Adam."""
    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        words = ptt.layers.data("words", shape=[-1], dtype=np.int32, lod_level=1,
                                append_batch_size=False)
        label = ptt.layers.data("label", shape=[1], dtype=np.int32)
        e = ptt.layers.embedding(words, size=[vocab, emb])
        h = getattr(ptt.networks, kind)(e, size=hidden, max_len=max_len)
        pred = ptt.layers.fc(ptt.layers.sequence_pool(h, "max"), size=2, act="softmax")
        loss = ptt.layers.mean(ptt.layers.cross_entropy(pred, label))
        ptt.optimizer.Adam(learning_rate=lr).minimize(loss)
    return main, startup, loss


def networks_phase(ptt, smi, seed, n):
    """Phase n: networks.py's text builders trained 3 steps card against
    CPU (f32) at the sentiment phase's widths, B1-B4 counted; img_conv_group
    and glu forward card against CPU."""
    from paddle_tpu_torch.core import graph

    sb = SENT_BENCH
    phase(n, f"networks.py at the sentiment phase's widths (B={sb['batch']}, T <= "
             f"{sb['max_len']}, emb {sb['emb']}, f32): convolution_net (2 sequence_conv_pool, "
             f"{NET_FILTERS} filters), bidirectional_lstm and bidirectional_gru (hidden "
             f"{NET_HIDDEN}), 3 steps card against CPU; img_conv_group and glu forward")
    t_start = time.perf_counter()
    rng = np.random.RandomState(seed + 59)
    feeds = [sentiment_feed(ptt, rng, **sb) for _ in range(3)]
    tokens = sum(int(f["words"].lengths.sum()) for f in feeds)
    out = {}
    for name, build in (("convolution_net", lambda: build_text_cnn(
            ptt, sb["vocab"], sb["emb"], NET_FILTERS, NET_LR)),
            ("bidirectional_lstm", lambda: build_bi_rnn(
                ptt, sb["vocab"], sb["emb"], NET_HIDDEN, NET_LR, "bidirectional_lstm",
                sb["max_len"])),
            ("bidirectional_gru", lambda: build_bi_rnn(
                ptt, sb["vocab"], sb["emb"], NET_HIDDEN, NET_LR, "bidirectional_gru",
                sb["max_len"]))):
        main_p, startup, loss = build()
        before = graph.counter_state()
        t0 = time.perf_counter()
        ok, reading = book_card_vs_cpu(ptt, main_p, startup, loss, feeds, seed, NET_LR, False)
        moved = graph.counter_delta(before, graph.counter_state())
        launches = {k: moved.get((m, f"{k}_launches"), 0) / 3 for m, names in
                    graph.LAUNCH_COUNTERS for k in ("lstm_fwd", "lstm_bwd", "gru_fwd",
                                                    "gru_bwd") if f"{k}_launches" in names}
        reading.update(launches_per_step=launches, seconds=time.perf_counter() - t0)
        out[name] = reading
        print(f"  {name}: {tokens} tokens over the 3 steps; B1-B4 launches a step on the card "
              f"{launches}; {reading['seconds']:.1f} s for both devices")
        check(ok, f"{name}: card and CPU differ beyond the bounds")
        want = NET_LAUNCHES.get(name, {})
        for k, c in launches.items():
            check(c == want.get(k, 0), f"{name}: {k} {c} a step, not {want.get(k, 0)}")

    rng = np.random.RandomState(seed + 60)
    img = rng.standard_normal((128, 3, 32, 32)).astype(np.float32)
    xg = rng.standard_normal((128, 1024)).astype(np.float32)
    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        group = ptt.networks.img_conv_group(ptt.layers.data("img", shape=[3, 32, 32]),
                                            conv_num_filter=[64, 64], conv_with_batchnorm=True,
                                            conv_batchnorm_drop_rate=0.0)
        g = ptt.networks.glu(ptt.layers.data("x", shape=[1024]))
    cs = ptt.Scope()
    ptt.Executor(device="cpu").run(startup, scope=cs, seed=seed)
    state = ptt.io.state_to_numpy(cs, [v.name for v in main.persistables()])
    res = {}
    for dev in ("cpu", CARD):
        sc = ptt.Scope()
        ptt.io.params_from_numpy(sc, state, dev)
        res[dev] = ptt.Executor(device=dev).run(main, {"img": img, "x": xg}, [group, g],
                                                scope=sc)
    errs = [float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max()))
            for a, b in zip(res[CARD], res["cpu"])]
    out["img_conv_group"] = dict(shape=list(res[CARD][0].shape), error=errs[0])
    out["glu"] = dict(shape=list(res[CARD][1].shape), error=errs[1])
    print(f"  img_conv_group [64, 64] with batch_norm: {list(res[CARD][0].shape)}, card against "
          f"CPU {errs[0]:.3e} of its scale; glu: {list(res[CARD][1].shape)}, {errs[1]:.3e} "
          f"(tol {OPS_TOL[None]:g})")
    check(list(res[CARD][0].shape) == [128, 64, 16, 16] and list(res[CARD][1].shape) == [128, 512],
          "img_conv_group or glu: wrong shape")
    check(max(errs) <= OPS_TOL[None], "img_conv_group or glu: card and CPU differ")
    out["seconds"] = time.perf_counter() - t_start
    print(f"  phase {n}: {out['seconds']:.1f} s")
    return out


# --------------------------------------------- recurrence and control flow --
# bench.py's lstm row (bench.py:266-290) as the reference's
# benchmark/paddle/rnn/rnn.py wrote it in v1: two stacked recurrences, each
# a recurrent_group whose step is an LSTM cell built from layers (fc on
# [x_t, h], the gates through sigmoid and tanh, memories h and c), the
# last step, fc to 2 classes; bf16, Adam(2e-3), L2Decay(8e-4),
# GradientClipByGlobalNorm(25). The fused path (lstm_benchmark_net, B1/B2)
# at the same widths is timed beside it, for the record
RG_LSTM = dict(vocab=30000, emb=128, hidden=512, seqlen=100, batch=128)
# the per-step loop's steps, and the window's K: 2 since PR 23 (4 before),
# which keeps the phase's checks and cuts about half its steps, to hold the
# whole script near 950 s
RG_STEPS = 2
# phase 61: the nested group over documents of sentences (card against CPU,
# f32): up to 8 sentences of up to 32 tokens, hidden 512
NESTED_DOCS = dict(docs=64, max_sents=8, max_words=32, vocab=30000, emb=128, hidden=512,
                   lr=0.5, steps=2)
# card against CPU in f32: losses within 1e-5 relative, every persistable
# within 1e-5 of its largest |value|, at least SURF_FLOOR, or, for an
# adaptive optimizer, 1% of its learning rate a step (a near-zero
# gradient's rounding, divided by its own magnitude). The floor: a bias
# that starts at 0 and whose gradient nearly cancels over the batch (a
# classifier's, Σ(p - y) / B) holds the f32 sums' order noise of about
# lr·ε·√B a step: 1.1e-8 beside a value of 9.6e-4 on the nested group's
# classifier bias, on an H100 (PERF.md, the recurrence slice's findings)
SURF_TOL, SURF_FLOOR, SURF_LR_SHARE, SURF_STEPS = 1e-5, 1e-2, 1e-2, 5
SURF_VOCAB = 20
# phase 63: the sequence ops at [SEQ_OPS_CAP x SEQ_OPS_W] over 64 sequences
SEQ_OPS_CAP, SEQ_OPS_W, SEQ_OPS_SEQS = 4096, 128, 64


def rg_lstm_cell(ptt, rnn, x_t, hidden):
    """One LSTM step written with layers, as v1's lstmemory_group: the
    gates from fc([x_t, h]), then c = σ(f)·c + σ(i)·tanh(g), h = σ(o)·tanh(c)."""
    L = ptt.layers
    h_prev = rnn.memory(shape=[hidden])
    c_prev = rnn.memory(shape=[hidden])
    gi, gf, go, gg = L.split(L.fc(L.concat([x_t, h_prev], axis=1), size=4 * hidden), 4, dim=1)
    c = L.elementwise_add(L.elementwise_mul(L.sigmoid(gf), c_prev),
                          L.elementwise_mul(L.sigmoid(gi), L.tanh(gg)))
    # split's outputs declare the input's [-1, 4H] (the JAX front end's
    # shapes): h is declared [-1, H] again for the next layer's fc
    h = L.reshape(L.elementwise_mul(L.sigmoid(go), L.tanh(c)), [-1, hidden])
    rnn.update_memory(h_prev, h)
    rnn.update_memory(c_prev, c)
    rnn.step_output(h)


def build_rg_lstm(ptt, vocab, emb, hidden, seqlen, **_):
    """The rg_lstm classifier through the port's front end: (main,
    startup, loss)."""
    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        words = ptt.layers.data("words", shape=[-1], dtype=np.int32, lod_level=1,
                                append_batch_size=False)
        label = ptt.layers.data("label", shape=[1], dtype=np.int32)
        seq = ptt.layers.embedding(words, size=[vocab, emb])
        for _ in range(2):
            rnn = ptt.layers.RecurrentGroup(max_len=seqlen)
            with rnn.step():
                rg_lstm_cell(ptt, rnn, rnn.step_input(seq), hidden)
            seq = rnn()
        logits = ptt.layers.fc(ptt.layers.sequence_last_step(seq), size=2)
        loss = ptt.layers.mean(ptt.layers.softmax_with_cross_entropy(logits, label))
        ptt.optimizer.Adam(learning_rate=LSTM_LR, regularization=ptt.regularizer.L2Decay(LSTM_L2),
                           grad_clip=ptt.optimizer.GradientClipByGlobalNorm(LSTM_CLIP)
                           ).minimize(loss)
    main.set_amp("bfloat16")
    return main, startup, loss


def rg_batches(ptt, rng, vocab, seqlen, batch, n, **_):
    """`n` batches of `batch` sequences of `seqlen` tokens (bench.py's
    lstm feed) and binary labels."""
    return [{"words": ptt.LoDArray.from_sequences(
        [rng.randint(0, vocab, (seqlen,)).astype(np.int32) for _ in range(batch)],
        capacity=batch * seqlen, max_seqs=batch),
        "label": rng.randint(0, 2, (batch, 1)).astype(np.int32)} for _ in range(n)]


def trainer_run(ptt, exe, main_p, startup, loss, state, batches, window):
    """One pass over `batches` through a fresh Trainer from `state`: (ms a
    step, the parameters after, the executor's cache stats moved, the
    costs)."""
    scope = ptt.Scope()
    tr = ptt.Trainer(loss, main_program=main_p, startup_program=startup, scope=scope,
                     executor=exe)
    tr.init()
    for k, v in state.items():
        scope.set(k, v.clone())
    costs = []
    cs0 = dict(exe.cache_stats)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.train(lambda: iter(batches), 1, log_interval=len(batches), scan_window=window,
             event_handler=lambda e: costs.append(e.cost) if isinstance(
                 e, ptt.EndIteration) else None)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    moved = {k: exe.cache_stats[k] - cs0[k] for k in ("captures", "replays", "eager_steps")}
    return ms, {p.name: scope.get(p.name).clone() for p in main_p.parameters()}, moved, \
        [float(c) for c in costs]


def rg_lstm_phase(ptt, smi, seed, n):
    """Phase n: the rg_lstm classifier at bench.py's lstm widths through the
    port's Trainer: the per-step loop, the fused path at the same widths
    beside it, then scan_window=RG_STEPS on the per-step loop's bits."""
    from paddle_tpu_torch.core import graph

    w = RG_LSTM
    phase(n, f"rg_lstm: the v1 rnn.py classifier with two recurrent_groups of layer-built LSTM "
             f"cells at bench.py's lstm widths (vocab {w['vocab']}, emb {w['emb']}, hidden "
             f"{w['hidden']}, B={w['batch']}, T={w['seqlen']}, bf16, Adam + L2Decay + global-norm "
             f"clip) through the port's Trainer; the fused path beside it; then "
             f"scan_window={RG_STEPS}")
    t_start = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    rng = np.random.RandomState(seed + 600)
    batches = rg_batches(ptt, rng, n=RG_STEPS, **w)
    tokens = w["batch"] * w["seqlen"]
    main_p, startup, loss = build_rg_lstm(ptt, **w)
    ops = [o.type for o in main_p.global_block().ops]
    step_ops = len(main_p.blocks[1].ops)
    exe = ptt.Executor()
    scope0 = ptt.Scope()
    exe.run(startup, scope=scope0, seed=seed)
    state = {k: scope0.get(k).clone() for k in scope0.keys()}
    del scope0
    print(f"  main program: {len(ops)} ops ({ops.count('recurrent_group')} recurrent_group, "
          f"{step_ops} ops in a step's sub-block, so {2 * w['seqlen'] * step_ops} step ops a "
          f"forward); {sum(v.numel() for v in state.values())} state values")
    before = graph.counter_state()
    warm_ms, _, _, warm_costs = trainer_run(ptt, exe, main_p, startup, loss, state,
                                            batches[:1], 0)
    p_ms, p_params, p_moved, p_costs = trainer_run(ptt, exe, main_p, startup, loss, state,
                                                   batches, 0)
    hand = graph.counter_delta(before, graph.counter_state())
    print(f"  warm-up pass of 1 step {warm_ms:.1f} ms; per-step loop: {p_ms:.3f} ms a step, "
          f"{tokens / p_ms * 1e3:.1f} tokens/s, costs {p_costs}; hand kernels launched "
          f"{hand or 'none'} on {smi}")
    check(all(np.isfinite(p_costs)) and p_costs[0] == warm_costs[0],
          "rg_lstm: a non-finite cost, or the first step's cost differs between two runs")
    check(p_moved["eager_steps"] == 0 and p_moved["captures"] == 0,
          f"rg_lstm: the per-step loop ran a window: {p_moved}")
    check(not hand, f"rg_lstm: a hand kernel ran in the layer-built path: {hand}")
    # the fused path (B1/B2) at the same widths, timed in this call
    f_main, f_startup, f_loss = build_lstm_program(ptt, **LSTM_BENCH)
    f_main.set_amp("bfloat16")
    fscope = ptt.Scope()
    exe.run(f_startup, scope=fscope, seed=seed)
    from paddle_tpu_torch.ops import lstm_kernels as lk
    exe.run(f_main, batches[0], [f_loss.name], scope=fscope)  # warm-up
    torch.cuda.synchronize()
    lk.lstm_fwd_launches = lk.lstm_bwd_launches = 0
    f_times = []
    for b in batches:
        t0 = time.perf_counter()
        exe.run(f_main, b, [f_loss.name], scope=fscope)
        torch.cuda.synchronize()
        f_times.append((time.perf_counter() - t0) * 1e3)
    fused_launches = {"lstm_fwd": lk.lstm_fwd_launches / len(batches),
                      "lstm_bwd": lk.lstm_bwd_launches / len(batches)}
    f_ms = statistics.median(f_times)
    print(f"  the fused path (lstm_benchmark_net, B1/B2) at the same widths: "
          f"{[round(t, 3) for t in f_times]} ms, median {f_ms:.3f} ms a step; launches a step "
          f"{fused_launches}; the group path {p_ms / f_ms:.2f}x its time, on {smi}")
    check(fused_launches == {"lstm_fwd": 2, "lstm_bwd": 2},
          f"the fused path: launches a step {fused_launches}")
    del fscope
    gc.collect()
    torch.cuda.empty_cache()

    # the window: one eager step, one capture, replays
    w_ms, w_params, w_moved, w_costs = trainer_run(ptt, exe, main_p, startup, loss, state,
                                                   batches, RG_STEPS)
    sg = next(sg for sg in exe._windows.values() if sg.program is main_p)
    p2_ms, _, _, _ = trainer_run(ptt, exe, main_p, startup, loss, state, batches, 0)
    w2_ms, w2_params, w2_moved, _ = trainer_run(ptt, exe, main_p, startup, loss, state, batches,
                                                RG_STEPS)
    print(f"  scan_window={RG_STEPS}: {w_ms:.3f} ms a step ({w_moved}, capture "
          f"{sg.capture_s:.3f} s); the per-step loop again {p2_ms:.3f} ms; the window again "
          f"{w2_ms:.3f} ms ({w2_moved}); costs {w_costs}")
    check(w_moved == {"captures": 1, "replays": RG_STEPS - 1, "eager_steps": 1},
          f"rg_lstm window: not one eager step, one capture and {RG_STEPS - 1} replays: {w_moved}")
    check(w2_moved == {"captures": 0, "replays": RG_STEPS, "eager_steps": 0},
          f"rg_lstm window again: {w2_moved}")
    for label, got in (("window", w_params), ("window again", w2_params)):
        d = first_differing(got, p_params)
        check(d is None, f"rg_lstm {label}: parameter {d} differs from the per-step loop's")
    check(w_costs == p_costs, f"rg_lstm window costs {w_costs} != per-step {p_costs}")
    # under torch.profiler last: a profile may leave the launches slower after it
    prof_scope = ptt.Scope()
    for k, v in state.items():
        prof_scope.set(k, v.clone())
    run = lambda: exe.run(main_p, batches[0], [loss.name], scope=prof_scope)  # noqa: E731
    run()
    wall, busy, _, _, nev = profile_pass(run, [])
    print(f"  profiled per-step step: wall {wall:.3f} ms, device busy {busy:.3f} ms "
          f"({100 * busy / wall:.1f}%), {nev} device events")
    del run, prof_scope
    wwall, wbusy, _, _, wnev = profile_pass(lambda: trainer_run(
        ptt, exe, main_p, startup, loss, state, batches, RG_STEPS), [])
    print(f"  profiled window pass of {RG_STEPS} steps: wall {wwall:.3f} ms, device busy "
          f"{wbusy:.3f} ms ({100 * wbusy / wwall:.1f}%), {wnev} device events")
    per_step = statistics.mean([p_ms, p2_ms])
    out = dict(ms_per_step=per_step, per_step_runs_ms=[p_ms, p2_ms], window_ms=w2_ms,
               first_window_ms=w_ms, capture_s=sg.capture_s, fused_ms=f_ms,
               fused_steps_ms=f_times, fused_launches_per_step=fused_launches,
               tokens_per_step=tokens, costs=p_costs, step_ops=step_ops,
               profiled_per_step=dict(wall_ms=wall, busy_ms=busy, busy_share=busy / wall,
                                      device_events=nev),
               profiled_window=dict(wall_ms=wwall, busy_ms=wbusy, busy_share=wbusy / wwall,
                                    device_events=wnev, steps=RG_STEPS),
               window_same_bits=True)
    print(f"  rg_lstm at B={w['batch']}, T={w['seqlen']}, H={w['hidden']} bf16: per-step "
          f"{per_step:.3f} ms a step, window {w2_ms:.3f} ms ({per_step / w2_ms:.2f}x), the fused "
          f"path {f_ms:.3f} ms ({per_step / f_ms:.2f}x faster than per-step); the window's "
          f"steps are the per-step loop's bits; on {smi}")
    exe._windows.clear()
    del sg
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_start
    print(f"  phase {n}: {out['seconds']:.1f} s")
    return out


def build_nested_docs(ptt, vocab, emb, hidden, max_sents, max_words, lr, **_):
    """A hierarchical classifier: each sentence's words embedded and
    mean-pooled inside a NestedRecurrentGroup whose memory carries a
    document state over the sentences (h = tanh(fc([mean, h]))), the last
    state to 2 classes; SGD. (main, startup, loss, the group's output)."""
    L = ptt.layers
    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        words = L.data("words", shape=[-1], dtype=np.int32, lod_level=2,
                       append_batch_size=False)
        label = L.data("label", shape=[1], dtype=np.int32)
        e = L.embedding(words, size=[vocab, emb])
        rnn = L.NestedRecurrentGroup(max_subseqs=max_sents, max_sublen=max_words)
        with rnn.step():
            sub, sub_mask = rnn.step_input(e)
            h_prev = rnn.memory(shape=[hidden])
            mk = L.cast(sub_mask, np.float32)
            summed = L.reduce_sum(L.elementwise_mul(sub, mk, axis=0), dim=1)
            mean = L.elementwise_div(summed, L.clip(L.reduce_sum(mk, dim=1), 1.0, 1e9), axis=0)
            h = L.fc(L.concat([mean, h_prev], axis=1), size=hidden, act="tanh")
            rnn.update_memory(h_prev, h)
            rnn.step_output(h)
        out = rnn()
        logits = L.fc(L.sequence_last_step(out), size=2)
        loss = L.mean(L.softmax_with_cross_entropy(logits, label))
        ptt.optimizer.SGD(learning_rate=lr).minimize(loss)
    return main, startup, loss, out


def nested_docs_feed(ptt, rng, docs, max_sents, max_words, vocab, **_):
    """`docs` documents of 1..max_sents + 2 sentences of 1..max_words + 4
    words: some cut by max_subseqs and max_sublen."""
    nested = [[rng.randint(0, vocab, (rng.randint(1, max_words + 5),)).astype(np.int32)
               for _ in range(rng.randint(1, max_sents + 3))] for _ in range(docs)]
    cap = sum(len(s) for d in nested for s in d)
    return {"words": ptt.LoDArray.from_nested_sequences(nested, capacity=cap, max_seqs=docs),
            "label": rng.randint(0, 2, (docs, 1)).astype(np.int32)}


def build_while_program(ptt, train):
    """A While over feeds n and x: i counts to n, s sums 0..n-1 (int32),
    v <- v/2 + w with w = fc(x) a parameter the block closes over.
    (main, startup, (s, v)); with `train`, a regression loss beside it that
    no While output reaches, SGD: (main, startup, (loss,))."""
    L = ptt.layers
    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        nv = L.data("n", shape=[1], dtype=np.int32, append_batch_size=False)
        x = L.data("x", shape=[64])
        w = L.fc(x, size=64, bias_attr=False)
        i = L.fill_constant([1], np.int32, 0)
        s = L.fill_constant([1], np.int32, 0)
        v = L.fill_constant([1, 64], np.float32, 0.25)
        c = L.less_than(i, nv)
        loop = L.While(cond=c)
        with loop.block():
            i2 = L.increment(i)
            loop.update(i, i2)
            loop.update(s, L.elementwise_add(s, i))
            loop.update(v, L.elementwise_add(L.scale(v, scale=0.5), w))
            loop.update(c, L.less_than(i2, nv))
        _, s_fin, v_fin, _ = loop()
        if not train:
            return main, startup, (s_fin, v_fin)
        y = L.data("y", shape=[1])
        loss = L.mean(L.square_error_cost(L.fc(x, size=1), y))
        ptt.optimizer.SGD(learning_rate=0.01).minimize(loss)
    return main, startup, (loss,)


def card_vs_cpu(ptt, main_p, startup, fetches, feeds, seed, lr_share=0.0):
    """`main_p` from one CPU startup state on the CPU and the card over
    `feeds` (f32): (the largest relative difference of the first fetch
    over the steps, the largest difference of a persistable over its
    scale's bound, both devices' first fetches, both devices' state). The
    bound: SURF_TOL of the largest |value| (at least SURF_FLOOR), or
    `lr_share` where larger."""
    cs = ptt.Scope()
    ptt.Executor(device="cpu").run(startup, scope=cs, seed=seed)
    persist = [v.name for v in main_p.persistables() if cs.has(v.name)]
    state = ptt.io.state_to_numpy(cs, persist)
    res = {}
    for dev in ("cpu", CARD):
        sc = ptt.Scope()
        ptt.io.params_from_numpy(sc, state, dev)
        exe = ptt.Executor(device=dev)
        firsts = [exe.run(main_p, f, fetches, scope=sc)[0] for f in feeds]
        res[dev] = (firsts, ptt.io.state_to_numpy(sc, persist))
    (cf, cst), (gf, gst) = res["cpu"], res[CARD]
    fetch_err = max(float(np.abs(np.asarray(g, np.float64) - c).max())
                    / max(1e-30, float(np.abs(c).max())) for c, g in zip(cf, gf))
    errs = {k: float(np.abs(gst[k] - v).max()) / max(SURF_TOL * max(float(np.abs(v).max()),
                                                                     SURF_FLOOR), lr_share)
            for k, v in cst.items() if v.size}
    worst = max(errs, key=errs.get)
    v = cst[worst]
    print(f"    the worst persistable: {worst} {tuple(v.shape)}, |card - cpu| "
          f"{float(np.abs(gst[worst] - v).max()):.3e}, max |value| {float(np.abs(v).max()):.3e}, "
          f"max |update| {float(np.abs(v - state[worst]).max()):.3e}")
    return fetch_err, errs[worst], cf, gf, cst, gst


def _capture_error(exc):
    """The ControlFlowCaptureError in an exception's chain, or None."""
    from paddle_tpu_torch.ops.control_flow_ops import ControlFlowCaptureError

    while exc is not None and not isinstance(exc, ControlFlowCaptureError):
        exc = exc.__cause__
    return exc


def control_flow_phase(ptt, smi, seed, n):
    """Phase n: a NestedRecurrentGroup over documents card against CPU, a
    While card against CPU and inside a captured window (a named error),
    and a cond training step in which only the taken branch moves."""
    d = NESTED_DOCS
    L = ptt.layers
    phase(n, f"nested recurrence, While and cond: a NestedRecurrentGroup over {d['docs']} "
             f"documents of up to {d['max_sents']} sentences of up to {d['max_words']} words "
             f"(hidden {d['hidden']}, f32, {d['steps']} SGD steps) card against CPU; While "
             f"card against CPU and in a captured window; a cond training step")
    t_start = time.perf_counter()
    rng = np.random.RandomState(seed + 610)
    main_p, startup, loss, out_v = build_nested_docs(ptt, **d)
    feeds = [nested_docs_feed(ptt, rng, **d) for _ in range(d["steps"])]
    t0 = time.perf_counter()
    lerr, serr, cl, gl, _, _ = card_vs_cpu(ptt, main_p, startup, [loss.name, out_v.name], feeds,
                                           seed)
    subs = [int((f["words"].sub_seq_ids.max() + 1)) for f in feeds]
    print(f"  nested group: {subs} sentences over the {d['steps']} batches ({d['docs']} "
          f"documents each); losses cpu {[float(c) for c in cl]} card {[float(g) for g in gl]}: "
          f"{lerr:.3e} apart relative (tol {SURF_TOL:g}); every persistable within "
          f"{serr:.3f} of its bound; {time.perf_counter() - t0:.1f} s for both devices")
    check(lerr <= SURF_TOL and serr <= 1.0, "the nested group: card and CPU differ")
    out = dict(nested=dict(loss_rel=lerr, state_over_bound=serr, sentences=subs))

    # While: sum(0..n-1) in int32 and a float loop closing over a parameter
    wmain, wstart, (s_fin, v_fin) = build_while_program(ptt, train=False)
    xv = np.random.RandomState(seed + 611).rand(1, 64).astype(np.float32)
    wfeeds = [{"n": np.array([k], np.int32), "x": xv} for k in (0, 1, 40)]
    werr, _, wc, wg, _, _ = card_vs_cpu(ptt, wmain, wstart, [v_fin.name], wfeeds, seed)
    cscope = ptt.Scope()
    ptt.Executor(device=CARD).run(wstart, scope=cscope, seed=seed)
    sums = [int(ptt.Executor(device=CARD).run(wmain, f, [s_fin.name], scope=cscope)[0][0])
            for f in wfeeds]
    print(f"  While on the card: sum(0..n-1) for n = 0, 1, 40: {sums}; the float loop card "
          f"against CPU {werr:.3e} apart relative (tol {SURF_TOL:g})")
    check(sums == [0, 0, 780], f"While: sums {sums}")
    check(werr <= SURF_TOL, "While: card and CPU differ")
    out["while"] = dict(sums=sums, rel=werr)

    # the same While, and a cond, in a training step inside a captured
    # window: the named error
    def windowed(kind):
        if kind == "while":
            m2, s2, (lo,) = build_while_program(ptt, train=True)
        else:
            ptt.reset_default_programs()
            m2, s2 = ptt.Program(), ptt.Program()
            with ptt.program_guard(m2, s2):
                x = L.data("x", shape=[64])
                y = L.data("y", shape=[1])
                p = L.data("p", shape=[1], dtype=np.bool_, append_batch_size=False)
                lo = L.mean(L.square_error_cost(L.fc(x, size=1), y))
                lo = L.cond(p, lambda: L.scale(lo, 1.0), lambda: L.scale(lo, 2.0))
                ptt.optimizer.SGD(learning_rate=0.01).minimize(lo)
        r = np.random.RandomState(seed + 612)
        bs = [dict({"x": r.rand(16, 64).astype(np.float32),
                    "y": r.rand(16, 1).astype(np.float32)},
                   **({"p": np.array([True])} if kind == "cond" else
                      {"n": np.array([40], np.int32)})) for _ in range(4)]
        tr = ptt.Trainer(lo, main_program=m2, startup_program=s2, scope=ptt.Scope())
        try:
            tr.train(lambda: iter(bs), 1, scan_window=4, log_interval=4)
        except RuntimeError as e:
            err = _capture_error(e)
            check(err is not None, f"{kind} in a window raised, but not ControlFlowCaptureError: "
                                   f"{e}")
            print(f"  {kind} in scan_window=4: {type(err).__name__}: {str(err)[:120]}")
            return str(err)
        check(False, f"{kind} ran inside a captured window without raising")

    out["capture_errors"] = {k: windowed(k) for k in ("while", "cond")}
    check(torch.cuda.is_current_stream_capturing() is False, "a capture was left open")

    # cond: three SGD steps, its untaken branch 0/0 were it taken
    ptt.reset_default_programs()
    cmain, cstart = ptt.Program(), ptt.Program()
    with ptt.program_guard(cmain, cstart):
        x = L.data("x", shape=[256])
        p = L.data("p", shape=[1], dtype=np.bool_, append_batch_size=False)
        y = L.data("y", shape=[1])
        h1 = L.fc(L.fc(x, size=512, act="tanh"), size=1, param_attr="w_true")
        h2 = L.fc(x, size=1, param_attr="w_false")
        o = L.cond(p, lambda: L.scale(h1, 1.0),
                   lambda: L.elementwise_div(L.scale(h2, 0.0), L.scale(h2, 0.0)))
        closs = L.mean(L.square_error_cost(o, y))
        ptt.optimizer.SGD(learning_rate=0.1).minimize(closs)
    r = np.random.RandomState(seed + 613)
    cfeeds = [{"x": r.randn(128, 256).astype(np.float32), "y": r.randn(128, 1).astype(np.float32),
               "p": np.array([True])} for _ in range(3)]
    cerr, cserr, ccl, cgl, cst, gst = card_vs_cpu(ptt, cmain, cstart, [closs.name], cfeeds, seed)
    cs0 = ptt.Scope()
    ptt.Executor(device="cpu").run(cstart, scope=cs0, seed=seed)
    w_false0 = cs0.get("w_false").numpy()
    moved = not np.array_equal(gst["w_true"], cs0.get("w_true").numpy())
    print(f"  cond, 3 SGD steps on the card: losses {[float(c) for c in cgl]} (cpu "
          f"{[float(c) for c in ccl]}, {cerr:.3e} apart); w_true moved {moved}, w_false the "
          f"startup's bits {np.array_equal(gst['w_false'], w_false0)}")
    check(all(np.isfinite([float(c) for c in cgl])), "cond: a non-finite loss")
    check(moved and np.array_equal(gst["w_false"], w_false0),
          "cond: the untaken branch's weight moved, or the taken one did not")
    check(cerr <= SURF_TOL and cserr <= 1.0, "cond: card and CPU differ")
    out["cond"] = dict(loss_rel=cerr, state_over_bound=cserr)
    out["seconds"] = time.perf_counter() - t_start
    print(f"  phase {n}: {out['seconds']:.1f} s")
    return out


def surface_cases():
    """{case: (optimizer, its kwargs, options)} of phase 62: every new
    optimizer, schedule and clip, ModelAverage, the per-parameter lr and
    clips, StaticPruningHook, and each SelectedRows branch."""
    return {
        "adagrad": ("Adagrad", dict(learning_rate=0.01), {}),
        "adadelta": ("Adadelta", dict(learning_rate=1.0, rho=0.9), {}),
        "rmsprop": ("RMSProp", dict(learning_rate=0.001, momentum=0.9), {}),
        "decayed_adagrad": ("DecayedAdagrad", dict(learning_rate=0.01), {}),
        "adamax": ("Adamax", dict(learning_rate=0.01), {}),
        "ftrl": ("Ftrl", dict(learning_rate=0.01, l1=0.01, l2=0.01), {}),
        "ftrl_power": ("Ftrl", dict(learning_rate=0.01, l1=0.001, lr_power=-0.6), {}),
        "exponential": ("SGD", dict(learning_rate=0.1), {"schedule": (
            "ExponentialDecay", dict(decay_steps=2, decay_rate=0.5, staircase=True))}),
        "natural_exp": ("Momentum", dict(learning_rate=0.05), {"schedule": (
            "NaturalExpDecay", dict(decay_steps=2, decay_rate=0.3))}),
        "inverse_time": ("SGD", dict(learning_rate=0.1), {"schedule": (
            "InverseTimeDecay", dict(decay_steps=1, decay_rate=0.5))}),
        "polynomial": ("Adam", dict(learning_rate=0.01), {"schedule": (
            "PolynomialDecay", dict(decay_steps=2, end_learning_rate=0.01, power=2.0,
                                    cycle=True))}),
        "piecewise": ("SGD", dict(learning_rate=0.1), {"schedule": (
            "PiecewiseDecay", dict(boundaries=[2, 4], values=[0.1, 0.05, 0.01]))}),
        "clip_value": ("SGD", dict(learning_rate=0.1), {"clip": ("GradientClipByValue", (0.02,))}),
        "clip_norm": ("Momentum", dict(learning_rate=0.05),
                      {"clip": ("GradientClipByNorm", (0.05,))}),
        "clip_global": ("Adagrad", dict(learning_rate=0.01),
                        {"clip": ("GradientClipByGlobalNorm", (0.05,))}),
        "param_clip_lr": ("Momentum", dict(learning_rate=0.05), {"param": True}),
        "pruning": ("Adam", dict(learning_rate=0.01), {"prune": 0.5}),
        "model_average": ("SGD", dict(learning_rate=0.1), {"average": True}),
        **{f"sparse_{k.lower()}": (k, dict(learning_rate=lr), {"sparse": True}) for k, lr in
           (("SGD", 0.1), ("Momentum", 0.05), ("Adagrad", 0.01), ("Adam", 0.01))},
    }


def build_surface(ptt, opt, kw, opts):
    """x [64] (+ an is_sparse embedding) -> fc 128 tanh -> fc 1 -> squared
    error, trained by `opt` with the case's surfaces: (main, startup, loss,
    ModelAverage or None)."""
    L, O = ptt.layers, ptt.optimizer
    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        x = L.data("x", shape=[64])
        y = L.data("y", shape=[1])
        w1 = ptt.ParamAttr(name="w1", learning_rate=0.5 if opts.get("param") else 1.0,
                           gradient_clip=O.GradientClipByValue(0.05) if opts.get("param")
                           else None,
                           update_hooks=[ptt.param_attr.StaticPruningHook(opts["prune"])]
                           if "prune" in opts else None)
        w2 = ptt.ParamAttr(name="w2", gradient_clip=O.GradientClipByNorm(0.1)
                           if opts.get("param") else None)
        h = L.fc(x, size=128, act="tanh", param_attr=w1)
        if opts.get("sparse"):
            ids = L.data("ids", shape=[1], dtype=np.int64)
            e = L.embedding(ids, size=[SURF_VOCAB, 128], is_sparse=True, param_attr="emb")
            h = L.elementwise_add(h, L.reshape(e, [-1, 128]))
        loss = L.mean(L.square_error_cost(L.fc(h, size=1, param_attr=w2), y))
        kw = dict(kw)
        if "schedule" in opts:
            name, skw = opts["schedule"]
            kw["lr_schedule"] = getattr(O, name)(**skw)
        if "clip" in opts:
            kw["grad_clip"] = getattr(O, opts["clip"][0])(*opts["clip"][1])
        if opts.get("sparse"):
            kw.update(regularization=ptt.regularizer.L2Decay(0.1),
                      grad_clip=O.GradientClipByValue(0.02))
        getattr(O, opt)(**kw).minimize(loss)
        avg = O.ModelAverage(0.5, min_average_window=2, max_average_window=3) \
            if opts.get("average") else None
    return main, startup, loss, avg


def optimizer_surfaces_phase(ptt, smi, seed, n):
    """Phase n: each new optimizer, schedule and clip, ModelAverage,
    ParamAttr(learning_rate), StaticPruningHook and the SelectedRows
    branches, SURF_STEPS steps card against CPU in f32."""
    phase(n, f"the optimizer surfaces: {len(surface_cases())} programs (x [64] -> fc 128 -> fc "
             f"1, B=128), {SURF_STEPS} steps each card against CPU in f32")
    t_start = time.perf_counter()
    rng = np.random.RandomState(seed + 620)
    feeds = [{"x": rng.randn(128, 64).astype(np.float32), "y": rng.randn(128, 1).astype(np.float32),
              "ids": rng.randint(0, SURF_VOCAB // 2, (128, 1)).astype(np.int64)}
             for _ in range(SURF_STEPS)]
    out, worst = {}, (0.0, 0.0)
    adaptive = {"Adagrad", "Adadelta", "RMSProp", "DecayedAdagrad", "Adamax", "Adam", "Ftrl"}
    for case, (opt, kw, opts) in surface_cases().items():
        main_p, startup, loss, avg = build_surface(ptt, opt, kw, opts)
        fs = feeds if opts.get("sparse") else [{k: v for k, v in f.items() if k != "ids"}
                                               for f in feeds]
        share = SURF_LR_SHARE * kw["learning_rate"] * SURF_STEPS if opt in adaptive else 0.0
        lerr, serr, cl, gl, cst, gst = card_vs_cpu(ptt, main_p, startup, [loss.name], fs, seed,
                                                   share)
        extra = ""
        if avg is not None:  # the averages on the card against the CPU's
            sc = ptt.Scope()
            ptt.io.params_from_numpy(sc, gst, CARD)
            avg.apply(None, sc)
            got = {p.name: sc.get(p.name).cpu().numpy() for p in main_p.parameters()}
            want = {p.name: cst[f"@AVG@.{p.name}"] / max(float(cst[f"@AVG_N@.{p.name}"]), 1.0)
                    for p in main_p.parameters()}
            aerr = max(float(np.abs(got[k] - v).max()) / max(float(np.abs(v).max()), 1e-3)
                       for k, v in want.items())
            avg.restore(None, sc)
            extra = f", averages {aerr:.3e}"
            check(aerr <= SURF_TOL, f"{case}: the averages differ card against CPU")
        if "prune" in opts:
            m = gst["w1@PRUNE_MASK"]
            zeros = int((m == 0).sum())
            extra = f", mask zeros {zeros} of {m.size}, masked weights zero " \
                    f"{bool(np.all(gst['w1'][m == 0] == 0))}"
            check(zeros == round(opts["prune"] * m.size) and np.all(gst["w1"][m == 0] == 0),
                  f"{case}: the mask or the masked weights")
        if opts.get("sparse"):
            untouched = sorted(set(range(SURF_VOCAB)) - {int(i) for f in feeds
                                                         for i in f["ids"].ravel()})
            same = np.array_equal(gst["emb"][untouched], cst["emb"][untouched])
            extra = f", untouched rows {len(untouched)} kept {same}"
        print(f"  {case}: losses card {[round(float(g), 6) for g in gl]}, {lerr:.2e} from the "
              f"CPU's; state {serr:.3f} of its bound{extra}")
        check(all(np.isfinite([float(g) for g in gl])), f"{case}: a non-finite loss")
        check(lerr <= SURF_TOL and serr <= 1.0, f"{case}: card and CPU differ")
        out[case] = dict(loss_rel=lerr, state_over_bound=serr)
        worst = (max(worst[0], lerr), max(worst[1], serr))
    out["seconds"] = time.perf_counter() - t_start
    print(f"  {len(surface_cases())} programs: the largest loss difference {worst[0]:.3e} "
          f"relative (tol {SURF_TOL:g}), the largest state difference {worst[1]:.3f} of its "
          f"bound; phase {n}: {out['seconds']:.1f} s")
    return out


def seq_op_cases(rng):
    """(op, {slot: ("lod", seqs) | ("nested", docs) | array}, attrs, the
    float slots differentiated) for the 10 sequence op types."""
    lens = rng.randint(1, 2 * SEQ_OPS_CAP // SEQ_OPS_SEQS, SEQ_OPS_SEQS)
    lens = (lens * SEQ_OPS_CAP // max(int(lens.sum()), SEQ_OPS_CAP)).clip(1)
    seqs = lambda d: ("lod", [rng.standard_normal((int(m), d)).astype(np.float32)  # noqa: E731
                              for m in lens])
    ties = ("lod", [np.round(rng.rand(int(m), 1) * 4).astype(np.float32) for m in lens])
    ids = ("lod", [rng.randint(0, 8, (int(m), 1)).astype(np.int32) for m in lens])
    docs = ("nested", [[rng.standard_normal((int(k), SEQ_OPS_W)).astype(np.float32)
                        for k in rng.randint(1, SEQ_OPS_CAP // SEQ_OPS_SEQS // 2,
                                             rng.randint(1, 5))]
                       for _ in range(SEQ_OPS_SEQS)])
    n_subs = sum(len(d) for d in docs[1])
    return [
        ("sequence_softmax", {"X": seqs(1)}, {}, ("X",)),
        ("sequence_expand", {"X": rng.standard_normal((SEQ_OPS_SEQS, SEQ_OPS_W)).astype(
            np.float32), "Y": seqs(4)}, {}, ("X",)),
        ("sequence_last_step", {"X": seqs(SEQ_OPS_W)}, {}, ("X",)),
        ("sequence_slice", {"X": seqs(SEQ_OPS_W),
                            "Offset": rng.randint(0, 4, SEQ_OPS_SEQS).astype(np.int32),
                            "Length": rng.randint(0, 40, SEQ_OPS_SEQS).astype(np.int64)}, {},
         ("X",)),
        ("sequence_reshape", {"X": seqs(SEQ_OPS_W)}, {"new_dim": SEQ_OPS_W // 4}, ("X",)),
        ("sequence_reverse", {"X": seqs(SEQ_OPS_W)}, {}, ("X",)),
        ("kmax_seq_score", {"X": ties}, {"beam_size": 5}, ()),
        ("sub_nested_seq", {"X": docs, "Selection": rng.permutation(n_subs)[:40].astype(
            np.int32)}, {}, ("X",)),
        ("featmap_expand", {"X": seqs(SEQ_OPS_W)}, {"num_filters": 4}, ("X",)),
        ("eos_id", {"X": ids}, {"eos_id": 3}, ()),
    ]


def run_seq_op(ptt, dev, op_type, inputs, attrs, diff):
    """One sequence op on `dev`: its output's tensors (data, and seq_ids,
    lengths, num_seqs of a LoD output) and the gradients of Σ out·cot for
    the `diff` slots, as numpy."""
    from paddle_tpu_torch.core import registry as treg
    from paddle_tpu_torch.core.program import Operator

    env, leaves = {"@AMP@": None}, []
    for slot, v in inputs.items():
        if isinstance(v, tuple):
            make = ptt.LoDArray.from_nested_sequences if v[0] == "nested" else \
                ptt.LoDArray.from_sequences
            total = sum(len(q) for d in v[1] for q in (d if v[0] == "nested" else [d]))
            t = make(v[1], capacity=max(2 * SEQ_OPS_CAP, total), max_seqs=len(v[1]) + 1,
                     device=dev)
            if slot in diff:
                t = t.with_data(t.data.clone().requires_grad_(True))
                leaves.append(t.data)
        else:
            t = torch.as_tensor(v, device=dev)
            if slot in diff:
                t = t.clone().requires_grad_(True)
                leaves.append(t)
        env[slot] = t
    with torch.enable_grad():
        treg.get_kernel(op_type)(treg.OpContext(
            Operator(op_type, {k: [k] for k in inputs}, {"Out": ["out"]}, dict(attrs)), env))
        o = env["out"]
        parts = [o.data, o.seq_ids, o.lengths, o.num_seqs] if isinstance(o, ptt.LoDArray) \
            else [o]
        grads = []
        if leaves:
            cot = torch.as_tensor(np.random.RandomState(1).standard_normal(
                tuple(parts[0].shape)).astype(np.float32), device=dev)
            grads = torch.autograd.grad((parts[0].float() * cot).sum(), leaves)
    return [p.detach().cpu().numpy() for p in parts], [g.cpu().numpy() for g in grads]


def sequence_ops_phase(ptt, smi, seed, n):
    """Phase n: the 10 sequence op types card against CPU, outputs and
    gradients, f32."""
    phase(n, f"the sequence ops, card against CPU: {SEQ_OPS_SEQS} sequences over about "
             f"{SEQ_OPS_CAP} tokens, width {SEQ_OPS_W}; outputs (layouts exact) and gradients")
    t_start = time.perf_counter()
    rng = np.random.RandomState(seed + 630)
    out, worst = {}, 0.0
    for op, inputs, attrs, diff in seq_op_cases(rng):
        (co, cg), (go, gg) = (run_seq_op(ptt, dev, op, inputs, attrs, diff)
                              for dev in ("cpu", CARD))
        errs = []
        for c, g in zip(co + cg, go + gg):
            check(c.shape == g.shape and c.dtype == g.dtype, f"{op}: shapes or dtypes differ")
            if np.issubdtype(c.dtype, np.floating):
                errs.append(float(np.abs(g - c).max()) / max(1.0, float(np.abs(c).max()))
                            if c.size else 0.0)
            else:
                check(np.array_equal(c, g), f"{op}: an integer output differs card against CPU")
        err = max(errs, default=0.0)
        worst = max(worst, err)
        out[op] = dict(error=err, shape=list(go[0].shape))
        print(f"  {op}: output {list(go[0].shape)} {go[0].dtype}, {len(gg)} gradient(s); "
              f"largest error {err:.3e} of its scale (tol {OPS_TOL[None]:g})")
        check(err <= OPS_TOL[None], f"{op}: card and CPU differ")
    out["seconds"] = time.perf_counter() - t_start
    print(f"  10 op types: the largest error {worst:.3e}; phase {n}: {out['seconds']:.1f} s")
    return out


# ------------------------------------- the last op families (phases 64-67) --
# phase 64: DeepSpeech2's input (161-bin linear spectrogram frames, 20 ms
# windows at a 10 ms stride) and a character CTC head: 28 characters
# (a-z, space, apostrophe), blank 28; B=32 utterances of 200-800 frames,
# labels of 20-120 characters, at most half the frames; fc 161 -> 512 relu,
# networks.bidirectional_gru (hidden 512, B3/B4 f32), row_conv (4 frames
# of lookahead), fc -> 29, warpctc(norm_by_times), Adam 5e-4
CTC = dict(batch=32, feat=161, hidden=512, classes=29, min_frames=200, max_frames=800,
           min_label=20, max_label=120, lookahead=4, lr=5e-4)
CTC_STEPS = 3  # timed steps; the window takes CTC_WINDOW batches
CTC_WINDOW = 4
CTC_YARDSTICK_TOL = 1e-3  # the op against F.ctc_loss, relative to each loss
# phase 65: SSD300 (Liu et al. 2016) on VOC's 21 classes: VGG16's six
# source maps, their prior settings, 3x3 heads; B=32, up to 64 ground-truth
# boxes an image
SSD = dict(batch=32, classes=21, image=300, max_gt=64,
           maps=((512, 38), (1024, 19), (512, 10), (256, 5), (256, 3), (256, 1)),
           min_sizes=(30, 60, 111, 162, 213, 264), max_sizes=(60, 111, 162, 213, 264, 315),
           aspect_ratios=([2], [2, 3], [2, 3], [2, 3], [2], [2]),
           variances=[0.1, 0.1, 0.2, 0.2], lr=0.001, momentum=0.9)
SSD_PRIORS = 8732
SSD_STEPS = 3
SSD_CPU_BATCH = 2  # the loss and the rows card against CPU
SSD_ROW_MATCH = 0.99  # share of the card's rows the CPU's rows match (see ssd_phase)
# phase 66: a Criteo-shaped CTR model: 13 dense features, 26 categorical
# ones hashed into one sparse_binary slot of 1,000,000 columns; B=1024
CTR = dict(batch=1024, dense=13, fields=26, dim=1_000_000, deep=(256, 256, 128), lr=1e-3)
CTR_STEPS = 4
# the step's device time by kind (breakdown's first matching substring)
CTR_KINDS = {"embedding (the sparse gather and its backward)": ("embedding", "indexSelect"),
             "segment_reduce": ("segment",), "adam and elementwise": ("elementwise", "foreach"),
             "gemm": ("gemm", "sm90", "cutlass"), "copies and fills": ("copy", "fill", "memset")}
# phase 67: the cost and misc ops at realistic widths
MISC_ROWS, MISC_WIDTH = 128, 1024
ROI = dict(channels=512, h=38, w=50, bins=7, scale=1 / 16, cpu_rois=16, card_rois=128)
NCE_CLASSES, NCE_WIDTH, NCE_BATCH, NCE_NEG = 30000, 512, 1024, 10
MISC_OP_TYPES = 44  # the 11 of ops/cost_ops.py and the 33 new of ops/misc_ops.py
VOL = (8, 64, 16, 56, 56)  # conv3d and pool3d: B, channels, depth, height, width


def ctc_batches(ptt, rng, n, batch, feat, classes, min_frames, max_frames, min_label,
                max_label, **_):
    """`n` batches of ragged utterances: spectrogram-like frames (log of a
    chi-square draw, as a power spectrum's) and character labels, each at
    most half its frames, none of them the blank (classes - 1)."""
    out = []
    for _ in range(n):
        frames = rng.randint(min_frames, max_frames + 1, batch)
        frames[0] = max_frames
        labels = [rng.randint(0, classes - 1, min(rng.randint(min_label, max_label + 1),
                                                  f // 2)).astype(np.int32) for f in frames]
        specs = [np.log(rng.chisquare(2, (f, feat)) + 1e-3).astype(np.float32) for f in frames]
        out.append({
            "spec": ptt.LoDArray.from_sequences(specs, capacity=batch * max_frames,
                                                max_seqs=batch),
            "chars": ptt.LoDArray.from_sequences([y[:, None] for y in labels],
                                                 capacity=batch * max_label, max_seqs=batch)})
    return out


def build_ctc_model(ptt, feat, hidden, classes, lookahead, lr, max_frames, max_label, **_):
    """The phase's acoustic model: (main, startup, loss, logits, decoded
    ids, decoded lengths)."""
    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    L = ptt.layers
    with ptt.program_guard(main, startup):
        spec = L.data("spec", shape=[feat], lod_level=1)
        chars = L.data("chars", shape=[1], dtype=np.int32, lod_level=1)
        h = L.fc(spec, size=hidden, act="relu")
        g = ptt.networks.bidirectional_gru(h, size=hidden, max_len=max_frames)
        r = L.row_conv(g, future_context_size=lookahead)
        logits = L.fc(r, size=classes)
        loss = L.mean(L.warpctc(logits, chars, blank=classes - 1, norm_by_times=True,
                                max_len=max_frames, max_label_len=max_label))
        ids, lengths = L.ctc_greedy_decoder(logits, blank=classes - 1, max_len=max_frames)
        ptt.optimizer.Adam(learning_rate=lr).minimize(loss)
    return main, startup, loss, logits, ids, lengths


def ctc_phase(ptt, smi, seed, n):
    """Phase n: the CTC acoustic model through the port's Trainer (the
    per-step loop, run twice, then scan_window), its decode scored by
    EditDistance, and the op timed beside F.ctc_loss."""
    import torch.nn.functional as F

    from paddle_tpu_torch.core import graph
    from paddle_tpu_torch.core import registry as treg
    from paddle_tpu_torch.core.program import Operator
    from paddle_tpu_torch.ops import ctc_ops

    c = CTC
    phase(n, f"CTC acoustic model (DeepSpeech2's input): B={c['batch']} utterances of "
             f"{c['min_frames']}-{c['max_frames']} frames of {c['feat']} bins, labels of "
             f"{c['min_label']}-{c['max_label']} of {c['classes'] - 1} characters; fc "
             f"{c['hidden']} relu, bidirectional_gru {c['hidden']} (B3/B4, f32), row_conv "
             f"({c['lookahead']}), fc {c['classes']}, warpctc(norm_by_times), Adam; "
             f"{CTC_STEPS} steps through the Trainer, then scan_window={CTC_WINDOW}")
    t_start = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    rng = np.random.RandomState(seed + 640)
    batches = ctc_batches(ptt, rng, CTC_WINDOW, **c)
    frames = [int(b["spec"].lengths.sum()) for b in batches]
    main_p, startup, loss, logits, ids, lengths = build_ctc_model(ptt, **c)
    exe = ptt.Executor()
    scope0 = ptt.Scope()
    exe.run(startup, scope=scope0, seed=seed)
    state = {k: scope0.get(k).clone() for k in scope0.keys()}
    del scope0
    calls, restore = record_ops(treg, ("warpctc",))
    warm_ms, _, _, warm_costs = trainer_run(ptt, exe, main_p, startup, loss, state,
                                            batches[:1], 0)
    restore()
    before = graph.counter_state()
    p_ms, _, p_moved, p_costs = trainer_run(ptt, exe, main_p, startup, loss, state,
                                            batches[:CTC_STEPS], 0)
    moved = graph.counter_delta(before, graph.counter_state())
    launches = {k: moved.get((m, f"{k}_launches"), 0) / CTC_STEPS
                for m, names in graph.LAUNCH_COUNTERS for k in ("gru_fwd", "gru_bwd")
                if f"{k}_launches" in names}
    print(f"  {frames[:CTC_STEPS]} frames in the timed batches; warm-up {warm_ms:.1f} ms; "
          f"per-step loop {p_ms:.3f} ms a step, costs {p_costs}; B3/B4 launches a step "
          f"{launches}; on {smi}")
    check(all(np.isfinite(p_costs)) and p_costs[0] == warm_costs[0],
          "CTC: a non-finite cost, or the first cost differs between two runs")
    check(launches == {"gru_fwd": 2, "gru_bwd": 2}, f"CTC: B3/B4 launches a step {launches}")
    check(p_moved["eager_steps"] == 0 and p_moved["captures"] == 0,
          f"CTC: the per-step loop ran a window: {p_moved}")
    # the window: one eager step, one capture, replays; the per-step bits
    w_ms, w_params, w_moved, w_costs = trainer_run(ptt, exe, main_p, startup, loss, state,
                                                   batches, CTC_WINDOW)
    sg = next(sg for sg in exe._windows.values() if sg.program is main_p)
    ref_ms, ref_params, _, ref_costs = trainer_run(ptt, exe, main_p, startup, loss, state,
                                                   batches, 0)
    before = graph.counter_state()
    w2_ms, w2_params, w2_moved, _ = trainer_run(ptt, exe, main_p, startup, loss, state,
                                                batches, CTC_WINDOW)
    moved = graph.counter_delta(before, graph.counter_state())
    w_launches = {k: moved.get((m, f"{k}_launches"), 0) / CTC_WINDOW
                  for m, names in graph.LAUNCH_COUNTERS for k in ("gru_fwd", "gru_bwd")
                  if f"{k}_launches" in names}
    print(f"  scan_window={CTC_WINDOW}: {w_ms:.3f} ms a step ({w_moved}, capture "
          f"{sg.capture_s:.3f} s), again {w2_ms:.3f} ms ({w2_moved}, B3/B4 launches a step "
          f"{w_launches}); the per-step loop over the same {CTC_WINDOW} batches {ref_ms:.3f} "
          f"ms; costs {w_costs}")
    check(w_launches == launches, f"CTC window: B3/B4 launches a step {w_launches}")
    check(w_moved == {"captures": 1, "replays": CTC_WINDOW - 1, "eager_steps": 1},
          f"CTC window: {w_moved}")
    check(w2_moved == {"captures": 0, "replays": CTC_WINDOW, "eager_steps": 0},
          f"CTC window again: {w2_moved}")
    # a second run of the per-step loop: the same bits run to run
    check(ref_costs[:CTC_STEPS] == p_costs, "CTC: two runs of the per-step loop differ (an "
                                            "op adds in no fixed order)")
    check(w_costs == ref_costs, f"CTC window costs {w_costs} != per-step {ref_costs}")
    for label, got in (("window", w_params), ("window again", w2_params)):
        d = first_differing(got, ref_params)
        check(d is None, f"CTC {label}: parameter {d} differs from the per-step loop's")
    capture_s = sg.capture_s
    exe._windows.clear()
    del sg
    # the step under the profiler, then the CTC op alone on the step's inputs
    scope = ptt.Scope()
    for k, v in state.items():
        scope.set(k, v.clone())
    feed = batches[0]
    run = lambda: exe.run(main_p, feed, [loss.name], scope=scope)  # noqa: E731
    run()
    wall, busy, counts, _, nev = profile_pass(run, ["gru_fwd", "gru_bwd"])
    print(f"  profiled step: wall {wall:.3f} ms, device busy {busy:.3f} ms "
          f"({100 * busy / wall:.1f}%), {nev} device events; {counts}")
    op, ins = calls["warpctc"][0]
    lg, lb = ins[op.inputs["Logits"][0]], ins[op.inputs["Label"][0]]

    def ctc_step():
        d = lg.data.detach().requires_grad_(True)
        nll = ctc_ops.ctc_loss(lg.with_data(d), lb, blank=op.attrs["blank"],
                               max_len=op.attrs["max_len"],
                               max_label_len=op.attrs["max_label_len"])
        torch.autograd.grad(nll.sum(), [d])
        return nll

    nll = ctc_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        ctc_step()
    torch.cuda.synchronize()
    ctc_ms = (time.perf_counter() - t0) * 1e3 / 3
    cwall, cbusy, _, _, cnev = profile_pass(ctc_step, [])
    print(f"  warpctc alone (forward and gradient, T={op.attrs['max_len']}, an eager loop): "
          f"{ctc_ms:.3f} ms of host time ({100 * ctc_ms / p_ms:.1f}% of the step's "
          f"{p_ms:.3f}), {cbusy:.3f} ms of device time ({100 * cbusy / busy:.1f}% of the "
          f"step's {busy:.3f}), {cnev} device events (the step's {nev})")
    # the yardstick: torch's own CTC on the same log-probabilities
    x_tb, _ = lg.to_batch(max_len=op.attrs["max_len"])
    lbl_bt, _ = lb.with_data(lb.data[:, 0].long()).to_batch(
        max_len=op.attrs["max_label_len"], time_major=False)

    def torch_ctc():
        d = x_tb.detach().requires_grad_(True)
        out = F.ctc_loss(torch.log_softmax(d, -1), lbl_bt, lg.lengths.long(),
                         lb.lengths.long(), blank=op.attrs["blank"], reduction="none")
        torch.autograd.grad(out.sum(), [d])
        return out

    ref = torch_ctc()
    yard_ms = cuda_ms(torch_ctc, 5)
    op_ms = ctc_ms  # synchronized host time of the eager op, which the host bounds
    rel = float(((nll.detach() - ref.detach()).abs() / ref.detach().abs().clamp(min=1.0)).max())
    print(f"  F.ctc_loss (a yardstick, not a path of the port) on the same logits: "
          f"{yard_ms:.3f} ms forward and backward against the op's {op_ms:.3f} ms "
          f"({op_ms / yard_ms:.1f}x), losses {rel:.3e} apart relative (tol "
          f"{CTC_YARDSTICK_TOL:g}); on {smi}")
    check(rel <= CTC_YARDSTICK_TOL, f"warpctc and F.ctc_loss differ by {rel:.3e}")
    # the decode on the for-test clone, scored by EditDistance, card against
    # CPU: from the startup's weights (3 steps leave every frame's argmax
    # on the blank, so nothing is decoded)
    test_p = main_p.clone(for_test=True)
    dscope = ptt.Scope()
    for k, v in state.items():
        dscope.set(k, v)
    got_ids, got_len, got_logits = exe.run(test_p, feed, [ids.name, lengths.name, logits.name],
                                           scope=dscope, return_numpy=False)
    trained_len = exe.run(test_p, feed, [lengths.name], scope=scope)[0]
    env = {"l": got_logits.to("cpu")}
    treg.get_kernel("ctc_greedy_decoder")(treg.OpContext(Operator(
        "ctc_greedy_decoder", {"Logits": ["l"]}, {"Ids": ["i"], "Lengths": ["n"]},
        {"blank": c["classes"] - 1, "max_len": c["max_frames"]}), env))
    check(torch.equal(env["i"], got_ids.cpu()) and torch.equal(env["n"], got_len.cpu()),
          "ctc_greedy_decoder: the card's ids differ from the CPU op's on the same logits")
    ev = ptt.evaluator.EditDistance()
    refs = [lb.data[lb.seq_ids == i, 0].cpu().numpy() for i in range(c["batch"])]
    hyps = [got_ids[i, :int(got_len[i])].cpu().numpy() for i in range(c["batch"])]
    ev.update(hyps, refs)
    err = ev.eval()
    print(f"  ctc_greedy_decoder on the for-test clone from the startup's weights: "
          f"{int(got_len.sum())} characters decoded (the labels hold "
          f"{sum(len(r) for r in refs)}), the CPU op's ids on the same logits; EditDistance "
          f"{err:.4f}; after the {CTC_STEPS} steps {int(trained_len.sum())} decoded")
    check(np.isfinite(err) and err >= 0.0 and int(got_len.sum()) > 0,
          f"EditDistance {err}, {int(got_len.sum())} characters decoded")
    out = dict(ms_per_step=p_ms, per_step_runs_ms=[p_ms, ref_ms],
               window_ms=w2_ms, first_window_ms=w_ms, capture_s=capture_s,
               frames=frames, costs=p_costs, launches_per_step=launches,
               window_launches_per_step=w_launches,
               profiled=dict(wall_ms=wall, busy_ms=busy, busy_share=busy / wall,
                             device_events=nev),
               ctc_op=dict(host_ms=ctc_ms, host_share=ctc_ms / p_ms, device_ms=cbusy,
                           device_share=cbusy / busy, device_events=cnev, ms=op_ms),
               f_ctc_loss_ms=yard_ms, f_ctc_loss_rel_err=rel, edit_distance=err,
               window_same_bits=True)
    del scope, dscope
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_start
    print(f"  phase {n}: {out['seconds']:.1f} s")
    return out


def build_ssd_head(ptt, batch_gt, classes, image, maps, min_sizes, max_sizes, aspect_ratios,
                   variances, lr, momentum, **_):
    """SSD300's heads over the six maps: (main, startup, loss, loc, conf,
    priors, prior variances); every map's priors from prior_box."""
    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    L = ptt.layers
    with ptt.program_guard(main, startup):
        img = L.data("image", shape=[3, image, image])
        gt = L.data("gt", shape=[batch_gt, 4])
        gtl = L.data("gtl", shape=[batch_gt], dtype=np.int32)
        locs, confs, boxes, pvars = [], [], [], []
        for i, ((ch, size), mn, mx, ar) in enumerate(zip(maps, min_sizes, max_sizes,
                                                         aspect_ratios)):
            f = L.data(f"map{i}", shape=[ch, size, size])
            per = L.num_priors([mn], [mx], ar)
            b, v = L.prior_box(f, img, [mn], ar, variances, max_sizes=[mx])
            boxes.append(b)
            pvars.append(v)
            for out, width in ((locs, 4), (confs, classes)):
                h = L.conv2d(f, num_filters=per * width, filter_size=3, padding=1)
                out.append(L.reshape(L.transpose(h, (0, 2, 3, 1)), (-1, size * size * per,
                                                                    width)))
        loc, conf = L.concat(locs, axis=1), L.concat(confs, axis=1)
        priors, pvar = L.concat(boxes, axis=0), L.concat(pvars, axis=0)
        loss = L.mean(L.multibox_loss(loc, conf, priors, pvar, gt, gtl,
                                      overlap_threshold=0.5, neg_pos_ratio=3.0))
        ptt.optimizer.Momentum(learning_rate=lr, momentum=momentum).minimize(loss)
    return main, startup, loss, loc, conf, priors, pvar


def ssd_test_program(ptt, main, startup, loc, conf, priors, pvar):
    """The for-test clone with detection_output on its heads (VOC's
    evaluation settings)."""
    test_p = main.clone(for_test=True)
    b = test_p.global_block()
    with ptt.program_guard(test_p, startup):
        dets = ptt.layers.detection_output(
            b.var(loc.name), b.var(conf.name), b.var(priors.name), b.var(pvar.name),
            confidence_threshold=0.01, nms_threshold=0.45, nms_top_k=400, keep_top_k=200)
    return test_p, dets


def ssd_feed(rng, batch, classes, image, max_gt, maps, **_):
    """ReLU-like maps at SSD300's shapes, the image (only its size is read)
    and 1-64 ground-truth boxes an image, label 0 padding the rest."""
    feed = {f"map{i}": np.maximum(rng.standard_normal((batch, ch, s, s)), 0).astype(np.float32)
            for i, (ch, s) in enumerate(maps)}
    feed["image"] = np.zeros((batch, 3, image, image), np.float32)
    gt = np.zeros((batch, max_gt, 4), np.float32)
    gtl = np.zeros((batch, max_gt), np.int32)
    for i in range(batch):
        k = rng.randint(1, max_gt + 1)
        lo = rng.uniform(0.0, 0.8, (k, 2))
        wh = rng.uniform(0.05, 0.5, (k, 2))
        gt[i, :k] = np.concatenate([lo, np.minimum(lo + wh, 1.0)], 1)
        gtl[i, :k] = rng.randint(1, classes, k)
    feed["gt"], feed["gtl"] = gt, gtl
    return feed


def rows_matched(a, b, score_tol=1e-5, box_tol=1e-4):
    """The share of a's valid rows (label >= 0) that a row of b matches
    (the same label, score and box within the tolerances), one to one."""
    a, b = a[a[:, 0] >= 0], b[b[:, 0] >= 0]
    used = np.zeros(len(b), bool)
    hit = 0
    for row in a:
        ok = (~used & (b[:, 0] == row[0]) & (np.abs(b[:, 1] - row[1]) <= score_tol)
              & (np.abs(b[:, 2:] - row[2:]).max(1) <= box_tol))
        if ok.any():
            used[np.argmax(ok)] = True
            hit += 1
    return hit / max(len(a), 1), len(a), len(b)


def ssd_phase(ptt, smi, seed, n):
    """Phase n: the SSD300 head trained 3 steps on the card, the multibox
    loss and detection_output timed, the detections scored by DetectionMAP;
    then the loss and the rows at B=2, card against CPU."""
    from paddle_tpu_torch.core import registry as treg
    from paddle_tpu_torch.core.program import Operator

    s = SSD
    phase(n, f"SSD300 head on VOC's {s['classes']} classes: B={s['batch']}, the six VGG16 "
             f"source maps {[f'{c}x{h}x{h}' for c, h in s['maps']]}, prior_box, 3x3 loc and "
             f"conf heads, multibox_loss, Momentum; {SSD_STEPS} timed steps, then "
             f"detection_output (nms_top_k 400, keep_top_k 200) scored by DetectionMAP; B="
             f"{SSD_CPU_BATCH} card against CPU")
    t_start = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    main_p, startup, loss, loc, conf, priors, pvar = build_ssd_head(ptt, s["max_gt"], **s)
    test_p, dets = ssd_test_program(ptt, main_p, startup, loc, conf, priors, pvar)
    exe = ptt.Executor()
    scope = ptt.Scope()
    exe.run(startup, scope=scope, seed=seed)
    rng = np.random.RandomState(seed + 650)
    host_feed = ssd_feed(rng, **s)
    feed = {k: torch.as_tensor(v, device=CARD) for k, v in host_feed.items()}
    calls, restore = record_ops(treg, ("multibox_loss",))
    pri = exe.run(main_p, feed, [loss.name, priors.name], scope=scope)
    restore()
    losses = [float(pri[0])]
    check(pri[1].shape == (SSD_PRIORS, 4), f"SSD: {pri[1].shape[0]} priors, not {SSD_PRIORS}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(SSD_STEPS):
        t0 = time.perf_counter()
        losses.append(float(exe.run(main_p, feed, [loss.name], scope=scope)[0]))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  {SSD_PRIORS} priors; losses (warm-up, then timed) {losses}; steps "
          f"{[round(t, 3) for t in times]} ms, median {med:.3f} ms, "
          f"{s['batch'] / med * 1e3:.1f} images/s; peak {peak:.2f} GiB on {smi}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          "SSD: a non-finite loss, or the loss did not fall over the steps on one batch")
    run = lambda: exe.run(main_p, feed, [loss.name], scope=scope)  # noqa: E731
    wall, busy, _, _, nev = profile_pass(run, [])
    print(f"  profiled step: wall {wall:.3f} ms, device busy {busy:.3f} ms "
          f"({100 * busy / wall:.1f}%), {nev} device events")
    op, ins = calls["multibox_loss"][0]
    args = {k: ins[v[0]] for k, v in op.inputs.items()}

    def mbox_step():
        lo = args["Loc"].detach().requires_grad_(True)
        co = args["Conf"].detach().requires_grad_(True)
        env = dict(args, Loc=lo, Conf=co)
        treg.get_kernel("multibox_loss")(treg.OpContext(Operator(
            "multibox_loss", {k: [k] for k in env}, {"Out": ["o"]}, dict(op.attrs)), env))
        torch.autograd.grad(env["o"].sum(), [lo, co])

    mbox_ms = cuda_ms(mbox_step, 3)
    _, mbusy, _, _, mnev = profile_pass(mbox_step, [])
    d_out = exe.run(test_p, feed, [dets.name], scope=scope)[0]  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d_out = exe.run(test_p, feed, [dets.name], scope=scope)[0]
    torch.cuda.synchronize()
    det_ms = (time.perf_counter() - t0) * 1e3
    _, dbusy, _, _, dnev = profile_pass(lambda: exe.run(test_p, feed, [dets.name], scope=scope),
                                        [])
    check(d_out.shape == (s["batch"], 200, 6), f"detection_output {d_out.shape}")
    valid = d_out[..., 0] >= 0
    ev = ptt.evaluator.DetectionMAP(num_classes=s["classes"])
    for i in range(s["batch"]):
        k = host_feed["gtl"][i] > 0
        ev.update_image(d_out[i][valid[i]], host_feed["gt"][i][k], host_feed["gtl"][i][k])
    mAP = ev.eval()
    print(f"  multibox_loss alone (forward and gradient): {mbox_ms:.3f} ms, {mbusy:.3f} ms of "
          f"device time, {mnev} device events; detection_output on the for-test clone: "
          f"{det_ms:.3f} ms host, {dbusy:.3f} ms device, {dnev} device events; "
          f"{int(valid.sum())} rows kept, scores in [{d_out[..., 1][valid].min():.4f}, "
          f"{d_out[..., 1][valid].max():.4f}]; DetectionMAP {mAP:.4f} from random heads")
    check(valid.any() and np.isfinite(mAP), "detection_output kept no row, or mAP not finite")
    check(bool((np.diff(np.where(valid, d_out[..., 1], -1), axis=1) <= 0).all()),
          "detection_output: rows not in descending score order")
    # B=2, card against CPU, from one CPU startup state
    state = ptt.io.state_to_numpy(scope, [v.name for v in main_p.persistables()
                                          if scope.has(v.name)])
    del scope
    small = {k: v[:SSD_CPU_BATCH] for k, v in host_feed.items()}
    res = {}
    for dev in ("cpu", CARD):
        sc = ptt.Scope()
        ptt.io.params_from_numpy(sc, state, dev)
        e = ptt.Executor(device=dev)
        lv = float(e.run(main_p, small, [loss.name], scope=sc)[0])
        res[dev] = (lv, e.run(test_p, small, [dets.name], scope=sc)[0],
                    ptt.io.state_to_numpy(sc, [p.name for p in main_p.parameters()]))
    loss_err = abs(res[CARD][0] - res["cpu"][0]) / max(1.0, abs(res["cpu"][0]))
    param_err = max(float(np.abs(res[CARD][2][k] - v).max()) / max(1e-2, float(np.abs(v).max()))
                    for k, v in res["cpu"][2].items())
    shares = [rows_matched(res[CARD][1][i], res["cpu"][1][i]) for i in range(SSD_CPU_BATCH)]
    print(f"  B={SSD_CPU_BATCH} card against CPU: loss {res[CARD][0]:.6f} vs {res['cpu'][0]:.6f} "
          f"({loss_err:.3e} relative), parameters after the step {param_err:.3e} of their "
          f"scale; detection rows matched (share, card rows, CPU rows) {shares} (at least "
          f"{SSD_ROW_MATCH:.0%}: a pick between two scores within rounding may differ)")
    check(loss_err <= 1e-4 and param_err <= 1e-4, "SSD: card and CPU differ")
    check(all(sh >= SSD_ROW_MATCH and na == nb for sh, na, nb in shares),
          "SSD: the detection rows differ card against CPU")
    gc.collect()
    torch.cuda.empty_cache()
    out = dict(ms_per_step=med, steps_ms=times, losses=losses, peak_gib=peak,
               profiled=dict(wall_ms=wall, busy_ms=busy, busy_share=busy / wall,
                             device_events=nev),
               multibox_loss_ms=mbox_ms, multibox_loss_device_ms=mbusy,
               detection_output_ms=det_ms, detection_output_device_ms=dbusy,
               detection_output_events=dnev, rows_kept=int(valid.sum()), mAP=mAP,
               card_vs_cpu=dict(loss=loss_err, params=param_err, rows_matched=shares))
    out["seconds"] = time.perf_counter() - t_start
    print(f"  phase {n}: {out['seconds']:.1f} s")
    return out


def ctr_samples(rng, n, batch, dense, fields, dim, **_):
    """`n` batches of Criteo-shaped samples: 13 dense features (log of a
    count), 26 categorical ones, field f's value drawn from 10^(2 + f % 5)
    and hashed with its field into [0, dim); clicks at about 25%."""
    card = [10 ** (2 + f % 5) for f in range(fields)]
    out = []
    for _ in range(n):
        vals = np.stack([rng.zipf(1.3, batch) % card[f] for f in range(fields)], 1)
        idx = (vals * 2654435761 + np.arange(fields) * 40503) % dim
        dn = np.log1p(rng.poisson(3.0, (batch, dense))).astype(np.float32)
        y = (rng.rand(batch, 1) < 0.25).astype(np.float32)
        out.append([(idx[i].tolist(), dn[i], y[i]) for i in range(batch)])
    return out


def build_ctr(ptt, dense, dim, deep, lr, **_):
    """Wide (the slot's fc to 1) and deep (the slot's fc to 256, the dense
    features beside it, fc 256, 128, 1) summed; sigmoid CE, Adam."""
    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    L = ptt.layers
    with ptt.program_guard(main, startup):
        cats = L.data("cats", shape=[dim], sparse_format="binary")
        dn = L.data("dense", shape=[dense])
        click = L.data("click", shape=[1])
        wide = L.fc(cats, size=1, bias_attr=False)
        h = L.concat([L.fc(cats, size=deep[0], act="relu"), dn], axis=1)
        for width in deep[1:]:
            h = L.fc(h, size=width, act="relu")
        logit = L.elementwise_add(wide, L.fc(h, size=1))
        loss = L.mean(L.sigmoid_cross_entropy_with_logits(logit, click))
        ptt.optimizer.Adam(learning_rate=lr).minimize(loss)
    return main, startup, loss, logit, [cats, dn, click]


def ctr_run(ptt, exe, main_p, startup, loss, feeds, state, batches, window):
    """One pass through a fresh Trainer (DataFeeder, DevicePrefetcher) from
    `state`: (ms a step, the parameters after, cache stats moved, costs)."""
    scope = ptt.Scope()
    tr = ptt.Trainer(loss, main_program=main_p, startup_program=startup, scope=scope,
                     executor=exe)
    tr.init()
    for k, v in state.items():
        scope.set(k, v.clone())
    costs = []
    cs0 = dict(exe.cache_stats)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.train(lambda: iter(batches), 1, feed_order=feeds, log_interval=len(batches),
             scan_window=window, event_handler=lambda e: costs.append(e.cost) if isinstance(
                 e, ptt.EndIteration) else None)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    moved = {k: exe.cache_stats[k] - cs0[k] for k in ("captures", "replays", "eager_steps")}
    return ms, {p.name: scope.get(p.name).clone() for p in main_p.parameters()}, moved, \
        [float(c) for c in costs]


def copy_overlap(run):
    """One call of `run` under torch.profiler's chrome trace: (host-to-device
    copies' ms, their streams, the kernels' streams, ms of copies that ran
    while a kernel of another stream ran)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_PAD):  # the events at a capture's start may be lost (C8)
            torch.cuda._sleep(PROFILE_PAD_CYCLES)
        torch.cuda.synchronize()
        run()
        torch.cuda.synchronize()
    path = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_trace_"), "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    shutil.rmtree(os.path.dirname(path), ignore_errors=True)
    copies = [(e["ts"], e["ts"] + e["dur"], e.get("args", {}).get("stream"))
              for e in events if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")]
    kernels = [(e["ts"], e["ts"] + e["dur"], e.get("args", {}).get("stream"))
               for e in events if e.get("cat") == "kernel"]
    overlap = 0.0
    for s0, e0, st in copies:
        spans = sorted((max(s0, s1), min(e0, e1)) for s1, e1, st1 in kernels
                       if st1 != st and s1 < e0 and e1 > s0)
        end = s0
        for a, b in spans:
            if b > max(a, end):
                overlap += b - max(a, end)
                end = b
    return (sum(e - s for s, e, _ in copies) / 1e3, sorted({st for _, _, st in copies}),
            sorted({st for _, _, st in kernels}), overlap / 1e3)


def ctr_phase(ptt, smi, seed, n):
    """Phase n: the CTR model on a sparse slot of 1e6 columns through
    DataFeeder -> DevicePrefetcher -> Trainer, then scan_window; the sparse
    mul timed, the copies' streams read from a trace; Auc; a small sparse
    program card against CPU and against its densified twin."""
    from paddle_tpu_torch.core.sparse import SparseArray
    from paddle_tpu_torch.data.feeder import DataFeeder

    c = CTR
    phase(n, f"Criteo-shaped CTR model: B={c['batch']}, {c['dense']} dense features, "
             f"{c['fields']} categorical ones hashed into one sparse_binary slot of "
             f"{c['dim']:,} columns; wide + deep {list(c['deep'])}, sigmoid CE, Adam; "
             f"{CTR_STEPS} steps through DataFeeder, DevicePrefetcher and the Trainer, then "
             f"scan_window={CTR_STEPS}")
    t_start = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    rng = np.random.RandomState(seed + 660)
    batches = ctr_samples(rng, CTR_STEPS, **c)
    main_p, startup, loss, logit, feeds = build_ctr(ptt, **c)
    exe = ptt.Executor()
    scope0 = ptt.Scope()
    exe.run(startup, scope=scope0, seed=seed)
    state = {k: scope0.get(k).clone() for k in scope0.keys()}
    del scope0
    deep_w = next(p.name for p in main_p.parameters() if tuple(p.shape) == (c["dim"],
                                                                          c["deep"][0]))
    nbytes = sum(v.numel() * v.element_size() for v in state.values())
    t0 = time.perf_counter()
    one = DataFeeder(feeds).feed(batches[0])["cats"]
    feed_ms = (time.perf_counter() - t0) * 1e3
    print(f"  state {nbytes / 2**30:.2f} GiB (the sparse weight {deep_w} "
          f"{c['dim']} x {c['deep'][0]} and Adam's moments); a batch's slot: capacity "
          f"{one.capacity}, {int((one.rowids < c['batch']).sum())} nonzeros; DataFeeder.feed "
          f"{feed_ms:.3f} ms a batch on the host")
    check(one.capacity == c["batch"] * c["fields"], f"CTR: capacity {one.capacity}")
    torch.cuda.reset_peak_memory_stats()
    warm_ms, _, _, warm_costs = ctr_run(ptt, exe, main_p, startup, loss, feeds, state,
                                        batches[:1], 0)
    p_ms, p_params, p_moved, p_costs = ctr_run(ptt, exe, main_p, startup, loss, feeds, state,
                                               batches, 0)
    p2_ms, p2_params, _, p2_costs = ctr_run(ptt, exe, main_p, startup, loss, feeds, state,
                                            batches, 0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    same = p2_costs == p_costs and first_differing(p2_params, p_params) is None
    print(f"  warm-up {warm_ms:.1f} ms; per-step loop {p_ms:.3f} and {p2_ms:.3f} ms a step "
          f"({c['batch'] / p_ms * 1e3:.0f} samples/s), costs {p_costs}; the same bits run to "
          f"run: {same}; peak {peak:.2f} GiB on {smi}")
    check(all(np.isfinite(p_costs)) and p_costs[0] == warm_costs[0],
          "CTR: a non-finite cost, or the first cost differs between two runs")
    check(p_moved["captures"] == 0 and p_moved["eager_steps"] == 0, f"CTR: {p_moved}")
    check(same, "CTR: two runs of the per-step loop differ (an op adds in no fixed order)")
    w_ms, w_params, w_moved, w_costs = ctr_run(ptt, exe, main_p, startup, loss, feeds, state,
                                               batches, CTR_STEPS)
    w2_ms, w2_params, w2_moved, _ = ctr_run(ptt, exe, main_p, startup, loss, feeds, state,
                                            batches, CTR_STEPS)
    print(f"  scan_window={CTR_STEPS}: {w_ms:.3f} ms a step ({w_moved}), again {w2_ms:.3f} ms "
          f"({w2_moved}); costs {w_costs}")
    check(w_moved == {"captures": 1, "replays": CTR_STEPS - 1, "eager_steps": 1},
          f"CTR window: {w_moved}")
    check(w2_moved == {"captures": 0, "replays": CTR_STEPS, "eager_steps": 0},
          f"CTR window again: {w2_moved}")
    check(w_costs == p_costs, f"CTR window costs {w_costs} != per-step {p_costs}")
    for label, got in (("window", w_params), ("window again", w2_params)):
        d = first_differing(got, p_params)
        check(d is None, f"CTR {label}: parameter {d} differs from the per-step loop's")
    exe._windows.clear()
    del w_params, w2_params, p2_params
    # where a step's device time goes
    bscope = ptt.Scope()
    for k, v in state.items():
        bscope.set(k, v.clone())
    bfeed = DataFeeder(feeds).feed(batches[0])
    exe.run(main_p, bfeed, [loss.name], scope=bscope)
    busy_us, by_kind = breakdown(lambda: exe.run(main_p, bfeed, [loss.name], scope=bscope),
                                 p_ms, "step", kinds=CTR_KINDS)
    del bscope
    # the sparse mul alone, forward and backward, on a batch's slot
    x = one.to(CARD)
    w = state[deep_w].clone().requires_grad_(True)
    fwd_ms = cuda_ms(lambda: x.matmul(w), 10)
    g = torch.randn(c["batch"], c["deep"][0], device=CARD)

    def fwd_bwd():
        torch.autograd.grad(x.matmul(w), [w], g)

    fb_ms = cuda_ms(fwd_bwd, 5)
    print(f"  the sparse mul [{c['batch']} x {c['dim']:,}] (capacity {x.capacity}) @ "
          f"[{c['dim']:,} x {c['deep'][0]}]: forward {fwd_ms:.4f} ms, forward and backward "
          f"{fb_ms:.4f} ms (the backward writes the dense [{c['dim']:,} x {c['deep'][0]}] "
          f"gradient)")
    del w, g
    # the copies: the prefetcher's side stream beside the step's
    scope = ptt.Scope()
    for k, v in state.items():
        scope.set(k, v)
    tr = ptt.Trainer(loss, main_program=main_p, startup_program=startup, scope=scope,
                     executor=exe)
    tr.init()
    for _ in range(PROFILE_TRIES):  # a trace that lost the copies' events is taken again
        copy_ms, copy_streams, kernel_streams, overlap_ms = copy_overlap(
            lambda: tr.train(lambda: iter(batches), 1, feed_order=feeds,
                             log_interval=len(batches)))
        if copy_ms > 0:
            break
    print(f"  host-to-device copies of a pass of {CTR_STEPS} steps: {copy_ms:.3f} ms on "
          f"streams {copy_streams}, the kernels on {kernel_streams}; {overlap_ms:.3f} ms of the "
          f"copies ran beside a kernel of another stream")
    check(copy_ms > 0, "CTR: the trace shows no host-to-device copy")
    test_p = main_p.clone(for_test=True)
    auc = ptt.evaluator.Auc()
    feeder = DataFeeder(feeds)
    for b in batches:
        lg = exe.run(test_p, feeder.feed(b), [logit.name], scope=scope)[0]
        auc.update(1 / (1 + np.exp(-lg)), np.asarray([s[2] for s in b]))
    print(f"  Auc over the {CTR_STEPS} batches (the clicks drawn at random): {auc.eval():.4f}")
    del scope, tr, state, p_params
    gc.collect()
    torch.cuda.empty_cache()
    # a small sparse program: card against CPU, and its densified twin
    small = dict(c, batch=64, dim=5000, deep=(32, 16))
    sb = ctr_samples(np.random.RandomState(seed + 661), 2, **small)
    s_main, s_startup, s_loss, s_logit, s_feeds = build_ctr(ptt, **small)
    errs = card_vs_cpu(ptt, s_main, s_startup, [s_loss.name, s_logit.name],
                       [DataFeeder(s_feeds).feed(b) for b in sb], seed, lr_share=0.0)
    print(f"  small sparse program (B=64, dim 5000) 2 Adam steps card against CPU: loss "
          f"{errs[0]:.3e} relative, state {errs[1]:.3f} of its bound")
    check(errs[0] <= 1e-5 and errs[1] <= 1.0, "CTR small: card and CPU differ")
    d_main, d_startup, d_loss, d_logit, d_feeds = build_ctr(ptt, **small)
    d_main.global_block().vars["cats"].sparse_format = None
    sc, dc = ptt.Scope(), ptt.Scope()
    ptt.Executor(device="cpu").run(s_startup, scope=sc, seed=seed)
    st = ptt.io.state_to_numpy(sc, [v.name for v in s_main.persistables() if sc.has(v.name)])
    ptt.io.params_from_numpy(sc, st, CARD)
    ptt.io.params_from_numpy(dc, st, CARD)
    f = DataFeeder(s_feeds).feed(sb[0])
    fd = dict(f, cats=f["cats"].to_dense().numpy())
    sparse_out = ptt.Executor().run(s_main, f, [s_loss.name, s_logit.name], scope=sc)
    dense_out = ptt.Executor().run(d_main, fd, [d_loss.name, d_logit.name], scope=dc)
    twin = max(float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max()))
               for a, b in zip(sparse_out, dense_out))
    print(f"  the densified twin on the card: {twin:.3e} of the scale apart (tol 1e-5)")
    check(twin <= 1e-5, "CTR: the sparse program and its densified twin differ")
    check(isinstance(f["cats"], SparseArray), "the feeder did not build a SparseArray")
    out = dict(ms_per_step=statistics.mean([p_ms, p2_ms]), per_step_runs_ms=[p_ms, p2_ms],
               window_ms=w2_ms, first_window_ms=w_ms, costs=p_costs, peak_gib=peak,
               state_gib=nbytes / 2**30, capacity=one.capacity, feeder_ms=feed_ms,
               sparse_mul=dict(fwd_ms=fwd_ms, fwd_bwd_ms=fb_ms),
               copies=dict(ms=copy_ms, streams=copy_streams, kernel_streams=kernel_streams,
                           overlap_ms=overlap_ms),
               auc=auc.eval(), small_card_vs_cpu=list(errs[:2]), dense_twin=twin,
               device_busy_ms=None if busy_us is None else busy_us / 1e3,
               device_ms_by_kind={k: v / 1e3 for k, v in by_kind.items()},
               window_same_bits=True)
    out["seconds"] = time.perf_counter() - t_start
    print(f"  phase {n}: {out['seconds']:.1f} s")
    return out


def misc_cases(rng):
    """(label, op, inputs {slot: array or [arrays] or ("lod", seqs)}, attrs,
    output slot, differentiable, tolerance) of phase 67."""
    R, W = MISC_ROWS, MISC_WIDTH
    x = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    pos = lambda *s: (np.abs(x(*s)) + 0.25).astype(np.float32)  # noqa: E731
    tied = lambda *s: np.maximum(np.round(x(*s)), 0).astype(np.float32)  # noqa: E731
    lbl01 = (rng.rand(R, W) < 0.5).astype(np.float32)
    perm = rng.permutation(R)[:R // 2].astype(np.int32)
    img = lambda n: x(n, 16, 8, 8)  # noqa: E731  [n x 1024] as NCHW
    t = OPS_TOL[None]
    return [
        ("sigmoid_ce", "sigmoid_cross_entropy_with_logits", {"X": x(R, W), "Label": lbl01},
         {}, "Out", True, t),
        ("bce", "binary_cross_entropy", {"X": 1 / (1 + np.exp(-x(R, W))), "Label": lbl01},
         {}, "Out", True, t),
        ("ce_selfnorm", "cross_entropy_with_selfnorm",
         {"X": pos(R, W), "Label": rng.randint(0, W, (R, 1)).astype(np.int32)},
         {"softmax_selfnorm_alpha": 0.1}, "Out", True, t),
        ("smooth_l1", "smooth_l1", {"X": x(R, W), "Y": x(R, W), "InsideWeight": pos(R, W),
                                    "OutsideWeight": pos(R, W)}, {"sigma": 2.0}, "Out", True, t),
        ("rank_cost", "rank_cost", {"Left": x(R, 1), "Right": x(R, 1),
                                    "Label": rng.randint(0, 3, (R, 1)).astype(np.float32) / 2},
         {}, "Out", True, t),
        ("margin_rank", "margin_rank_loss",
         {"X1": x(R, 1), "X2": x(R, 1), "Label": np.sign(x(R, 1))}, {"margin": 0.1}, "Out",
         True, t),
        ("huber_cls", "huber_classification",
         {"X": 2 * x(R, 1), "Label": (rng.rand(R, 1) < 0.5).astype(np.float32)}, {}, "Out",
         True, t),
        ("sum_cost", "sum_cost", {"X": x(R, W)}, {}, "Out", True, t),
        ("lambda_cost", "lambda_cost", {"Score": 0.1 * x(R, 128),
                                        "Label": rng.randint(0, 4, (R, 128)).astype(np.float32),
                                        "Mask": (rng.rand(R, 128) < 0.9).astype(np.float32)},
         {"NDCG_num": 10}, "Out", True, t),
        ("hsigmoid", "hsigmoid", {"X": x(NCE_BATCH, NCE_WIDTH) / 8,
                                  "W": x(NCE_CLASSES - 1, NCE_WIDTH) / 8,
                                  "Label": rng.randint(0, NCE_CLASSES, (NCE_BATCH, 1)).astype(
                                      np.int32),
                                  "Bias": x(NCE_CLASSES - 1)},
         {"num_classes": NCE_CLASSES}, "Cost", True, t),
        ("gather", "gather", {"X": x(R, W), "Index": rng.randint(0, R, 256).astype(np.int32)},
         {}, "Out", True, t),
        ("scatter", "scatter", {"X": x(R, W), "Index": perm, "Updates": x(R // 2, W)},
         {"overwrite": True}, "Out", True, t),
        ("scatter_add", "scatter", {"X": x(R, W), "Index": rng.randint(0, R, R // 2).astype(
            np.int32), "Updates": x(R // 2, W)}, {"overwrite": False}, "Out", True, t),
        ("one_hot", "one_hot", {"X": rng.randint(0, W + 8, (R, 1)).astype(np.int32)},
         {"depth": W}, "Out", False, t),
        ("pad", "pad", {"X": x(R, W)}, {"paddings": [1, 2, 3, 4], "pad_value": 0.5}, "Out",
         True, t),
        ("multiplex", "multiplex", {"X": [x(R, W), x(R, W), x(R, W)],
                                    "Ids": rng.randint(0, 3, (R, 1)).astype(np.int32)},
         {}, "Out", True, t),
        ("maxout", "maxout", {"X": tied(R, 16, 8, 8)}, {"groups": 4}, "Out", True, t),
        ("prelu", "prelu", {"X": x(R, W), "Alpha": pos(1)}, {"mode": "all"}, "Out", True, t),
        ("prelu_channel", "prelu", {"X": img(R), "Alpha": pos(16)}, {"mode": "channel"}, "Out",
         True, t),
        ("dot_prod", "dot_prod", {"X": x(R, W), "Y": x(R, W)}, {}, "Out", True, t),
        ("out_prod", "out_prod", {"X": x(R, 32), "Y": x(R, 32)}, {}, "Out", True, t),
        ("l2_distance", "l2_distance", {"X": x(R, W), "Y": x(R, W)}, {}, "Out", True, t),
        ("row_l2_norm", "row_l2_norm", {"X": x(R, W)}, {}, "Out", True, t),
        ("interpolation", "interpolation", {"X": x(R, W), "Y": x(R, W),
                                            "W": 1 / (1 + np.exp(-x(R, 1)))}, {}, "Out", True,
         t),
        ("power", "power", {"X": pos(R, W), "W": pos(R, 1)}, {}, "Out", True, t),
        ("scaling", "scaling", {"X": x(R, W), "W": x(R, 1)}, {}, "Out", True, t),
        ("slope_intercept", "slope_intercept", {"X": x(R, W)},
         {"slope": -0.7, "intercept": 0.3}, "Out", True, t),
        ("sum_to_one_norm", "sum_to_one_norm", {"X": pos(R, W)}, {}, "Out", True, t),
        ("convex_comb", "convex_comb", {"W": pos(R, 4), "X": x(R, W)}, {}, "Out", True, t),
        ("scale_shift", "scale_shift", {"X": x(R, W), "Scale": pos(1), "Bias": x(1)}, {},
         "Out", True, t),
        ("scale_sub_region", "scale_sub_region", {"X": img(R)},
         {"indices": [2, 9, 2, 6, 3, 8], "scale": 2.0}, "Out", True, t),
        ("rotate", "rotate", {"X": img(R)}, {}, "Out", True, t),
        ("switch_order", "switch_order", {"X": img(R)}, {}, "Out", True, t),
        ("bilinear_interp", "bilinear_interp", {"X": x(R, 4, 16, 16)},
         {"out_h": 31, "out_w": 23}, "Out", True, t),
        ("im2sequence", "im2sequence", {"X": x(32, 16, 16, 16)},
         {"block_y": 3, "block_x": 3, "stride_y": 2, "stride_x": 2, "padding_y": 1,
          "padding_x": 1}, "Out", True, t),
        ("row_conv", "row_conv", {"X": ("lod", [x(int(m), W) for m in
                                                rng.randint(1, R // 4, 8)]),
                                  "Filter": x(5, W)}, {}, "Out", True, t),
        ("conv_shift", "conv_shift", {"X": x(R, W), "Y": x(R, 5)}, {}, "Out", True, t),
        ("factorization_machine", "factorization_machine",
         {"X": x(R, W), "Factor": x(W, 16) / 32}, {}, "Out", True, t),
        ("bilinear_tensor_product", "bilinear_tensor_product",
         {"X": x(R, 64), "Y": x(R, 64), "Weight": x(16, 64, 64) / 8, "Bias": x(16)}, {}, "Out",
         True, t),
        ("selective_fc", "selective_fc", {"X": x(R, W), "W": x(W, 512) / 32, "Bias": x(512),
                                          "Mask": (rng.rand(R, 512) < 0.3).astype(np.float32)},
         {}, "Out", True, t),
        ("conv3d", "conv3d", {"Input": x(*VOL), "Filter": x(VOL[1], VOL[1], 3, 3, 3) / 40,
                              "Bias": x(VOL[1])},
         {"strides": [1, 1, 1], "paddings": [1, 1, 1]}, "Output", True, CONV3D_TOL),
        ("pool3d_max", "pool3d", {"X": x(*VOL)},
         {"pooling_type": "max", "ksize": [2, 2, 2], "strides": [2, 2, 2]}, "Out", True, t),
        ("pool3d_avg", "pool3d", {"X": x(*VOL)},
         {"pooling_type": "avg", "ksize": [3, 3, 3], "strides": [2, 2, 2],
          "paddings": [1, 1, 1]}, "Out", True, t),
        ("roi_pool", "roi_pool", {"X": tied(2, ROI["channels"], ROI["h"], ROI["w"]),
                                  "ROIs": roi_boxes(rng, ROI["cpu_rois"], 2)},
         {"pooled_height": ROI["bins"], "pooled_width": ROI["bins"],
          "spatial_scale": ROI["scale"]}, "Out", True, t),
        ("spp_max", "spp", {"X": tied(16, 256, 13, 13)}, {"pyramid_height": 3}, "Out", True,
         t),
        ("spp_avg", "spp", {"X": x(16, 256, 13, 13)},
         {"pyramid_height": 3, "pooling_type": "avg"}, "Out", True, t),
    ]


# conv3d's weight gradient sums 401,408 products a value: card and CPU
# round them in other orders
CONV3D_TOL = 1e-4


def roi_boxes(rng, n, images):
    """`n` ROIs (batch index, x1, y1, x2, y2) in the 16x-downsampled map's
    image coordinates (600 x 800), Fast R-CNN's proposals' sizes."""
    x1 = rng.uniform(0, 700, n)
    y1 = rng.uniform(0, 500, n)
    w = rng.uniform(16, 400, n)
    h = rng.uniform(16, 300, n)
    return np.stack([rng.randint(0, images, n), x1, y1, np.minimum(x1 + w, 799),
                     np.minimum(y1 + h, 599)], 1).astype(np.float32)


def run_misc_op(ptt, dev, op_type, inputs, attrs, out_slot, grad, cot_seed):
    """One op on `dev`: its output and the gradients of Σ out·cot to its
    float inputs, as numpy (run_op with a slot of several inputs)."""
    from paddle_tpu_torch.core import registry as treg
    from paddle_tpu_torch.core.program import Operator

    env, leaves, slots = {"@RNG@": torch.Generator(device=dev).manual_seed(0)}, [], {}
    for slot, v in inputs.items():
        vals = v if isinstance(v, list) else [v]
        slots[slot] = [f"{slot}_{i}" for i in range(len(vals))]
        for name, a in zip(slots[slot], vals):
            if isinstance(a, tuple):
                t = ptt.LoDArray.from_sequences(a[1], capacity=MISC_ROWS * 2, max_seqs=8).to(dev)
                if grad:
                    t = t.with_data(t.data.clone().requires_grad_(True))
                    leaves.append(t.data)
            else:
                t = torch.as_tensor(a, device=dev)
                if grad and t.is_floating_point() and slot != "ROIs":
                    t = t.clone().requires_grad_(True)
                    leaves.append(t)
            env[name] = t
    with torch.enable_grad():
        treg.get_kernel(op_type)(treg.OpContext(Operator(op_type, slots, {out_slot: ["o"]},
                                                         dict(attrs)), env))
        out = env["o"]
        out = out.data if isinstance(out, ptt.LoDArray) else out
        grads = []
        if grad:
            cot = np.random.RandomState(cot_seed).standard_normal(tuple(out.shape))
            loss = (out.float() * torch.as_tensor(cot.astype(np.float32), device=dev)).sum()
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    host = lambda t: None if t is None else t.detach().float().cpu().numpy() \
        if t.is_floating_point() else t.detach().cpu().numpy()  # noqa: E731
    return host(out), [host(g) for g in grads]


def misc_ops_phase(ptt, smi, seed, n):
    """Phase n: every new cost and misc op card against CPU, forward and
    gradient; nce on fixed negatives; roi_pool at 128 ROIs timed with its
    peak memory; sampling_id's draws against its probabilities."""
    from paddle_tpu_torch.core import registry as treg
    from paddle_tpu_torch.core.program import Operator
    from paddle_tpu_torch.ops import cost_ops

    phase(n, f"the cost and misc ops card against CPU: [{MISC_ROWS} x {MISC_WIDTH}] inputs, "
             f"nce and hsigmoid over {NCE_CLASSES} classes at width {NCE_WIDTH}, B="
             f"{NCE_BATCH}; conv3d and pool3d at B={VOL[0]}, {VOL[1]} channels, "
             f"{VOL[2]}x{VOL[3]}x{VOL[4]}; roi_pool over "
             f"VGG16's conv5 ({ROI['channels']}x{ROI['h']}x{ROI['w']}, {ROI['bins']}x"
             f"{ROI['bins']} bins), {ROI['cpu_rois']} ROIs against the CPU, "
             f"{ROI['card_rois']} on the card timed; spp, bilinear_interp, im2sequence; "
             "sampling_id's draws")
    ptt.Executor()  # the card's settings: no TF32 in cuDNN
    t_start = time.perf_counter()
    rng = np.random.RandomState(seed + 670)
    cases = misc_cases(rng)
    worst, ops_seen = {}, set()
    for i, (label, op, ins, attrs, slot, grad, tol) in enumerate(cases):
        ops_seen.add(op)
        (co, cg), (go, gg) = (run_misc_op(ptt, dev, op, ins, attrs, slot, grad, seed + i)
                              for dev in ("cpu", CARD))
        errs = []
        for c_, g_ in zip([co] + cg, [go] + gg):
            if c_ is None:
                check(g_ is None, f"{label}: a gradient on the card only")
                continue
            if not np.issubdtype(c_.dtype, np.floating):
                check(np.array_equal(c_, g_), f"{label}: card and CPU differ")
                errs.append(0.0)
                continue
            errs.append(float(np.abs(g_ - c_).max()) / max(1.0, float(np.abs(c_).max())))
        worst[label] = max(errs)
        check(worst[label] <= tol, f"{label}: {worst[label]:.3e} of its scale apart, card "
                                   f"against CPU (tol {tol:g})")
    # nce on the same negatives on both devices
    x = rng.standard_normal((NCE_BATCH, NCE_WIDTH)).astype(np.float32) / 8
    w = rng.standard_normal((NCE_CLASSES, NCE_WIDTH)).astype(np.float32) / 8
    b = rng.standard_normal(NCE_CLASSES).astype(np.float32)
    lbl = rng.randint(0, NCE_CLASSES, NCE_BATCH)
    neg = rng.randint(0, NCE_CLASSES, (NCE_BATCH, NCE_NEG))
    res = {}
    for dev in ("cpu", CARD):
        xs, ws, bs = (torch.as_tensor(a, device=dev).requires_grad_(True) for a in (x, w, b))
        with torch.enable_grad():
            cost = cost_ops.nce_loss(xs, ws, torch.as_tensor(lbl, device=dev),
                                     torch.as_tensor(neg, device=dev), bs)
            grads = torch.autograd.grad(cost.sum(), [xs, ws, bs])
        res[dev] = [t.detach().cpu().numpy() for t in (cost,) + tuple(grads)]
    worst["nce"] = max(float(np.abs(g_ - c_).max()) / max(1.0, float(np.abs(c_).max()))
                       for c_, g_ in zip(res["cpu"], res[CARD]))
    ops_seen.add("nce")
    check(worst["nce"] <= OPS_TOL[None], f"nce: {worst['nce']:.3e} card against CPU")
    # roi_pool at Fast R-CNN's 128 ROIs, the card alone
    feat = torch.as_tensor(np.maximum(rng.standard_normal(
        (2, ROI["channels"], ROI["h"], ROI["w"])), 0).astype(np.float32), device=CARD)
    rois = torch.as_tensor(roi_boxes(rng, ROI["card_rois"], 2), device=CARD)
    feat.requires_grad_(True)
    attrs = {"pooled_height": ROI["bins"], "pooled_width": ROI["bins"],
             "spatial_scale": ROI["scale"]}

    def roi_fwd():
        env = {"x": feat, "r": rois}
        treg.get_kernel("roi_pool")(treg.OpContext(Operator(
            "roi_pool", {"X": ["x"], "ROIs": ["r"]}, {"Out": ["o"]}, attrs), env))
        return env["o"]

    def roi_fwd_bwd():
        o = roi_fwd()
        torch.autograd.grad(o, [feat], torch.ones_like(o))

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with torch.enable_grad():
        fb_ms = cuda_ms(roi_fwd_bwd, 3)
    roi_peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    with torch.no_grad():
        f_ms = cuda_ms(roi_fwd, 5)
    print(f"  roi_pool, {ROI['card_rois']} ROIs over [2, {ROI['channels']}, {ROI['h']}, "
          f"{ROI['w']}]: forward {f_ms:.3f} ms, forward and gradient {fb_ms:.3f} ms, peak "
          f"{roi_peak:.2f} GiB above its inputs (the JAX op's mask would be "
          f"{ROI['card_rois'] * ROI['bins'] ** 2 * ROI['channels'] * ROI['h'] * ROI['w'] * 4 / 1e9:.1f}"
          " GB)")
    check(roi_peak < 8.0, f"roi_pool at {ROI['card_rois']} ROIs held {roi_peak:.2f} GiB")
    del feat, rois
    # sampling_id on the card: each column's frequency against its probability
    p = np.array([0.05, 0.0, 0.4, 0.15, 0.3, 0.1], np.float32)
    rows = 200_000
    env = {"x": torch.as_tensor(np.tile(p, (rows, 1)), device=CARD),
           "@RNG@": torch.Generator(device=CARD).manual_seed(seed)}
    treg.get_kernel("sampling_id")(treg.OpContext(Operator(
        "sampling_id", {"X": ["x"]}, {"Out": ["o"]}, {}), env))
    ids = env["o"].cpu().numpy()
    freq = np.bincount(ids, minlength=len(p)) / rows
    sigma = np.sqrt(p * (1 - p) / rows)
    z = float((np.abs(freq - p) / np.maximum(sigma, 1e-12)).max())
    ops_seen.add("sampling_id")
    print(f"  sampling_id: {rows} draws, frequencies {np.round(freq, 4).tolist()} against "
          f"{p.tolist()}, at most {z:.2f} sigma off; the column of probability 0 never drawn")
    check(ids.dtype == np.int32 and freq[1] == 0.0 and z <= 5.0, "sampling_id off its law")
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:4]
    print(f"  {len(ops_seen)} op types, {len(cases) + 1} cases card against CPU (forward and "
          f"gradient, f32): the largest errors over their scales {top} (tol "
          f"{OPS_TOL[None]:g}, conv3d {CONV3D_TOL:g}); on {smi}")
    out = dict(ops=len(ops_seen), cases=len(cases) + 1, worst=worst,
               roi_pool=dict(rois=ROI["card_rois"], fwd_ms=f_ms, fwd_bwd_ms=fb_ms,
                             peak_gib=roi_peak),
               sampling_id_max_sigma=z)
    check(len(ops_seen) == MISC_OP_TYPES, f"phase {n} ran {len(ops_seen)} op types, not "
                                           f"{MISC_OP_TYPES}")
    out["seconds"] = time.perf_counter() - t_start
    print(f"  phase {n}: {out['seconds']:.1f} s")
    return out


# phase 68: bench.py's pipeline row (bench.py:1716-1860) on the transformer
# row: (schedule, K stages, M micro-batches); K=1 is each M's reference
PIPE_CELLS = [("gpipe", 1, 4), ("gpipe", 2, 4), ("gpipe", 4, 4), ("gpipe", 1, 8),
              ("gpipe", 2, 8), ("gpipe", 4, 8), ("1f1b", 4, 8)]
PIPE_TIMED = 5  # timed steps a cell, after the 2 the bits are read on
PIPE_WINDOW = dict(K=2, M=4, steps=4)  # phase 69
# phase 70: bench.py's lstm row split over 2 ranks of 64 rows (gloo on the
# one card), 3 steps, then a sharded checkpoint and 2 more
DP_RANKS, DP_STEPS, DP_MORE = 2, 3, 2
DP_START_S = 300  # seconds for the ranks to finish
# bf16, 2 ranks of 64 rows against one process on 128 (see dp_compare): the
# losses within 1e-3 relative, and at most 2% of a parameter's values more
# than 0.5 lr a step apart (Adam moves each value by about lr a step, so a
# gradient near 0 that flips sign moves it by up to 2 lr)
DP_LOSS_RTOL, DP_FAR_LR, DP_FAR_SHARE = 1e-3, 0.5, 0.02
ULYSSES_TOL = 2e-2  # phase 71: ring attention in f32 against the bf16 formula


def pipeline_phase(ptt, smi, seed, n):
    """Phase n: bench.py's pipeline grid at the transformer row's width; one
    startup, its state kept on the card and restored for each cell."""
    from paddle_tpu_torch.ops import flash_kernels as fk
    from paddle_tpu_torch.ops import flash_ops

    phase(n, "the pipeline grid on bench.py's transformer row (dim 2048, 8 layers, B=8, "
             "T=1024, bf16, Adam): gpipe K in {1, 2, 4} x M in {4, 8}, 1f1b K=4 M=8")
    t_start = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    # B8 at the micro-batch's B=1 (M=8) before the grid leans on it
    rng = np.random.RandomState(seed + 68)
    q1, k1, v1 = (torch.as_tensor(rng.standard_normal((1, 1024, 32, 64)), dtype=torch.bfloat16,
                                  device="cuda") for _ in range(3))
    got = fk.flash_fused(q1, k1, v1, True)
    want = flash_ops.scaled_dot_product_attention(q1.float(), k1.float(), v1.float(), True)
    err = float((got.float() - want).abs().max() / want.abs().max())
    print(f"  B8 forward at B=1 (a micro-batch of M=8): max error {err:.3e} of the f32 "
          f"formula's largest (tol {ULYSSES_TOL})")
    check(err <= ULYSSES_TOL, f"B8 at B=1: error {err:.3e}")
    main_p, startup, loss = build_transformer_program(ptt, **TFM_BENCH)
    main_p.set_amp("bfloat16")
    sc = ptt.Scope()
    ptt.Executor().run(startup, scope=sc, seed=seed)
    persist = [v.name for v in main_p.persistables() if sc.has(v.name)]
    params = [p.name for p in main_p.parameters()]
    base = {k: sc.get(k).clone() for k in persist}
    feed = transformer_feed(np.random.RandomState(0), TFM_BENCH["vocab"], TFM_BENCH["seqlen"],
                            TFM_BENCH["batch"])
    refs, cells = {}, {}
    for sched, K, M in PIPE_CELLS:
        for k in persist:
            sc.set(k, base[k].clone())
        exe = ptt.PipelineExecutor(num_stages=K, num_microbatches=M, schedule=sched)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        losses = [float(exe.run(main_p, feed, [loss.name], scope=sc)[0]) for _ in range(2)]
        torch.cuda.synchronize()
        after2 = {k: sc.get(k) for k in params}
        if K == 1:
            refs[M] = ({k: v.clone() for k, v in after2.items()}, losses)
            same = None
        else:
            same = next((k for k in params if not torch.equal(after2[k], refs[M][0][k])), None)
            check(losses == refs[M][1], f"{sched} K={K} M={M}: losses {losses} are not K=1's "
                                        f"{refs[M][1]}")
            check(same is None, f"{sched} K={K} M={M}: the parameters after 2 steps differ "
                                f"from K=1's at M={M}, first at {same}")
        for k in TFM_STEP_LAUNCHES:
            setattr(fk, f"{k}_launches", 0)
        flash_ops.plain_routes = 0
        times = []
        for _ in range(PIPE_TIMED):
            t0 = time.perf_counter()
            exe.run(main_p, feed, [loss.name], scope=sc)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        launches = {k: getattr(fk, f"{k}_launches") / PIPE_TIMED for k in TFM_STEP_LAUNCHES}
        want_l = {k: 8 * M for k in TFM_STEP_LAUNCHES}
        if sched == "1f1b":
            want_l["flash_fwd"] += 8 * M  # each stage's forward again in the drain
        cells[(sched, K, M)] = dict(
            schedule=sched, K=K, M=M, losses=losses, steps_ms=times,
            ms_per_step=statistics.median(times), peak_gib=torch.cuda.max_memory_allocated() / 2**30,
            bubble=(K - 1) / (M + K - 1), launches_per_step=launches,
            plain_routes=flash_ops.plain_routes, bits_as_k1=K == 1 or same is None,
            stages=len(exe._staged(main_p, [loss.name]).stages))
        check(launches == want_l, f"{sched} K={K} M={M}: B8 launches a step {launches}, not "
                                  f"{want_l}")
        check(flash_ops.plain_routes == 0, f"{sched} K={K} M={M}: attention routed to the plain "
                                           "formula")
        check(all(np.isfinite(losses)), f"{sched} K={K} M={M}: non-finite loss")
        del exe, after2
    print(f"  one card: t(K,M)/t(1,M) is the staging's own overhead (every stage runs on the "
          f"one card in turn), not the bubble, which needs stages on separate cards; the "
          f"analytic bubble (K-1)/(M+K-1) is printed beside it. On {smi}:")
    for (sched, K, M), c in cells.items():
        c["ratio_to_k1"] = c["ms_per_step"] / cells[("gpipe", 1, M)]["ms_per_step"]
        print(f"    {sched} K={K} M={M}: {c['ms_per_step']:.3f} ms a step (median of "
              f"{PIPE_TIMED}: {[round(t, 3) for t in c['steps_ms']]}), t/t(1,M) "
              f"{c['ratio_to_k1']:.3f}, bubble {c['bubble']:.3f}, peak {c['peak_gib']:.2f} GiB, "
              f"B8 a step {c['launches_per_step']}, plain routes {c['plain_routes']}; after 2 "
              f"steps {'K=1 itself' if K == 1 else 'the K=1 bits'} ({len(params)} parameters)")
    g, f = cells[("gpipe", 4, 8)]["peak_gib"], cells[("1f1b", 4, 8)]["peak_gib"]
    check(f < g, f"1f1b's peak {f:.2f} GiB is not below gpipe's {g:.2f} GiB at K=4, M=8")
    out = {"cells": [dict(c) for c in cells.values()], "state_gib": sum(
        v.numel() * v.element_size() for v in base.values()) / 2**30}
    del refs, base, sc
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_start
    return out, main_p, startup, loss


def pipeline_window_phase(ptt, smi, seed, n, main_p, startup, loss):
    """Phase n: Trainer(scan_window) on a PipelineExecutor at the same width,
    against the per-step loop from one state; the staged step's ticks under
    torch.cuda.set_sync_debug_mode("error")."""
    from paddle_tpu_torch.ops import flash_kernels as fk

    K, M, steps = PIPE_WINDOW["K"], PIPE_WINDOW["M"], PIPE_WINDOW["steps"]
    phase(n, f"the pipeline (K={K}, M={M}) through Trainer(scan_window={steps}) against the "
             "per-step loop, then the staged step under set_sync_debug_mode('error')")
    t_start = time.perf_counter()
    feed = transformer_feed(np.random.RandomState(0), TFM_BENCH["vocab"], TFM_BENCH["seqlen"],
                            TFM_BENCH["batch"])
    names = [p.name for p in main_p.parameters()]
    main_p.random_seed = seed + 69
    out = {}

    def run(window):
        sc = ptt.Scope()
        ptt.Executor().run(startup, scope=sc, seed=seed)
        exe = ptt.PipelineExecutor(num_stages=K, num_microbatches=M)
        t = ptt.Trainer(loss, main_program=main_p, startup_program=startup, scope=sc,
                        executor=exe)
        t._initialized = True
        before = fk.flash_fwd_launches
        t0 = time.perf_counter()
        t.train(lambda: iter([feed] * steps), num_passes=1, scan_window=window)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        t.stop()
        return sc, exe, wall, fk.flash_fwd_launches - before

    sc0, _, wall0, l0 = run(None)
    want = host_state(sc0, names)
    del sc0
    gc.collect()
    torch.cuda.empty_cache()
    sc1, wexe, wall1, l1 = run(steps)
    got = host_state(sc1, names)
    d = next((k for k in names if not torch.equal(got[k], want[k])), None)
    stats = dict(wexe.cache_stats)
    print(f"  per-step loop {wall0 / steps:.3f} ms a step, the window {wall1 / steps:.3f} ms a "
          f"step ({steps} steps, its warm-up and capture included); cache {stats}; B8 forward "
          f"launches {l0} and {l1} over the {steps} steps (a replay counts its capture's)")
    check(d is None, f"the window's parameters differ from the per-step loop's, first at {d}")
    check(stats["captures"] == 1 and stats["replays"] == steps - 1,
          f"the window did not capture once and replay: {stats}")
    check(l0 == l1 == 8 * M * steps, f"B8 forward launches {l0}, {l1}, not {8 * M * steps}")
    print(f"  the window ends on the per-step loop's bits ({len(names)} parameters) on {smi}")
    out.update(per_step_ms=wall0 / steps, window_ms=wall1 / steps, cache=stats,
               flash_fwd_launches_per_step=l1 / steps)
    del got, want
    # the staged step's ticks and tail with every host sync an error
    exe = ptt.PipelineExecutor(num_stages=K, num_microbatches=M)
    env = {k: sc1.get(k) for k in (v.name for v in main_p.persistables()) if sc1.has(k)}
    env.update({k: torch.as_tensor(v, device="cuda") for k, v in feed.items()})
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    exe._seed_step_generators(seed)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        exe._execute(main_p, env, [loss.name], [v.name for v in main_p.persistables()], gen)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(env[loss.name]).all()), "the staged step's loss is not finite")
    print("  the staged step's ticks and tail ran under set_sync_debug_mode('error') with no "
          "host sync")
    out["sync_debug_silent"] = True
    main_p.random_seed = 0
    del sc1, wexe, exe, env
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_start
    return out


def dp_rank_main(rank, init, out_dir, seed):
    """One rank of phase 70 (a process of its own, gloo on the one card):
    bench.py's lstm row on its 64 rows of the global batch."""
    sys.path.insert(0, ROOT)
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.ops import lstm_kernels as lk
    from paddle_tpu_torch.parallel import ParallelExecutor, distributed, mesh_from_spec

    distributed.init_distributed(init, DP_RANKS, rank, backend="gloo")
    try:
        main_p, startup, loss = build_lstm_program(ptt, **LSTM_BENCH)
        main_p.set_amp("bfloat16")
        sc = ptt.Scope()
        ptt.Executor().run(startup, scope=sc, seed=seed)
        feed = lstm_bench_feed(ptt, LSTM_BENCH["vocab"], LSTM_BENCH["seqlen"],
                               LSTM_BENCH["batch"], "cuda")
        exe = ParallelExecutor(mesh_from_spec(f"dp{DP_RANKS}"))
        print(f"rank {rank}: device {exe.device}, backend {torch.distributed.get_backend()}",
              flush=True)
        lk.lstm_fwd_launches = lk.lstm_bwd_launches = 0
        losses = [float(exe.run(main_p, feed, [loss.name], scope=sc)[0])
                  for _ in range(DP_STEPS)]
        launches = [lk.lstm_fwd_launches, lk.lstm_bwd_launches]
        names = [v.name for v in main_p.persistables()]
        out = {f"s3.{k}": v for k, v in ptt.io.state_to_numpy(sc, names).items()}
        ptt.io.save_checkpoint(os.path.join(out_dir, "ckpt"), {"step": DP_STEPS}, main_p, sc,
                               sharded=True)
        losses += [float(exe.run(main_p, feed, [loss.name], scope=sc)[0])
                   for _ in range(DP_MORE)]
        out.update({f"s5.{k}": v for k, v in ptt.io.state_to_numpy(sc, names).items()})
        out["losses"] = np.array(losses)
        out["launches"] = np.array(launches)
        # (a) again with ZeRO-1, from the same startup: each rank updates its
        # rows of every accumulator whose first dimension divides by dp, and
        # all-gathers the parameters
        del sc
        sc = ptt.Scope()
        ptt.Executor().run(startup, scope=sc, seed=seed)
        zexe = ParallelExecutor(mesh_from_spec(f"dp{DP_RANKS}"), shard_optimizer_state=True)
        lk.lstm_fwd_launches = lk.lstm_bwd_launches = 0
        out["zero.losses"] = np.array([float(zexe.run(main_p, feed, [loss.name], scope=sc)[0])
                                       for _ in range(DP_STEPS)])
        out["zero.launches"] = np.array([lk.lstm_fwd_launches, lk.lstm_bwd_launches])
        out.update({f"z3.{k}": v for k, v in ptt.io.state_to_numpy(sc, names).items()})
        sliced = sorted(sc.shards)
        out["zero.sliced"] = np.array(sliced).astype(str)
        out["zero.slices"] = np.array([sc.shards[k]["slice"][0] for k in sliced])
        out["zero.whole_rows"] = np.array([sc.shards[k]["shape"][0] for k in sliced])
        out["zero.opt_state"] = np.array([main_p.global_block().var(k).is_optimizer_state
                                          for k in sliced])
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
        print(f"rank {rank}: losses {losses}; B1, B2 launches in {DP_STEPS} steps {launches}; "
              f"ZeRO-1: losses {out['zero.losses'].tolist()}, {len(sliced)} accumulators "
              f"sliced, B1, B2 launches {out['zero.launches'].tolist()}", flush=True)
    finally:
        distributed.shutdown()


def dp_compare(label, got, want, lr, steps):
    """The bf16 bound of DP_FAR_*: losses, then each parameter's share of
    values more than DP_FAR_LR lr a step from the single process's."""
    worst, worst_name, far = 0.0, None, 0.0
    for k, w in want.items():
        d = np.abs(got[k] - w)
        share = float(np.mean(d > DP_FAR_LR * lr * steps)) if w.size else 0.0
        far = max(far, float(d.max()) / (lr * steps)) if w.size else far
        if share > worst or worst_name is None:
            worst, worst_name = share, k
    print(f"  {label}: largest share of values past {DP_FAR_LR} lr a step: {worst:.4%} "
          f"({worst_name}; bound {DP_FAR_SHARE:.0%}); the largest difference {far:.4f} lr a "
          f"step")
    check(worst <= DP_FAR_SHARE, f"{label}: {worst:.4%} of {worst_name}'s values past "
                                 f"{DP_FAR_LR} lr a step")
    return worst


def data_parallel_phase(ptt, smi, seed, n):
    """Phase n: ParallelExecutor on bench.py's lstm row: (a) 2 ranks over gloo
    on the one card against one process on the whole batch, then again with
    ZeRO-1 against (a)'s bits, (b) world size 1 over NCCL against the plain
    Executor's bits, (c) (a)'s sharded checkpoint at world size 1."""
    from paddle_tpu_torch.ops import lstm_kernels as lk
    from paddle_tpu_torch.parallel import ParallelExecutor, distributed, mesh_from_spec

    phase(n, f"data parallel on bench.py's lstm row (H=512, T=100, B=128, bf16): (a) "
             f"{DP_RANKS} ranks over gloo on the one card, 64 rows each, replicated and "
             "ZeRO-1; (b) world size 1 over NCCL; (c) (a)'s sharded checkpoint at world size 1")
    t_start = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    os.makedirs(LOG_DIR, exist_ok=True)
    init = f"file://{os.path.join(work, 'rendezvous')}"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    procs, logs = [], []
    for r in range(DP_RANKS):
        log = os.path.join(LOG_DIR, f"dp_rank{r}.log")
        logs.append(log)
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--seed", str(seed),
                 "--dp_rank", str(r), "--dp_init", init, "--dp_dir", work],
                cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT, start_new_session=True))
    # meanwhile, the single process on the whole batch
    main_p, startup, loss = build_lstm_program(ptt, **LSTM_BENCH)
    main_p.set_amp("bfloat16")
    names = [v.name for v in main_p.persistables()]
    feed = lstm_bench_feed(ptt, LSTM_BENCH["vocab"], LSTM_BENCH["seqlen"], LSTM_BENCH["batch"],
                           "cuda")

    def fresh():
        sc = ptt.Scope()
        ptt.Executor().run(startup, scope=sc, seed=seed)
        return sc
    exe = ptt.Executor()
    sc = fresh()
    single = [float(exe.run(main_p, feed, [loss.name], scope=sc)[0]) for _ in range(DP_STEPS)]
    s3 = ptt.io.state_to_numpy(sc, names)
    single += [float(exe.run(main_p, feed, [loss.name], scope=sc)[0]) for _ in range(DP_MORE)]
    s5 = ptt.io.state_to_numpy(sc, names)
    try:
        deadline = time.monotonic() + DP_START_S
        for r, p in enumerate(procs):
            try:
                rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                rc = None
            if rc != 0:
                for log in logs:
                    with open(log, errors="replace") as f:
                        print(f"---- {os.path.relpath(log, ROOT)}\n" + "".join(f.readlines()[-30:]))
                fail(f"data-parallel rank {r} exited {rc}")
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    ranks = [dict(np.load(os.path.join(work, f"rank{r}.npz"))) for r in range(DP_RANKS)]
    out = {"a": {}, "b": {}, "c": {}}
    for log in logs:
        with open(log) as f:
            print("  " + "  ".join(l for l in f if l.startswith("rank ")), end="")
    # the replicated run's values (ZeRO-1's slices differ by rank: dp_zero_check)
    diff = [k for k in ranks[0] if not k.startswith(("z3.", "zero."))
            and not np.array_equal(ranks[0][k], ranks[1][k])]
    check(not diff, f"(a) the two ranks' values differ: {diff[:4]}")
    rl = [float(x) for x in ranks[0]["losses"]]
    print(f"  (a) the ranks agree bit for bit ({len(names)} persistables, after step 3 and 5); "
          f"losses {rl} against one process's {single}")
    check(np.allclose(rl, single, rtol=DP_LOSS_RTOL, atol=0),
          f"(a) losses {rl} are not within {DP_LOSS_RTOL} of {single}")
    launches = list(ranks[0]["launches"])
    check(launches == [2 * DP_STEPS, 2 * DP_STEPS],
          f"(a) B1, B2 launched {launches} times in {DP_STEPS} rank steps, not 2 a step each")
    share = dp_compare("(a) after 3 steps", {k[3:]: v for k, v in ranks[0].items()
                                            if k.startswith("s3.")}, s3, LSTM_LR, DP_STEPS)
    out["a"] = dict(losses=rl, single_losses=single, launches_per_rank_step=[
        x / DP_STEPS for x in launches], far_share=share)
    out["a"]["zero1"] = dp_zero_check(ranks, names)
    # (b) world size 1 over NCCL: the plain Executor's bits
    distributed.init_distributed(f"file://{os.path.join(work, 'nccl1')}", 1, 0)
    try:
        sc = fresh()
        want = [float(exe.run(main_p, feed, [loss.name], scope=sc)[0]) for _ in range(DP_STEPS)]
        want_p = ptt.io.state_to_numpy(sc, names)
        sc = fresh()
        e = ParallelExecutor(mesh_from_spec("dp1"))
        lk.lstm_fwd_launches = lk.lstm_bwd_launches = 0
        ls = [float(e.run(main_p, feed, [loss.name], scope=sc)[0]) for _ in range(DP_STEPS)]
        got = ptt.io.state_to_numpy(sc, names)
        d = next((k for k in names if not np.array_equal(got[k], want_p[k])), None)
        print(f"  (b) ParallelExecutor over {torch.distributed.get_backend()}, world size 1: "
              f"losses {ls}; B1, B2 launches {lk.lstm_fwd_launches}, {lk.lstm_bwd_launches}; "
              f"the plain Executor's bits: {d is None}")
        check(d is None, f"(b) differs from the plain Executor first at {d}")
        check(np.allclose(ls, want, rtol=1e-6, atol=0), f"(b) losses {ls}")
        out["b"]["plain"] = dict(losses=ls, same_bits=True)
        del sc, got, want_p
        # (c) (a)'s sharded checkpoint at world size 1, then 2 more steps
        out["c"] = dp_resume(ptt, exe, main_p, loss, feed, names, work, ranks, rl)
        ulysses = ulysses_ring_phase(ptt, smi, seed, n + 1)
    finally:
        distributed.shutdown()
    del s3, s5
    shutil.rmtree(work, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_start
    return out, ulysses


def dp_zero_check(ranks, names):
    """Phase 70 (a) with ZeRO-1 on the 2 ranks: the same losses and
    parameters, bit for bit, as (a)'s replicated run; each sliced
    accumulator is an optimizer accumulator holding rows [r·n/2, (r+1)·n/2)
    of (a)'s, bit for bit."""
    for r, rk in enumerate(ranks):
        sliced = [str(k) for k in rk["zero.sliced"]]
        check(sliced and bool(rk["zero.opt_state"].all()),
              f"(a) ZeRO-1 rank {r}: sliced {sliced[:4]}, not optimizer accumulators only")
        check(np.array_equal(rk["zero.losses"], rk["losses"][:DP_STEPS]),
              f"(a) ZeRO-1 rank {r}: losses {rk['zero.losses']} against {rk['losses']}")
        check(rk["zero.launches"].tolist() == [2 * DP_STEPS, 2 * DP_STEPS],
              f"(a) ZeRO-1 rank {r}: B1, B2 launched {rk['zero.launches'].tolist()} times")
        for k, (a, b), rows in zip(sliced, rk["zero.slices"], rk["zero.whole_rows"]):
            check((a, b) == (r * rows // DP_RANKS, (r + 1) * rows // DP_RANKS)
                  and rk[f"z3.{k}"].shape[0] == b - a,
                  f"(a) ZeRO-1 rank {r}: {k} holds rows [{a}, {b}) of {rows}, "
                  f"shape {rk[f'z3.{k}'].shape}")
            check(np.array_equal(rk[f"z3.{k}"], rk[f"s3.{k}"][a:b]),
                  f"(a) ZeRO-1 rank {r}: {k}'s rows differ from the replicated run's")
        d = next((k for k in names if k not in sliced
                  and not np.array_equal(rk[f"z3.{k}"], rk[f"s3.{k}"])), None)
        check(d is None, f"(a) ZeRO-1 rank {r}: differs from the replicated run first at {d}")
    n = len(ranks[0]["zero.sliced"])
    print(f"  (a) ZeRO-1 on the {DP_RANKS} ranks: the replicated run's losses and bits; "
          f"{n} accumulators sliced, each rank holding its half of their rows "
          f"(e.g. {ranks[0]['zero.sliced'][0]}: rows {ranks[0]['zero.slices'][0].tolist()} of "
          f"{ranks[0]['zero.whole_rows'][0]} on rank 0)")
    return dict(sliced=n, same_bits=True)


def dp_resume(ptt, exe, main_p, loss, feed, names, work, ranks, rl):
    """Phase 70 (c): (a)'s sharded checkpoint loaded at world size 1 holds
    (a)'s bits after step 3; 2 more steps stay within the bf16 bound of
    (a)'s uninterrupted run."""
    sc = ptt.Scope()
    args = ptt.io.load_checkpoint(os.path.join(work, "ckpt"), main_p, sc)
    got = ptt.io.state_to_numpy(sc, names)
    d = next((k for k in names if not np.array_equal(got[k], ranks[0][f"s3.{k}"])), None)
    check(args == {"step": DP_STEPS} and d is None,
          f"(c) the sharded checkpoint did not load (a)'s bits (args {args}, first at {d})")
    more = [float(exe.run(main_p, feed, [loss.name], scope=sc)[0]) for _ in range(DP_MORE)]
    print(f"  (c) (a)'s sharded checkpoint loads at world size 1 with (a)'s bits; 2 more steps: "
          f"losses {more} against (a)'s {rl[DP_STEPS:]}")
    check(np.allclose(more, rl[DP_STEPS:], rtol=DP_LOSS_RTOL, atol=0),
          f"(c) losses {more} are not within {DP_LOSS_RTOL} of (a)'s {rl[DP_STEPS:]}")
    share = dp_compare("(c) after 2 more steps", ptt.io.state_to_numpy(sc, names),
                       {k[3:]: v for k, v in ranks[0].items() if k.startswith("s5.")},
                       LSTM_LR, DP_MORE)
    return dict(losses=more, far_share=share)


def ulysses_ring_phase(ptt, smi, seed, n):
    """Phase n (inside phase 70's NCCL group of one): Ulysses and ring
    attention at the transformer's attention shape, sp of size 1."""
    from paddle_tpu_torch import parallel as par
    from paddle_tpu_torch.ops import flash_kernels as fk
    from paddle_tpu_torch.ops import flash_ops

    phase(n, "Ulysses and ring attention at the transformer's attention shape (B=8, T=1024, "
             "H=32, D=64, bf16), sp of size 1 over NCCL: their launch path")
    mesh = par.mesh_from_spec("sp1")
    rng = np.random.RandomState(seed + 71)
    q, k, v, do = (torch.as_tensor(rng.standard_normal((8, 1024, 32, 64)) * 0.5,
                                   dtype=torch.bfloat16, device="cuda") for _ in range(4))
    out = {}
    for kind in ("ulysses", "ring"):
        xs = [t.clone().requires_grad_(True) for t in (q, k, v)]
        for c in TFM_STEP_LAUNCHES:
            setattr(fk, f"{c}_launches", 0)
        flash_ops.plain_routes = 0
        fn = par.ulysses_attention if kind == "ulysses" else par.ring_attention
        o = fn(*xs, mesh, causal=True)
        o.backward(do)
        torch.cuda.synchronize()
        launches = {c: getattr(fk, f"{c}_launches") for c in TFM_STEP_LAUNCHES}
        ys = [t.clone().requires_grad_(True) for t in (q, k, v)]
        ref = flash_ops.flash_attention(*ys, causal=True) if kind == "ulysses" else \
            flash_ops.scaled_dot_product_attention(*(y.float() for y in ys), causal=True)
        ref.backward(do.to(ref.dtype))
        pairs = [(o, ref)] + [(x.grad, y.grad) for x, y in zip(xs, ys)]
        if kind == "ulysses":  # the all-to-all of one rank is a copy: the kernels' bits
            same = all(torch.equal(a, b) for a, b in pairs)
            check(same, "Ulysses at sp1: not flash_attention's bits")
            check(launches == {c: 1 for c in TFM_STEP_LAUNCHES} and flash_ops.plain_routes == 0,
                  f"Ulysses: B8 launches {launches}, plain routes {flash_ops.plain_routes}")
            out[kind] = dict(b8_launches=launches, same_bits_as_flash=True)
            msg = f"flash_attention's bits, B8 launches {launches}"
        else:
            errs = [float((a.detach().float() - b.detach().float()).abs().max()
                          / b.detach().float().abs().max()) for a, b in pairs]
            check(max(errs) <= ULYSSES_TOL, f"ring attention: errors {errs}")
            out[kind] = dict(errors=errs)
            msg = f"errors (o, dq, dk, dv) {[f'{e:.3e}' for e in errs]} of the f32 formula's " \
                  f"largest (tol {ULYSSES_TOL})"
        print(f"  {kind} attention, forward and backward over "
              f"{torch.distributed.get_backend()}: {msg}")
    del q, k, v, do
    torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    # phase 70's ranks: the script started again, one process a rank
    ap.add_argument("--dp_rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dp_init", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dp_dir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.dp_rank is not None:
        dp_rank_main(args.dp_rank, args.dp_init, args.dp_dir, args.seed)
        return

    phase(1, "device")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA GPU")
    sys.path.insert(0, ROOT)
    torch.manual_seed(args.seed)
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.ops import (attention_kernels, cuda_build, flash_kernels,
                                      fused_conv_kernels, lstm_kernels, quant_kernels,
                                      rnn_kernels)

    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(f"device: {kind}; torch {torch.__version__}; CUDA {torch.version.cuda}")
    print("nvidia-smi name, power.limit:")
    print(smi)
    print(f"tf32 as torch leaves it: matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} (the port's Executor turns "
          "cuDNN's off)")

    phase(2, "build")
    t0 = time.perf_counter()
    names = ("gru_fwd", "gru_bwd", "bahdanau_attn", "lstm_fwd", "lstm_bwd", "flash_attn",
             "fused_conv_bn", "decoder_seq", "quant_matmul")
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        paths = list(pool.map(cuda_build.build, names))  # one nvcc each, together
    print(f"built {', '.join(os.path.relpath(p, ROOT) for p in paths)} in "
          f"{time.perf_counter() - t0:.2f} s")
    for name in names:
        with open(os.path.join(cuda_build.BUILD_DIR, f"{name}.log")) as f:
            for line in f:
                if "registers" in line or "Compiling entry" in line:
                    print(f"  ptxas {name}:", line.strip())
    rnn_kernels._lib("gru_fwd")
    rnn_kernels._lib("gru_bwd")
    attention_kernels._lib()
    attention_kernels._seq_lib()
    lstm_kernels._lib("lstm_fwd")
    lstm_kernels._lib("lstm_bwd")
    flash_kernels._lib()
    fused_conv_kernels._lib()
    quant_kernels._lib()

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        wmt_dir = os.path.join(work, "nmt_beam_wmt")
        t0 = time.perf_counter()
        write_params(os.path.join(ROOT, "paddle_tpu_torch", "artifacts", "nmt_beam_wmt"),
                     wmt_dir, args.seed)
        scope = ptt.Scope()
        program, feeds, fetches = ptt.io.load_inference_model(wmt_dir, scope=scope)
        print(f"artifact: seeded params written and loaded in {time.perf_counter() - t0:.2f} s")
        attrs = program.global_block().ops[-1].attrs
        V = scope.get("s2s.trg_emb").shape[0]
        S, K, T, B = attrs["src_max_len"], attrs["beam_size"], attrs["max_len"], 128
        rng = np.random.RandomState(args.seed)

        phase(3, "kernel against plain")
        enc = next(o for o in program.global_block().ops if o.type == "dynamic_gru")
        H_gru = scope.get(enc.inputs["Weight"][0]).shape[0]
        print_plan(rnn_kernels, "gru_fwd", B, H_gru, "the request")
        feed = ragged_feed(ptt, rng, B, S, V, min_len=10)
        exe = ptt.Executor()
        print("cuBLAS bf16 reduced-precision reduction: "
              f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")
        max_err, main_row = 0.0, None
        for amp, dt in ((None, torch.float32), ("bfloat16", torch.bfloat16)):
            for x, mask, w, reverse in encoder_inputs(ptt, exe, program, scope, feed, amp):
                check(x.dtype == dt, f"encoder x dtype {x.dtype}, expected {dt}")
                got = rnn_kernels.gru_fwd(x, mask, w, reverse=reverse)
                want = rnn_kernels.gru_fwd_plain(x, mask, w, reverse=reverse)
                torch.cuda.synchronize()
                k_ms = cuda_ms(lambda: rnn_kernels.gru_fwd(x, mask, w, reverse=reverse), 20)
                p_ms = cuda_ms(lambda: rnn_kernels.gru_fwd_plain(x, mask, w, reverse=reverse), 5)
                b_ms, b_by, nbytes, flops = bound(x, mask, w, *got)
                T_, B_, H3 = x.shape
                earlier = f" ({EARLIER_MS['gru_fwd']} ms before the redesign)" \
                    if dt == torch.bfloat16 else ""
                print(f"  gru_fwd T={T_} B={B_} H={H3 // 3} {str(dt)[6:]} "
                      f"{'rev' if reverse else 'fwd'}: kernel {k_ms:.4f} ms{earlier}, plain "
                      f"{p_ms:.4f} ms, bound {b_ms:.5f} ms by {b_by} ({nbytes:.0f} B, "
                      f"{flops:.4g} FLOP)")
                err, differing = kernel_error(got, want, dt)
                same_bits(rnn_kernels.gru_fwd(x, mask, w, reverse=reverse), got, "gru_fwd")
                print(f"    max_abs_err={err:.3e} (tol {TOL[dt]:g}), h_seq differing "
                      f"{differing:.4%}" + (f" (max {BF16_MAX_DIFFERING:.0%})"
                                            if dt == torch.bfloat16 else ""))
                if dt == torch.bfloat16:
                    f32_seq = rnn_kernels.gru_fwd_plain(x.float(), mask, w.float(),
                                                        reverse=reverse)[0].to(dt)
                    off = float((f32_seq != got[0]).float().mean())
                    off_err = float((f32_seq.float() - got[0].float()).abs().max())
                    print(f"    rounded only at the output: {off_err:.3e} apart, "
                          f"h_seq differing {off:.4%}")
                    check(off > BF16_MAX_DIFFERING,
                          "the bf16 share bound does not catch a misplaced rounding")
                max_err = max(max_err, err)
                if dt == torch.bfloat16 and not reverse:  # the main path's dtype
                    main_row = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)
        gru_tc_plans(rnn_kernels, "gru_fwd")
        for (T_, B_, H_), dt, reverse in [(s, dt, rev) for s in EDGE_SHAPES + GRU_TC_EDGE
                                          for dt in TOL for rev in (False, True)]:
            if dt == torch.float32 and H_ > GRU_F32_MAX_H:
                continue
            mask = gru_edge_mask(rng, T_, B_, (T_, B_, H_) in GRU_TC_EDGE)
            x = torch.as_tensor(rng.standard_normal((T_, B_, 3 * H_)), dtype=dt).cuda()
            w = torch.as_tensor(rng.standard_normal((H_, 3 * H_)) / np.sqrt(H_), dtype=dt).cuda()
            got = rnn_kernels.gru_fwd(x, mask, w, reverse=reverse)
            want = rnn_kernels.gru_fwd_plain(x, mask, w, reverse=reverse)
            torch.cuda.synchronize()
            err, differing = kernel_error(got, want, dt)
            print(f"  gru_fwd T={T_} B={B_} H={H_} {str(dt)[6:]} {'rev' if reverse else 'fwd'}: "
                  f"max_abs_err={err:.3e} (tol {TOL[dt]:g}), h_seq differing {differing:.4%}")
            if dt == torch.bfloat16:
                same_bits(rnn_kernels.gru_fwd(x, mask, w, reverse=reverse), got, "gru_fwd")
            max_err = max(max_err, err)
        print("  gru_fwd: h_seq and h_T the same bits in two runs at the request's inputs and "
              "every edge shape (bf16)")

        phase(4, "slice at full width (bf16)")
        program.set_amp("bfloat16")
        requests = [ragged_feed(ptt, rng, B, S, V, min_len=10) for _ in range(3)]
        exe.run(program, {feeds[0]: requests[0]}, fetches, scope=scope)  # warm-up
        rnn_kernels.gru_fwd_launches = 0
        times, outs = [], []
        for req in requests:
            t0 = time.perf_counter()
            outs.append(exe.run(program, {feeds[0]: req}, fetches, scope=scope))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        launches = rnn_kernels.gru_fwd_launches
        for ids, sc, lens in outs:
            check(ids.shape == (B, K, T) and sc.shape == (B, K) and lens.shape == (B, K),
                  f"shapes {ids.shape} {sc.shape} {lens.shape}")
            check(((ids >= 0) & (ids < V)).all(), "ids out of [0, V)")
            check(((lens >= 1) & (lens <= T)).all(), "lengths out of [1, max_len]")
            check(np.isfinite(sc).all(), "non-finite scores")
            check((np.diff(sc, axis=1) <= 0).all(), "scores not sorted best first")
        check(launches == 2 * len(requests),
              f"gru_fwd launched {launches} times for {len(requests)} requests")
        med = statistics.median(times)
        print(f"  requests ms: {[round(t, 3) for t in times]}; gru_fwd launches {launches}")
        print(f"  median {med:.3f} ms/request, {B * T / med * 1e3:.1f} generated tokens/s "
              f"(B={B}, beam {K}, max_len {T}) on {smi}")
        breakdown(lambda: exe.run(program, {feeds[0]: requests[0]}, fetches, scope=scope), med)

        phase(5, "small-width slice: card against CPU (f32, then bf16)")
        small = os.path.join(work, "nmt_beam_small")
        write_params(os.path.join(ROOT, "paddle_tpu_torch", "artifacts", "nmt_beam_small"),
                     small, args.seed + 1)
        for amp in (None, "bfloat16"):
            res = {}
            for dev in ("cpu", "cuda"):
                sc_ = ptt.Scope()
                prog, fd, ft = ptt.io.load_inference_model(small, scope=sc_, device=dev)
                prog.set_amp(amp)
                beam = prog.global_block().ops[-1]
                a = beam.attrs
                vs = sc_.get("s2s.trg_emb").shape[0]
                feed = ragged_feed(ptt, np.random.RandomState(args.seed + 2), 16,
                                   a["src_max_len"], vs, min_len=1)
                names = [beam.inputs["EncState"][0], beam.inputs["H0"][0]] + list(ft)
                enc, h0, *fetched = ptt.Executor(device=dev).run(prog, {fd[0]: feed}, names,
                                                                 scope=sc_)
                res[dev] = [enc.data.float().cpu().numpy(), h0] + fetched
            (ce, ch, ci, cs, cl), (ge, gh, gi, gs, gl) = res["cpu"], res["cuda"]
            score_err = float(np.abs(cs - gs).max())
            if amp is None:
                print(f"  f32: ids equal: {np.array_equal(ci, gi)}; lengths equal: "
                      f"{np.array_equal(cl, gl)}; max score diff {score_err:.3e} "
                      f"(tol {SLICE_SCORE_TOL:g})")
                check(np.array_equal(ci, gi) and np.array_equal(cl, gl),
                      "card and CPU ids/lengths differ")
                check(score_err <= SLICE_SCORE_TOL, "card and CPU scores differ")
                continue
            for name, g, c in (("encoder state", ge, ce), ("decoder h0", gh, ch)):
                err, differing = float(np.abs(g - c).max()), float(np.mean(g != c))
                print(f"  bf16 {name}: max abs diff {err:.3e} (tol {TOL[torch.bfloat16]:g}), "
                      f"differing {differing:.4%} (max {BF16_SLICE_MAX_DIFFERING[name]:.0%})")
                check(err <= TOL[torch.bfloat16] and differing <= BF16_SLICE_MAX_DIFFERING[name],
                      f"card and CPU {name} differ under bf16")
            shared = np.all(ci == gi, axis=-1)  # [B, K] beams both found
            score_ulps = float((np.abs(cs - gs) / bf16_ulp(cs))[shared].max(initial=0.0))
            print(f"  bf16 beams: {shared.mean():.1%} found by both (min "
                  f"{BF16_MIN_SHARED_BEAMS:.0%}); their scores at most {score_ulps:g} bf16 "
                  f"ulps apart (max {BF16_SCORE_ULPS}); all scores at most {score_err:g} apart")
            check(shared.mean() >= BF16_MIN_SHARED_BEAMS, "card and CPU beams differ under bf16")
            check(score_ulps <= BF16_SCORE_ULPS, "card and CPU scores differ under bf16")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    infer_launches = launches

    phase(6, "training program at full width (bf16): startup and a warm-up step")
    wdir = os.path.join(ROOT, "paddle_tpu_torch", "artifacts", "nmt_train_wmt")
    main_p, startup, meta = ptt.io.load_train_program(wdir)
    check(main_p.amp_dtype == "bfloat16", f"amp {main_p.amp_dtype!r}")
    tscope = ptt.Scope()
    t0 = time.perf_counter()
    exe.run(startup, scope=tscope, seed=args.seed)
    torch.cuda.synchronize()
    n_values = sum(tscope.get(n).numel() for n in meta["param_names"])
    print(f"  startup: {len(startup.global_block().ops)} ops, {len(meta['param_names'])} "
          f"parameters with {n_values} values, in {time.perf_counter() - t0:.2f} s")
    wd = meta["widths"]
    TB, TS, TV = wd["batch"], wd["max_len"], wd["vocab"]
    tfeed = train_feed(ptt, rng, TB, TS, TV, min_len=10)
    trg_tokens = int(tfeed["label"].lengths.sum())
    loss_name = meta["loss_name"]
    gcalls, grestore = record_calls(rnn_kernels, {"gru_fwd": "all", "gru_bwd": "all"})
    acalls, arestore = record_calls(attention_kernels, {
        "attn_fwd": "first", "attn_bwd_step": "all", "attn_phase2": "first"})
    try:
        t0 = time.perf_counter()
        losses = [float(exe.run(main_p, tfeed, [loss_name], scope=tscope)[0])]
        torch.cuda.synchronize()
    finally:
        grestore()
        arestore()
    print(f"  warm-up step: loss {losses[0]:.6f}, {time.perf_counter() - t0:.3f} s; "
          f"{trg_tokens} target tokens, {int(tfeed['src'].lengths.sum())} source tokens")

    phase(7, "training kernels against plain (the warm-up step's inputs, then seeded inputs)")
    rows, max_errs = {}, {}
    check(len(gcalls["gru_fwd"]) == STEP_LAUNCHES["gru_fwd"]
          and len(gcalls["gru_bwd"]) == STEP_LAUNCHES["gru_bwd"],
          "the warm-up step did not run 2 gru_fwd and 2 gru_bwd")
    TH = gcalls["gru_fwd"][0][0][2].shape[0]
    print_plan(rnn_kernels, "gru_fwd", TB, TH, "the step")
    print_plan(rnn_kernels, "gru_bwd", TB, TH, "the step")
    # the forward at the step's B=256, on the warm-up step's own inputs (the
    # two encoder GRUs, the second reversed)
    for i, (a, k) in enumerate(gcalls["gru_fwd"]):
        rev = k.get("reverse", False)
        for dt in (torch.bfloat16, torch.float32):
            x, mask, w = a[0].to(dt), a[1], a[2].to(dt)
            got = rnn_kernels.gru_fwd(x, mask, w, reverse=rev)
            want = rnn_kernels.gru_fwd_plain(x, mask, w, reverse=rev)
            torch.cuda.synchronize()
            err, differing = kernel_error(got, want, dt)
            same_bits(rnn_kernels.gru_fwd(x, mask, w, reverse=rev), got, "gru_fwd")
            line = (f"  gru_fwd T={x.shape[0]} B={x.shape[1]} H={w.shape[0]} {str(dt)[6:]} "
                    f"{'rev' if rev else 'fwd'} (the step's): max_abs_err={err:.3e} (tol "
                    f"{TOL[dt]:g}), h_seq differing {differing:.4%}, the same bits in two runs")
            if dt == torch.bfloat16 and i == 0:
                k_ms = cuda_ms(lambda: rnn_kernels.gru_fwd(x, mask, w), 10)
                p_ms = cuda_ms(lambda: rnn_kernels.gru_fwd_plain(x, mask, w), 2)
                b_ms, b_by, _, _ = bound(x, mask, w, *got)
                line += (f"; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.5f} ms by "
                         f"{b_by}")
                gru_fwd_train_ms = k_ms
            print(line)
            max_errs["gru_fwd"] = max(max_errs.get("gru_fwd", 0.0), err)

    for i, (a, k) in enumerate(gcalls["gru_bwd"]):
        rev = k.get("reverse", False)
        for dt in (torch.bfloat16, torch.float32):
            ins = [t.to(dt) if t.is_floating_point() else t for t in a]
            got = rnn_kernels.gru_bwd(*ins, reverse=rev)
            want = rnn_kernels.gru_bwd_plain(*ins, reverse=rev)
            torch.cuda.synchronize()
            scales = term_scales("gru_bwd", ins, want)
            abs_errs, errs = zip(*(rel_err(g, w, sc) for g, w, sc in zip(got, want, scales)))
            zero = [amax(w) / sc for w, sc in zip(want, scales)]
            differing = float((got[0] != want[0]).float().mean())
            k_ms = cuda_ms(lambda: rnn_kernels.gru_bwd(*ins, reverse=rev), 10)
            p_ms = cuda_ms(lambda: rnn_kernels.gru_bwd_plain(*ins, reverse=rev), 2)
            b_ms, b_by, nbytes = gru_bwd_bound(ins)
            T_, B_, H_ = ins[2].shape
            earlier = f" ({EARLIER_MS['gru_bwd']} ms before the redesign)" \
                if dt == torch.bfloat16 else ""
            print(f"  gru_bwd T={T_} B={B_} H={H_} {str(dt)[6:]} {'rev' if rev else 'fwd'}: "
                  f"kernel {k_ms:.4f} ms{earlier}, plain {p_ms:.4f} ms, bound {b_ms:.5f} ms by "
                  f"{b_by} ({nbytes:.0f} B)")
            same_bits(rnn_kernels.gru_bwd(*ins, reverse=rev), got, "gru_bwd")
            print(f"    rel err dx {errs[0]:.3e} dW {errs[1]:.3e} (tol {TRAIN_TOL[dt]:g}; zeros "
                  f"would read {zero[0]:.3e}, {zero[1]:.3e}); dx differing {differing:.4%}")
            check(all(torch.isfinite(t.float()).all() for t in got), "non-finite gru_bwd output")
            check(max(errs) <= TRAIN_TOL[dt], "gru_bwd disagrees with its plain version")
            if dt == torch.bfloat16:
                check(differing <= BF16_MAX_DIFFERING_DX,
                      f"gru_bwd's dx differs in {differing:.4%} (max {BF16_MAX_DIFFERING_DX:.0%})")
                f32 = rnn_kernels.gru_bwd_plain(*(t.float() if t.is_floating_point() else t
                                                  for t in ins), reverse=rev)
                off = float((f32[0].to(dt) != got[0]).float().mean())
                print(f"    dh carried in f32 instead: dx differing {off:.4%}")
                check(off > BF16_MAX_DIFFERING_DX,
                      "the bf16 share bound does not catch a dh carry rounded elsewhere")
                if i == 0:
                    rows["gru_bwd"] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)
            max_errs["gru_bwd"] = max(max_errs.get("gru_bwd", 0.0), *abs_errs)
    print("  gru_bwd: dx and dW the same bits in two runs on the step's inputs")
    gru_tc_plans(rnn_kernels, "gru_bwd")
    for T_, B_, H_ in GRU_BWD_EDGE + GRU_TC_EDGE:
        for dt in TRAIN_TOL:
            if dt == torch.float32 and H_ > GRU_F32_MAX_H:
                continue
            for rev in (False, True):
                mask = gru_edge_mask(rng, T_, B_, (T_, B_, H_) in GRU_TC_EDGE)
                x = torch.as_tensor(rng.standard_normal((T_, B_, 3 * H_)), dtype=dt).cuda()
                w = torch.as_tensor(rng.standard_normal((H_, 3 * H_)) / np.sqrt(H_), dtype=dt).cuda()
                h_seq, _ = rnn_kernels.gru_fwd_plain(x, mask, w, rev)
                h_prev, ur, c, rh = rnn_kernels.gru_bwd_inputs(x, w, h_seq, rev)
                dh = (0.1 * torch.randn(T_, B_, H_, device="cuda")).to(dt)
                dhT = (0.1 * torch.randn(B_, H_, device="cuda")).to(dt)
                ins = (ur, c, h_prev, rh, dh, mask, w, dhT)
                want = rnn_kernels.gru_bwd_plain(*ins, reverse=rev)
                got = rnn_kernels.gru_bwd(*ins, reverse=rev)
                torch.cuda.synchronize()
                scales = term_scales("gru_bwd", ins, want)
                if T_ == 1:  # dW = [h_prevᵀ dx_ur | rhᵀ dx_c] with h_prev = rh = 0
                    check(amax(got[1]) == 0 and amax(want[1]) == 0, "gru_bwd: dW is not 0 at T=1")
                    got, want, scales = got[:1], want[:1], scales[:1]
                # where the sum of dW's terms' magnitudes over T·B rows is so
                # large that dW left at zero would pass, hold dW to its own
                # largest element instead (the stricter scale)
                scales = [amax(w_) if amax(w_) / sc <= TRAIN_TOL[dt] else sc
                          for w_, sc in zip(want, scales)]
                abs_errs, errs = zip(*(rel_err(g, w_, sc) for g, w_, sc in zip(got, want, scales)))
                zero = [amax(w_) / sc for w_, sc in zip(want, scales)]
                differing = float((got[0] != want[0]).float().mean())
                print(f"  gru_bwd T={T_} B={B_} H={H_} {str(dt)[6:]} {'rev' if rev else 'fwd'}: "
                      f"rel err {', '.join(f'{n} {e:.3e}' for n, e in zip(('dx', 'dW'), errs))} "
                      f"(tol {TRAIN_TOL[dt]:g}; zeros would read "
                      f"{', '.join(f'{z:.3e}' for z in zero)}){'; dW 0 on both sides' if T_ == 1 else ''}"
                      f"; dx differing {differing:.4%}")
                check(max(errs) <= TRAIN_TOL[dt], "gru_bwd disagrees with its plain version")
                check(min(zero) > TRAIN_TOL[dt], "gru_bwd: an output left at zero would pass")
                check(dt != torch.bfloat16 or differing <= BF16_MAX_DIFFERING_DX,
                      f"gru_bwd's dx differs in {differing:.4%} (max {BF16_MAX_DIFFERING_DX:.0%})")
                if dt == torch.bfloat16:
                    same_bits(rnn_kernels.gru_bwd(*ins, reverse=rev), got, "gru_bwd")
                max_errs["gru_bwd"] = max(max_errs["gru_bwd"], *abs_errs)
    print("  gru_bwd: dx and dW the same bits in two runs at every edge shape (bf16)")

    ak = attention_kernels
    plain = {"attn_fwd": ak.attn_fwd_plain, "attn_bwd_step": ak.attn_bwd_step_plain,
             "attn_phase2": ak.attn_phase2_plain}
    first = {"attn_fwd": attn_fwd_first, "attn_bwd_step": attn_bwd_first,
             "attn_phase2": attn_phase2_first}

    def attn_readings(name, ins, got, want):
        """Each output's error beyond one ulp over its term scale, and what
        an output left at zero would read (see TRAIN_TOL)."""
        scales = term_scales(name, ins, want)
        errs = [beyond_ulp(g, w, sc) for g, w, sc in zip(got, want, scales)]
        zero = [beyond_ulp(torch.zeros_like(w), w, sc) for w, sc in zip(want, scales)]
        return errs, zero

    def attn_check(name, ins, label, timed=False):
        """Kernel against plain on `ins`, and an output left at zero must
        fail the same bound (see TRAIN_TOL). Where `timed`, the kernel's
        time with the wrapper and on the device, the plain version's and
        the bound, and in bf16 the first design's beside (held too); the
        readings are returned."""
        got = getattr(ak, name)(*ins)
        want = plain[name](*ins)
        torch.cuda.synchronize()
        errs, zero = attn_readings(name, ins, got, want)
        tol = TRAIN_TOL[torch.float32]
        dt = ins[0].dtype
        line = (f"  {name} {label} {str(dt)[6:]}: err beyond one ulp "
                f"{', '.join(f'{e:.3e}' for e in errs)} (tol {tol:g}; zeros would read "
                f"{', '.join(f'{z:.3e}' for z in zero)})")
        if dt == torch.bfloat16:
            line += f", {float((got[0] != want[0]).float().mean()):.4%} of {name}'s first output differing"
        row = None
        if timed:
            k_ms = cuda_ms(lambda: getattr(ak, name)(*ins), 20)
            d_ms = graph_ms(lambda: getattr(ak, name)(*ins))
            p_ms = cuda_ms(lambda: plain[name](*ins), 3)
            b_ms, b_by, nbytes = attn_bound(name, ins)
            line += (f"; kernel {k_ms:.4f} ms with the wrapper, {d_ms:.4f} ms on the device (a "
                     f"CUDA graph's replay), plain {p_ms:.4f} ms, bound {b_ms:.5f} ms by {b_by} "
                     f"({nbytes:.0f} B)")
            row = dict(ms=k_ms, device_ms=d_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)
            if dt == torch.bfloat16:
                # the first design on the same inputs, held and timed beside
                f_got = first[name](ak, *ins)
                f_err, _ = attn_readings(name, ins, f_got, want)
                check(max(f_err) <= tol, f"{name}'s first design disagrees")
                f_ms = cuda_ms(lambda: first[name](ak, *ins), 20)
                f_dev = graph_ms(lambda: first[name](ak, *ins))
                row.update(earlier_ms=f_ms, earlier_device_ms=f_dev)
                line += (f"\n    the first design (before the redesign; {EARLIER_MS[name]} ms in "
                         f"an earlier run) on the same inputs: err beyond one ulp "
                         f"{', '.join(f'{e:.3e}' for e in f_err)}; {f_ms:.4f} ms launched from "
                         f"Python, {f_dev:.4f} ms on the device; the new design "
                         f"{f_dev / d_ms:.2f}x faster on the device")
        print(line)
        check(all(torch.isfinite(t.float()).all() for t in got), f"non-finite {name} output")
        check(max(errs) <= tol, f"{name} disagrees with its plain version")
        check(min(zero) > tol, f"{name} {label}: an output left at zero would pass its check")
        max_errs[name] = max(max_errs.get(name, 0.0),
                             *(rel_err(g, w)[0] for g, w in zip(got, want)))
        return got, row

    def host_floor(name, ins):
        """The wrapper's host floor: the same Python and launch on one row
        of one position, whose device work is negligible."""
        ep_, enc_, dp_, v_, mask_ = ins[:5]
        tiny = (ep_[:1, :1], enc_[:1, :1], dp_[:1], v_, mask_[:1, :1]) + (
            (ins[5][:1], ins[6][:1, :1]) if name == "attn_bwd_step" else ())
        return cuda_ms(lambda: getattr(ak, name)(*tiny), 50)

    def dead_rows_zero(got, dctx, mask, label):
        """ddp and dsc exactly 0 in the rows whose dctx is all zero or that
        have no valid position; returns their count."""
        dead = ~((dctx != 0).any(1) & (mask > 0).any(1))
        check(bool((got[0][dead] == 0).all() and (got[1][dead] == 0).all()),
              f"attn_bwd_step {label}: a dead row's ddp or dsc is not exactly 0")
        return int(dead.sum())

    def seeded_attn(B_, S_, A_, C_, T_, dt, mask):
        """Normal inputs at these widths, on which no output's sum cancels."""
        f = lambda *shape, sc=1.0: (sc * torch.randn(*shape, device="cuda")).to(dt)  # noqa: E731
        ep, enc, dp, v = f(B_, S_, A_), f(B_, S_, C_, sc=0.3), f(B_, A_), f(A_, sc=0.1)
        _, alpha = ak.attn_fwd_plain(ep, enc, dp, v, mask)
        dsc = 0.01 * torch.randn(T_, B_, S_, device="cuda") * mask
        return {"attn_fwd": (ep, enc, dp, v, mask),
                "attn_bwd_step": (ep, enc, dp, v, mask, f(B_, C_, sc=0.1), alpha),
                "attn_phase2": (ep, f(T_, B_, A_), dsc, v)}

    # B5 and B7 on the warm-up step's own inputs (B7 its one call; B5 its
    # first), timed, their first designs beside; B5's host floor
    for name in ("attn_fwd", "attn_phase2"):
        a, _ = acalls[name][0]
        B_, S_, A_ = a[0].shape
        for dt in (torch.bfloat16, torch.float32):
            ins = [t.to(dt) if t.dtype == torch.bfloat16 else t for t in a]
            got, row = attn_check(name, ins, f"B={B_} S={S_} A={A_} (main path)", timed=True)
            if dt == torch.bfloat16:
                rows[name] = row
                if name == "attn_fwd":
                    row["host_floor_ms"] = host_floor(name, ins)
                    print(f"    the wrapper's host floor (the same call on B=1, S=1): "
                          f"{row['host_floor_ms']:.4f} ms a call")
                else:
                    again = ak.attn_phase2(*ins)
                    check(all(torch.equal(x, y) for x, y in zip(got, again)),
                          "attn_phase2 gives other bits in a second run")
                    print("    attn_phase2 on the walk: dep and dv the same bits in two runs")
    # B6 over the step's 50 recorded calls, newest step first (t = 49 .. 0):
    # each held against plain, dead rows exactly 0; the 50 timed together
    # (a CUDA graph's replay on the device, and launched from Python), the
    # first design on the same 50 inputs beside; the bound over live rows
    bcalls = [c for c, _ in acalls["attn_bwd_step"]]
    check(len(bcalls) == STEP_LAUNCHES["attn_bwd_step"],
          f"the warm-up step ran {len(bcalls)} attn_bwd_step calls")
    (B_, S_, A_), C_ = bcalls[0][0].shape, bcalls[0][1].shape[2]
    paths0 = dict(ak.attn_bwd_step_paths)
    outs, worst, n_dead = [], [0.0, 0.0], []
    for ins in bcalls:
        got = ak.attn_bwd_step(*ins)
        want = plain["attn_bwd_step"](*ins)
        torch.cuda.synchronize()
        errs, zero = attn_readings("attn_bwd_step", ins, got, want)
        check(max(errs) <= TRAIN_TOL[torch.float32] and min(zero) > TRAIN_TOL[torch.float32],
              f"attn_bwd_step disagrees with plain on a step call ({errs}, zeros {zero})")
        worst = [max(w, e) for w, e in zip(worst, errs)]
        n_dead.append(dead_rows_zero(got, ins[5], ins[4], "(the step's call)"))
        max_errs["attn_bwd_step"] = max(max_errs.get("attn_bwd_step", 0.0),
                                        *(rel_err(g, w)[0] for g, w in zip(got, want)))
        outs.append(got)
    paths = {k: n - paths0[k] for k, n in ak.attn_bwd_step_paths.items()}
    check(paths[ak.attn_bwd_path(S_, A_, C_, torch.bfloat16)] == len(bcalls) ==
          paths[ak.ATTN_BULK], f"attn_bwd_step's step calls by path {paths}: not all on the "
          "cluster's bulk path")
    again = [ak.attn_bwd_step(*ins) for ins in bcalls]
    check(all(torch.equal(x, y) for o, a2 in zip(outs, again) for x, y in zip(o, a2)),
          "attn_bwd_step gives other bits in a second run")

    def step50():
        for ins in bcalls:
            ak.attn_bwd_step(*ins)

    def first50():
        for ins in bcalls:
            attn_bwd_first(ak, *ins)

    k50, d50 = cuda_ms(step50, 5), graph_ms(step50, 10)
    f50, fd50 = cuda_ms(first50, 5), graph_ms(first50, 10)
    p50 = cuda_ms(lambda: [plain["attn_bwd_step"](*ins) for ins in bcalls], 1)
    bounds = [attn_bound("attn_bwd_step", ins) for ins in bcalls]
    b50 = sum(b[0] for b in bounds)  # the calls' least times, added
    by50 = max(("bytes", "operations"), key=lambda k: sum(b[0] for b in bounds if b[1] == k))
    f_worst = [0.0, 0.0]
    for ins in bcalls:
        f_err, _ = attn_readings("attn_bwd_step", ins, attn_bwd_first(ak, *ins),
                                 plain["attn_bwd_step"](*ins))
        f_worst = [max(w, e) for w, e in zip(f_worst, f_err)]
    check(max(f_worst) <= TRAIN_TOL[torch.float32], "attn_bwd_step's first design disagrees")
    n = len(bcalls)
    print(f"  attn_bwd_step B={B_} S={S_} A={A_} C={C_} (the step's {n} calls, t = {n - 1} "
          f"first) bf16: err beyond one ulp ddp {worst[0]:.3e}, dsc {worst[1]:.3e} at most "
          f"(tol {TRAIN_TOL[torch.float32]:g}); dead rows a call {n_dead[0]} (t = {n - 1}) to "
          f"{n_dead[-1]} (t = 0), {sum(n_dead)} of {n * B_}, their ddp and dsc exactly 0; by "
          f"path {paths}, {ak.attn_bwd_cluster(S_)} ranks a row; the same bits in two runs")
    print(f"    the {n} calls: {k50:.4f} ms launched from Python, {d50:.4f} ms on the device (a "
          f"CUDA graph's replay of the {n}), plain {p50:.4f} ms, bound {b50:.5f} ms by {by50} "
          f"(live rows only); the first design on the same inputs {f50:.4f} ms from Python, "
          f"{fd50:.4f} ms on the device (err beyond one ulp {f_worst[0]:.3e}, {f_worst[1]:.3e}; "
          f"{EARLIER_MS['attn_bwd_step']} ms a call on the device in an earlier run): the new "
          f"design {fd50 / d50:.2f}x faster on the device")
    row = dict(ms=k50 / n, device_ms=d50 / n, plain_ms=p50 / n, bound_ms=b50 / n, bound_by=by50,
               earlier_ms=f50 / n, earlier_device_ms=fd50 / n, step_ms=k50, step_device_ms=d50,
               step_bound_ms=b50, step_earlier_device_ms=fd50)
    for i, t_ in ((n - 1, 0), (0, n - 1)):  # t = 0 (every row live) and t = 49 on their own
        ins = bcalls[i]
        t_dev = graph_ms(lambda: ak.attn_bwd_step(*ins))
        t_first = graph_ms(lambda: attn_bwd_first(ak, *ins))
        t_b = attn_bound("attn_bwd_step", ins)[0]
        row[f"t{t_}_device_ms"] = t_dev
        split = ak.attn_bwd_step_phase_us(*ins)
        print(f"    t = {t_}: {t_dev:.4f} ms on the device, the first design {t_first:.4f}, bound "
              f"{t_b:.5f} ms ({n_dead[i]} dead rows); its timed instance, µs a live CTA: "
              f"{', '.join(f'{k} {u:.2f}' for k, u in split['us'].items())}; the last live CTA "
              f"ends {split['live_end_us']:.2f} µs after the first CTA starts, a dead CTA lives "
              f"{split['dead_us']:.2f} µs ({split['live_ctas']} live, {split['dead_ctas']} dead "
              "CTAs)")
    row["host_floor_ms"] = host_floor("attn_bwd_step", bcalls[0])
    print(f"    the wrapper's host floor (the same call on B=1, S=1): {row['host_floor_ms']:.4f} "
          "ms a call")
    rows["attn_bwd_step"] = row
    for i in (0, n - 1):  # f32 (the first design's route) at t = 49 and t = 0
        ins = [t.float() if t.dtype == torch.bfloat16 else t for t in bcalls[i]]
        attn_check("attn_bwd_step", ins, f"B={B_} S={S_} A={A_} (the step's call {i})")

    a_fwd, a_p2 = acalls["attn_fwd"][0][0], acalls["attn_phase2"][0][0]
    (B_, S_, A_), C_, T_ = a_fwd[0].shape, a_fwd[1].shape[2], a_p2[1].shape[0]
    valid = [int(n) for n in a_fwd[4].sum(1).tolist()]
    whole = sum(ak.attn_row_chunks(n, True, A_, C_, ak.ATTN_ROW_STAGE)["whole"] for n in valid)
    print(f"  attn_fwd's path at the main shape: {ak.attn_fwd_path(S_, A_, C_, torch.bfloat16)}; "
          f"rows of {min(valid)}-{max(valid)} valid positions, {whole} of {B_} staged whole, the "
          "rest streamed")
    for dt in TRAIN_TOL:  # the main path's shapes and source mask, seeded values
        for name, ins in seeded_attn(B_, S_, A_, C_, T_, dt, a_fwd[4]).items():
            attn_check(name, ins, f"B={B_} S={S_} A={A_} C={C_} T={T_} (main shapes, seeded)")
    for B_, S_, A_, C_, T_ in ATTN_EDGE:
        lens = torch.as_tensor(rng.randint(1, S_ + 1, size=B_))
        mask = (torch.arange(S_)[None, :] < lens[:, None]).float().cuda()
        for dt in TRAIN_TOL:
            for name, ins in seeded_attn(B_, S_, A_, C_, T_, dt, mask).items():
                attn_check(name, ins, f"B={B_} S={S_} A={A_} C={C_} T={T_}")
    for what, B_, S_, A_, C_, T_ in ATTN_ROW_EDGE:
        mask = row_mask(rng, what, B_, S_)
        ns = [int(n) for n in mask.sum(1).tolist()]
        plans = [ak.attn_row_chunks(n or S_, n > 0, A_, C_, ak.ATTN_ROW_STAGE) for n in ns]
        staged = ["whole" if k["whole"] else "in {na} + {nc} chunks".format(**k) for k in plans]
        print(f"  attn_fwd {what}: valid positions a row {ns}; staged {staged}")
        ranks = ak.attn_bwd_cluster(S_)
        bplans = [ak.attn_bwd_chunks(j1 - j0, A_, C_, ak.ATTN_BWD_STAGE)
                  for n in ns for j0, j1 in ak.attn_bwd_ranges(n, ranks)]
        print(f"  attn_bwd_step {what}: {ranks} ranks a row, their ranges staged "
              f"{['whole' if k['whole'] else '{nc} + {na} chunks'.format(**k) for k in bplans]}")
        if what == "S=300":
            check(not any(k["whole"] for k in plans), "the S=300 edge does not take the ring")
            check(not any(k["whole"] for k in bplans), "the S=300 edge does not take B6's ring")
        for dt in TRAIN_TOL:
            for name, ins in seeded_attn(B_, S_, A_, C_, T_, dt, mask).items():
                got, _ = attn_check(name, ins, f"B={B_} S={S_} A={A_} C={C_} T={T_} ({what})")
                if name == "attn_fwd" and what == "fully masked":
                    check(bool(torch.all(got[1][1] == 1.0 / S_)), "a fully masked row's α is not 1/S")
                if name == "attn_bwd_step" and what == "fully masked":
                    check(dead_rows_zero(got, ins[5], mask, what) >= 1,
                          "the fully masked row was not held to zeros")
    for what, B_, S_, A_, C_, T_ in ATTN_BWD_EDGE:
        mask = bwd_edge_mask(rng, what, B_, S_)
        ns = [int(n) for n in mask.sum(1).tolist()]
        ranks = ak.attn_bwd_cluster(S_)
        print(f"  attn_bwd_step {what}: valid positions a row {ns}; ranges over {ranks} ranks "
              f"{[ak.attn_bwd_ranges(n, ranks) for n in ns]}")
        for dt in TRAIN_TOL:
            ins = list(seeded_attn(B_, S_, A_, C_, T_, dt, mask)["attn_bwd_step"])
            if what == "dead rows":
                ins[5] = ins[5].clone()
                ins[5][1::2] = 0
            got, _ = attn_check("attn_bwd_step", ins, f"B={B_} S={S_} A={A_} C={C_} ({what})")
            dead = dead_rows_zero(got, ins[5], mask, what)
            if what == "dead rows":
                check(dead == B_ // 2, f"{dead} dead rows, expected {B_ // 2}")
            if what == "single position":
                one = mask.sum(1) == 1
                check(bool((got[0][one] == 0).all() and (got[1][one] == 0).all()),
                      "a row of one valid position: ddp or dsc not exactly 0")
            if dt == torch.bfloat16:
                again = ak.attn_bwd_step(*ins)
                check(all(torch.equal(x, y) for x, y in zip(got, again)),
                      f"attn_bwd_step {what}: other bits in a second run")
    print("  attn_bwd_step: exact zeros in every dead row and row of one valid position; the "
          "same bits in two runs at every ATTN_BWD_EDGE shape (bf16)")

    phase(8, "training at full width (bf16): 3 timed steps")
    counters = {"gru_fwd": (rnn_kernels, "gru_fwd_launches"),
                "gru_bwd": (rnn_kernels, "gru_bwd_launches"),
                "attn_fwd": (attention_kernels, "attn_fwd_launches"),
                "attn_bwd_step": (attention_kernels, "attn_bwd_step_launches"),
                "attn_phase2": (attention_kernels, "attn_phase2_launches")}
    torch.cuda.reset_peak_memory_stats()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    # each route counter, as it stands before the steps
    routes0 = {k: dict(c) for k, c in (("attn_fwd", ak.attn_fwd_paths),
                                        ("attn_bwd_step", ak.attn_bwd_step_paths))}
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        losses.append(float(exe.run(main_p, tfeed, [loss_name], scope=tscope)[0]))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    train_launches = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
    train_routes = {k: {r: n - routes0[k][r] for r, n in c.items()} for k, c in (
        ("attn_fwd", ak.attn_fwd_paths), ("attn_bwd_step", ak.attn_bwd_step_paths))}
    print(f"  losses (warm-up, then timed): {losses}")
    check(all(np.isfinite(losses)), "non-finite loss")
    check(losses[-1] < losses[0], "the loss did not fall over 4 steps on one batch")
    print(f"  launches in 3 steps: {train_launches}; per step expected {STEP_LAUNCHES}; by "
          f"route {train_routes}")
    for k, n in STEP_LAUNCHES.items():
        check(train_launches[k] == 3 * n, f"{k} launched {train_launches[k]} times in 3 steps")
    for k, route in (("attn_fwd", ak.ATTN_BULK), ("attn_bwd_step", ak.ATTN_BULK)):
        check(train_routes[k][route] == 3 * STEP_LAUNCHES[k],
              f"{k}'s launches by route {train_routes[k]}: not all on the {route} route")
    tmed = statistics.median(times)
    print(f"  steps ms: {[round(t, 3) for t in times]}; median {tmed:.3f} ms/step, "
          f"{trg_tokens / tmed * 1e3:.1f} target tokens/s (B={TB}, lengths 10-{TS}); "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {smi}")
    breakdown(lambda: exe.run(main_p, tfeed, [loss_name], scope=tscope), tmed, "step")

    phase(9, "small training program: card against CPU (f32, then bf16)")
    sdir = os.path.join(ROOT, "paddle_tpu_torch", "artifacts", "nmt_train_small")
    smain, sstart, smeta = ptt.io.load_train_program(sdir)
    state = seeded_state(ptt, smain, sstart, args.seed + 3)
    sw = smeta["widths"]
    srng = np.random.RandomState(args.seed + 4)
    sfeeds = [train_feed(ptt, srng, sw["batch"], sw["max_len"], sw["vocab"], min_len=2)
              for _ in range(2)]
    nmt_card_vs_cpu(ptt, smain, smeta["loss_name"], smeta["param_names"], state, sfeeds)

    lrows, lerrs, lstm_launches = lstm_phases(ptt, exe, rng, smi, args.seed, 10)
    rows.update(lrows)
    max_errs.update(lerrs)
    trows, terrs, tfm_launches = transformer_phases(ptt, exe, rng, smi, args.seed, 14)
    rows.update(trows)
    max_errs.update(terrs)
    resnet_summary = {}
    rrows, rerrs, resnet_launches = resnet_phases(ptt, exe, rng, smi, args.seed, 18,
                                                  resnet_summary)
    rows.update(rrows)
    max_errs.update(rerrs)
    srows, serrs, seq_launches = nmt_seq_phases(ptt, exe, rng, smi, args.seed, 22)
    rows.update(srows)
    max_errs.update(serrs)
    tf32_phase(ptt, smi, 26)
    serve_work = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    atexit.register(shutil.rmtree, serve_work, True)
    q_keep = os.path.join(serve_work, "tfm_int8")
    qrows, qerrs, q_launches = quant_phases(ptt, exe, smi, args.seed, 27, q_keep)
    rows.update(qrows)
    max_errs.update(qerrs)
    attention_routing_phase(ptt, args.seed + 31, 31)
    work = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
    try:
        paths = {"train_loop": train_loop_phase(ptt, smi, args.seed, 32, work)}
        paths["resnet50_trainer"], rmain, rscope = resnet_trainer_phase(
            ptt, smi, args.seed, 33, work, resnet_summary["step_ms"])
        paths["resnet50_infer"] = resnet_infer_phase(ptt, smi, args.seed, 34, work, rmain,
                                                     rscope)
        del rscope
    finally:
        shutil.rmtree(work, ignore_errors=True)
    paths.update(window_phases(ptt, smi, args.seed, 35))
    sent_paths, sent_errs = sentiment_phases(ptt, smi, args.seed, 41)
    paths.update(sent_paths)
    for k, e in sent_errs.items():
        max_errs[k] = max(max_errs[k], e)
    paths["book_text"] = book_text_phase(ptt, smi, args.seed, 45, serve_work)
    paths["srl"], srl_errs = srl_phases(ptt, smi, args.seed, 46)
    for k, e in srl_errs.items():
        max_errs[k] = max(max_errs[k], e)
    paths["images"] = image_phase(ptt, smi, args.seed, 48)
    paths["vgg_window"] = vgg_window_phase(ptt, smi, args.seed, 48)
    paths["book_image_srl"] = book_image_srl_phase(ptt, smi, args.seed, 49, serve_work)
    gc.collect()
    torch.cuda.empty_cache()
    paths["transformer_int8_serve"] = int8_serve_phase(ptt, smi, args.seed, 50, q_keep)
    shutil.rmtree(q_keep)
    torch.cuda.empty_cache()
    paths["serving_gen"] = serving_gen_phase(ptt, smi, args.seed, 51, serve_work)
    v3 = serving_gen_v3_setup(ptt, args.seed, serve_work)
    paths["serving_gen_v3"] = serving_gen_v3_phase(ptt, smi, 52, v3)
    paths["serving_gen_tiny"] = tiny_gen_phase(ptt, args.seed, 53, serve_work)
    gc.collect()
    torch.cuda.empty_cache()
    paths["serving_disagg"] = disagg_phase(ptt, smi, 54, v3)
    paths["serving_fleet"] = fleet_phase(ptt, smi, args.seed, 55, serve_work)
    gc.collect()
    torch.cuda.empty_cache()
    paths["transformer_remat"], remat_launches = remat_phases(ptt, smi, args.seed, 56)
    paths["general_ops"] = op_sweep_phase(ptt, smi, args.seed, 58)
    paths["networks"] = networks_phase(ptt, smi, args.seed, 59)
    paths["rg_lstm"] = rg_lstm_phase(ptt, smi, args.seed, 60)
    paths["control_flow"] = control_flow_phase(ptt, smi, args.seed, 61)
    paths["optimizer_surfaces"] = optimizer_surfaces_phase(ptt, smi, args.seed, 62)
    paths["sequence_ops"] = sequence_ops_phase(ptt, smi, args.seed, 63)
    paths["ctc_speech"] = ctc_phase(ptt, smi, args.seed, 64)
    paths["ssd300"] = ssd_phase(ptt, smi, args.seed, 65)
    paths["ctr_sparse"] = ctr_phase(ptt, smi, args.seed, 66)
    paths["cost_misc_ops"] = misc_ops_phase(ptt, smi, args.seed, 67)
    gc.collect()
    torch.cuda.empty_cache()
    paths["pipeline"], tmain, tstart, tloss = pipeline_phase(ptt, smi, args.seed, 68)
    paths["pipeline"]["window"] = pipeline_window_phase(ptt, smi, args.seed, 69, tmain,
                                                        tstart, tloss)
    del tmain, tstart, tloss
    gc.collect()
    torch.cuda.empty_cache()
    paths["data_parallel"], paths["sequence_parallel"] = data_parallel_phase(
        ptt, smi, args.seed, 70)

    phase(72, "the paths line, the kernels line, then the device line")
    rows["attn_bwd_step"].update(launches_by_route=train_routes["attn_bwd_step"],
                                 kernel="attn_bwd_row_kernel on csrc/attn_row.cuh's attend_bwd")
    rows["attn_phase2"].update(kernel="attn_dep_kernel (t oldest first) + attn_dv_kernel")
    sources = {"gru_fwd": ("gru_fwd.cu", "paddle_tpu/ops/pallas_kernels.py:493"),
               "gru_bwd": ("gru_bwd.cu", "paddle_tpu/ops/pallas_kernels.py:608"),
               "attn_fwd": ("bahdanau_attn.cu", "paddle_tpu/ops/bahdanau_kernels.py:257"),
               "attn_bwd_step": ("bahdanau_attn.cu", "paddle_tpu/ops/bahdanau_kernels.py:285"),
               "attn_phase2": ("bahdanau_attn.cu", "paddle_tpu/ops/bahdanau_kernels.py:315"),
               "lstm_fwd": ("lstm_fwd.cu", "paddle_tpu/ops/pallas_kernels.py:198"),
               "lstm_bwd": ("lstm_bwd.cu", "paddle_tpu/ops/pallas_kernels.py:332"),
               "flash_fwd": ("flash_attn.cu", "paddle_tpu/ops/flash_ops.py:160"),
               "flash_bwd_dkv": ("flash_attn.cu", "paddle_tpu/ops/flash_ops.py:160"),
               "flash_bwd_dq": ("flash_attn.cu", "paddle_tpu/ops/flash_ops.py:160"),
               "fused_conv_bn": ("fused_conv_bn.cu", "paddle_tpu/ops/fused_conv_ops.py:140"),
               "decoder_seq_fwd": ("decoder_seq.cu", "paddle_tpu/ops/bahdanau_kernels.py:399"),
               "decoder_seq_bwd": ("decoder_seq.cu", "paddle_tpu/ops/bahdanau_kernels.py:568"),
               # B10's post-walk pass runs B7's kernel, t newest first
               "decoder_seq_dep": ("bahdanau_attn.cu", "paddle_tpu/ops/bahdanau_kernels.py:568"),
               "quant_matmul": ("quant_matmul.cu", "paddle_tpu/ops/quant_kernels.py:61"),
               # the kept mma.sync route, for shapes no tensor map
               # describes: no main path's call takes it (counted)
               "quant_matmul_mma": ("quant_matmul.cu", "paddle_tpu/ops/quant_kernels.py:61")}
    by_path = {k: {"nmt_train": n} for k, n in train_launches.items()}
    by_path["gru_fwd"]["nmt_beam_infer"] = infer_launches
    by_path.update({k: {"lstm_train": n} for k, n in lstm_launches.items()})
    by_path.update({k: {"transformer_train": n} for k, n in tfm_launches.items()})
    by_path.update({k: {"resnet50_train": n} for k, n in resnet_launches.items()})
    by_path["fused_conv_bn"]["resnet50_trainer_per_step"] = \
        paths["resnet50_trainer"]["b11_launches_per_step"]
    for k, c in seq_launches.items():
        by_path.setdefault(k, {})["nmt_train_seq"] = c
    # understand_sentiment at full width (phase 43) and the book's (phase 45)
    for k in ("lstm_fwd", "lstm_bwd"):
        by_path[k]["sentiment_train"] = paths["sentiment"]["launches_per_step"][k]
        by_path[k]["book_sentiment_train_f32"] = \
            paths["book_text"]["understand_sentiment"]["launches_per_step"][k]
    # label_semantic_roles at full width (phase 47) and the book's (phase 49)
    for k in ("gru_fwd", "gru_bwd"):
        by_path[k]["srl_train"] = paths["srl"]["launches_per_step"][k]
        by_path[k]["book_srl_train_f32"] = \
            paths["book_image_srl"]["label_semantic_roles"]["launches_per_step"][k]
    # through the windows (phases 35-37, 39-40 and 44), by the wrappers' counters
    for path, kernels in WINDOW_KERNELS.items():
        launches = paths[f"{path}_window"]["window_ragged"]["launches_per_step"]
        for counter in kernels:
            by_path[counter[:-len("_launches")]][f"{path}_train_window"] = launches[counter]
    by_path.update(q_launches)
    # the HTTP-served int8 LM (phase 50): launches a request
    by_path["quant_matmul"]["transformer_int8_serve"] = \
        paths["transformer_int8_serve"]["quant_matmul_launches_per_request"]
    by_path["flash_fwd"]["transformer_int8_serve"] = \
        paths["transformer_int8_serve"]["flash_fwd_launches_per_request"]
    # the replica fleet (phase 55): a replica's own counters, a request
    by_path["quant_matmul"]["serving_fleet_replica"] = \
        paths["serving_fleet"]["b12_launches_a_request"]
    # the transformer step under each remat policy (phase 56) and its full
    # window (phase 57)
    for k, by_policy in remat_launches.items():
        for policy, c in by_policy.items():
            if policy != "none":
                by_path[k][f"transformer_train_remat_{policy}"] = c
        by_path[k]["transformer_train_remat_full_window"] = \
            paths["transformer_remat"]["window_full"]["launches_per_step"][k]
    # ResNet-50 at 64x64 on the B11 route under each policy (phase 57)
    for policy, c in paths["transformer_remat"]["batch_norm"]["resnet50_b11"][
            "b11_launches_per_step"].items():
        if policy not in ("none", "none_again"):
            by_path["fused_conv_bn"][f"resnet50_64px_train_remat_{policy}"] = c
    # networks.py's bidirectional classifiers in f32 (phase 59)
    for net, kernels in NET_LAUNCHES.items():
        for k in kernels:
            by_path[k][f"networks_{net}_f32"] = paths["networks"][net]["launches_per_step"][k]
    # the fused LSTM path timed beside rg_lstm (phase 60)
    for k, c in paths["rg_lstm"]["fused_launches_per_step"].items():
        by_path[k]["lstm_train_beside_rg_lstm"] = c
    # the CTC acoustic model's bidirectional GRU in f32 (phase 64)
    for k, c in paths["ctc_speech"]["launches_per_step"].items():
        by_path[k]["ctc_train_f32"] = c
    # the pipeline grid (phase 68) and its window (69): B8 a step by cell
    for c in paths["pipeline"]["cells"]:
        for k, v in c["launches_per_step"].items():
            by_path[k][f"transformer_pipeline_{c['schedule']}_K{c['K']}_M{c['M']}"] = v
    by_path["flash_fwd"]["transformer_pipeline_window_K2_M4"] = \
        paths["pipeline"]["window"]["flash_fwd_launches_per_step"]
    # bench.py's lstm row on each of 2 data-parallel ranks (phase 70) and
    # Ulysses attention at sp1 (phase 71)
    for k, v in zip(("lstm_fwd", "lstm_bwd"),
                    paths["data_parallel"]["a"]["launches_per_rank_step"]):
        by_path[k]["lstm_train_dp2_rank"] = v
    for k, v in paths["sequence_parallel"]["ulysses"]["b8_launches"].items():
        by_path[k]["ulysses_attention_sp1"] = v
    # B3's row: the request's launch (B=128), and the training step's (B=256)
    rows["gru_fwd"] = dict(main_row, train_ms=gru_fwd_train_ms,
                           srl_step=paths["srl"]["kernels"]["gru_fwd"])
    rows["gru_bwd"]["srl_step"] = paths["srl"]["kernels"]["gru_bwd"]
    max_errs["gru_fwd"] = max(max_err, max_errs["gru_fwd"])
    kernels = [{
        "name": name, "route": "cuda", "source": f"paddle_tpu_torch/csrc/{src}",
        "replaces": rep,
        "launches": {**seq_launches, **train_launches, **lstm_launches, **tfm_launches,
                     **resnet_launches,
                     **{k: sum(v.values()) for k, v in q_launches.items()}}[name],
        "launches_by_path": by_path[name], "max_abs_err": max_errs[name],
        "library_ms": None, **rows[name], "checked_against_plain": True,
    } for name, (src, rep) in sources.items()]
    print(json.dumps({"paths": paths}))
    print(json.dumps({"kernels": kernels}))
    end_phase()
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))

if __name__ == "__main__":
    main()
