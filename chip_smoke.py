#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line of its numbers; any failure exits
non-zero (nothing is caught and passed over):

1. device    — the card's name, the device count, and nvidia-smi's name
               and power limit. No CUDA device: fail.
2. build     — build both kernel sources of ``paddle_tpu_torch/csrc/``
               (ragged paged attention; flash attention fwd, dQ, dK/dV)
               with nvcc for sm_90a and the DataLoader's shared-memory
               queue (``shm_queue.cpp``) with g++, one compiler per
               source, all at once (the queue must load);
               seconds taken, ptxas's registers / spills / shared memory
               per kernel instance, each kernel's dynamic shared memory
               per CTA at head_dim 128 in bf16 and f32, and the wgmma
               (SASS HGMMA) instructions per kernel instance of both
               libraries: every bf16 tensor-core instance (``_tc``: the
               flash forward, dQ and dK/dV, the ragged kernel) must have
               them, the FMA kernels and the split combine none.
3. kernel    — the ragged kernel against its plain PyTorch version on
               the card at Llama-3-8B head shapes (H=32, KH=8, D=128,
               block 16, bf16) on one mixed batch: decode rows, a
               prefill chunk starting mid-context, padding slots, -1
               table entries, padding rows past cu[num_seqs]; on a
               decode-only batch (8 slots x 1 row, contexts 512-4096),
               which splits each slot's cache range and merges the
               splits; and on a speculative verify batch (8 slots x 5
               rows mid-context, contexts 300-1100, padded to the
               engine's 64-token bucket and split as phase 9 gives it);
               and at the steps of phase 13's cached ``generate`` (its
               2-slot engine: the 2 x 128-row prefill, a 2-row decode at
               context 143 in the 8-row bucket), at that engine's split.
               Times (CUDA events, L2 flushed before each launch) and
               the bounds of all.
4. serve     — Llama-3-8B at full width and depth (32 layers, bf16,
               random weights from a seeded generator on the card)
               through the port's LLMEngine: 8 requests, prompts of
               128-1024 tokens, 32 new tokens each (7 greedy, 1 sampled).
               Each step replays the CUDA graph of its token bucket
               (captured at the bucket's first use, here in the warm-up):
               captures, capture seconds, replays per bucket. The ragged
               kernel's launches that the replays ran must be 32 x the
               model steps, all of them on the tensor-core route, and its
               wrapper must have counted only warm-ups and captures; the
               buckets stepped must lie in the engine's lattice. Then, at
               each bucket stepped, one recorded step's inputs through a
               replay and through the eager ``_device_step``: packed rows
               and cache bytes bit-identical.
5. parity    — LlamaConfig.tiny in f32 (TF32 off) served on the card
               (kernel, captured graphs) and on the CPU (plain version)
               from the same weights: the greedy tokens must be
               identical.
6. flash     — the flash attention kernels (forward, dQ, dK/dV) against
               their plain versions on the card: at the training shapes
               (B 4, S 2048, H 16, D 128, bf16, causal: all three on the
               tensor cores), at the widest draft forward of phase 9
               (batch and width bucket from phase 4's prompts:
               B 8, S 1024, H 32, D 64, bf16, causal) and at the widest
               width bucket the engine allows (S 2048), at phase 13's
               naive ``generate`` widths (B 2, H 32, D 128, S 129 and
               143: ragged tail tiles), in f32 at a
               smaller size (the f32 FMA kernels), and with Sq != Sk and
               ragged tail tiles; each held by ``testing/flash_check.py``
               (element-wise at its TOL, plus in bf16 the one-ulp effect
               of the P and dS entries near a rounding boundary; its
               counts of such entries are reported per case). At the
               training shapes: times (CUDA
               events, L2 flushed before each launch), bounds, TFLOP/s
               and the share of the bound reached, the plain versions'
               times and F.scaled_dot_product_attention's forward and
               backward; at the draft shapes the same for the forward.
7. train     — bench.py's bench_gpt_1b configuration (0.95B Llama, 16
               layers, hidden 2048, bf16, batch 4 x 2048, AdamW) through
               the port's TrainStep: one warm-up and five timed steps on
               the same batch; losses finite and falling; each flash
               kernel launched 16 x the timed steps, on the tensor cores.
8. train_parity — LlamaConfig.tiny in f32 (TF32 off): three AdamW + clip
               TrainStep steps on the card (kernels) and on the CPU
               (plain versions) from the same weights agree.
9. spec      — speculative decoding: phase 4's Llama-3-8B and workload
               with a Llama-3.2-1B-width draft proposing 4 tokens per
               decode row (``tools/llama3_8b_spec_serve.py``). Every
               request finishes with 32 tokens and the pool comes back
               whole; the target's verify steps and the draft's k
               forwards replay CUDA graphs (per token bucket; per batch
               and width bucket); the ragged kernel's replayed launches
               are 32 x the model steps, the flash forward's 16 x 4 x the
               draft proposals, all on the tensor cores, and no plain
               version runs. Tok/s, TTFT
               and TPOT, acceptance, draft ms per step (synchronized
               wall time around each proposal), the draft forwards'
               (batch, width) buckets (the widest must be phase 6's
               draft case), peak memory, and how many greedy tokens
               equal phase 4's (bf16: reported). Where a greedy stream
               first leaves phase 4's, the target's two logit rows for
               that position (phase 4's decode row, phase 9's verify
               row, same prefix) are compared: each one's margin
               between the two tokens chosen and their largest
               difference, also over the equal prefix before it.
10. spec_parity — LlamaConfig.tiny in f32 (TF32 off), draft = target,
               k = 3, served on the card (kernels) and on the CPU (plain
               versions): greedy and sampled tokens and final keys
               identical, greedy equal to a non-speculative engine on
               the card, greedy acceptance above 0.9.

11. swap      — one Llama-3-8B (as phase 4's, built once for phases
               11-13 and freed after them) behind phase 4's engine
               settings on 128 KV blocks, about half what the workload
               needs: the serve workload with ``swap_mode="host"``, then
               with ``"recompute"``. Host: swap-outs > 0, swap-ins equal
               them, every block restored from the pinned host pool
               holds the spilled bytes bit for bit (``SwapCheck``, a
               wrapper around the engine's swapper), every device block
               and host slot free at the end, K1 launched. Both:
               preemptions, TTFT and TPOT p50, tok/s; host: spill bytes
               and the host ms of each spill, fence and restore. The
               greedy streams equal under both modes are reported, not
               asserted (bf16).
12. drain     — the serve workload on phase 11's host-swap engine with a
               ``PreemptionMonitor`` installed and a real SIGTERM after
               the first decode step: every request ends once, as
               ``length`` or ``aborted:drain``; those waiting at the
               drain end with the tokens they had (some with none); the
               engine drained, every block free, a late request
               rejected. Then the workload on a fresh engine with
               ``step_timeout_s`` 2.0 across its fresh captures (no
               alarm), and a warm step sleeping past the deadline:
               ``StepHungError``, every request ``aborted:error``.
13. bucketed  — the serve workload through ``ragged=False``: one graph
               per ``(kind, B, S)`` key, ``_seen_shapes`` equal to the
               keys stepped, replay and eager step bit-identical at one
               prefill and one decode key, no K1 launch; TTFT, TPOT,
               tok/s, padding, captures, capture s, peak memory. Then
               ``generate`` on a (2, 128) prompt, 16 new tokens, cached
               (K1) and naive (K2), their agreement reported (bf16)
               with the logit row behind each token kept: at each
               stream's first divergence, each side's margin between
               the two tokens and the rows' largest difference.
14. resilience_parity — ``tools/tiny_resilience_parity.py`` (f32, TF32
               off): swap vs recompute, drain, the bucketed engine and
               ``generate`` cached vs naive serve the CPU's tokens.
15. eager_train — phase 7's configuration through the user's eager loop
               (``tools/eager_train.py``: ``decorate(O2)``, AdamW with
               master weights and the global-norm clip over
               ``LinearWarmup(CosineAnnealingDecay(3e-4, 8))``,
               ``GradScaler(2**15, incr_every_n_steps=2)``; ``scale(loss)
               .backward(); step; update; clear_grad; sched.step()``):
               one warm-up and 6 timed steps, p50, tokens/s and MFU
               beside phase 7's p50; the lrs equal the scheduler's host
               values; the loss scale after each step equals a host
               GradScaler's; K2-K4 launched 16 x 6 times each, on the
               tensor cores; peak memory. Then an inf in one gradient
               before ``scaler.step``: every parameter and slot
               bit-identical, the scale halved, the skip counted. Then the
               same configuration through ``TrainStep(scaler=...)``: its
               losses beside the eager ones, K2-K4 at 16 x 6 each, on
               the tensor cores.
16. resume    — phase 15's widths at 2 layers (a 3.3 GB checkpoint): 6
               steps without a break, twice (bit-identical, or the phase
               names the first entry that differs); then 3 steps,
               ``CheckpointManager.save(block=True)`` of the model, the
               optimizer (slots, step, scheduler) and the scaler, a fresh
               model and optimizer restored, 3 more: losses, final
               parameters and slots, and the scaler's and scheduler's
               state bit-identical to the unbroken run, on the card.
               Bytes written, save and restore seconds.
17. eager_parity — ``tools/tiny_train_parity.run_eager`` (f32, TF32 off):
               the eager loop with Momentum, a scheduler and a scaler on
               the card and on the CPU, at phase 8's tolerances; equal
               lrs and scaler states.
18. fed_train — phase 7's configuration fed by the port's input
               pipeline (``tools/fed_train.py``): ``DataLoader(num_workers
               =2, use_shared_memory=True, use_device_prefetch=True,
               device_prefetch_depth=2)`` over seeded token ids, each
               batch a stack of 4 microbatches, into
               ``TrainStep.run_steps(4, ..., stacked=True)``: one warm
               dispatch (the eager warm-up step, then the capture of the
               step's CUDA graph), then 3 measured ones. The workers'
               queue must be the native ``ShmQueue``, one host-to-device
               copy per batch (one dtype); K2-K4 captured (16 each, on
               the tensor cores: their wrappers counted warm-up and
               capture only) and replayed 15 x. A second model from the
               same seed takes the same 16 microbatches through
               ``__call__``: losses, every parameter and every slot
               bit-identical. Per-step p50 of both, tokens/s and MFU
               (``profiler.estimate_mfu`` with ``device_peak_flops``),
               capture seconds, the host's wait for each batch, peak
               memory.
19. phases    — ``profiler.device_phases`` (torch.profiler's device
               events: kernels, memcpy, memset) of one ``__call__`` step
               and of one ``run_steps(4)`` dispatch of phase 18's models:
               compute, copy and collective ms, op counts, fractions.
20. tensor_api — the eager Tensor API (``tools/tensor_api_train.py``):
               phase 7's model written as a function of ``to_tensor``
               parameters and registry ops, its weights carried from a
               port ``LlamaForCausalLM`` of the same seed. In f32 (TF32
               off) at full width and 2 layers, batch 4 x 2048: one
               forward and ``loss.backward()`` against the module path
               (loss within rtol 1e-5, every gradient within relative L2
               1e-4; the f32 FMA kernels). In bf16 at full depth: step 0
               against the module path (loss within 1e-3 nats, every
               gradient's cosine similarity at least 0.9999), then 4 AdamW
               steps over the Tensor parameters (finite losses, the last
               below the first) and 4 through the module path: both step
               p50s and their ratio. K2-K4 launched 16 x 4 times each on
               the Tensor API's steps, all on the tensor cores, and no
               plain version called on the bf16 path. ``paddle.grad(
               create_graph=True)`` twice through tanh(matmul(x, w)) at
               [256, 512] f32 against the CPU (rtol 1e-5);
               ``flash_attn_unpadded`` over 8 packed sequences of 37-2048
               tokens, 32 query and 8 KV heads of 128, bf16, causal,
               against the same call on the CPU in f32 at
               ``flash_check.TOL[bfloat16]``; the registry's host cost of
               a small ``add`` beside ``torch.add``'s (µs).
21. layer_api — the layer API (``tools/layer_api_train.py``): phase 7's
               model written as a PaddlePaddle user writes it
               (``nn.Layer``, ``nn.Embedding``, ``nn.RMSNorm``,
               ``nn.Linear`` with [in, out] weights, ``nn.functional.
               flash_attention``, ``nn.Silu``, ``nn.Dropout``,
               ``nn.CrossEntropyLoss``), its weights carried from a port
               ``LlamaForCausalLM`` of the same seed. f32 at 2 layers:
               step 0 against the module path (loss rtol 1e-5, gradients'
               relative L2 1e-4; bit-identity reported). bf16 at full
               depth, dropout 0: step 0 (1e-3 nats, cosine 0.9999), then
               4 AdamW steps (``paddle.optimizer.AdamW(parameters=
               model.parameters())``) beside the module path's: losses
               finite and falling, both p50s and their ratio; K2-K4 16 x
               4 times each on the tensor cores, no plain version.
               ``paddle.save`` of the bf16 ``state_dict``, ``paddle.load``
               into a fresh model: the next step's loss bit-identical;
               bytes, save and load seconds. One dropout mask of 4 x 2048
               x 2048 from one ``get_rng_state()`` on the card and on the
               CPU: equal bit for bit; ms per mask (CUDA events) and the
               kernels one draw launches. Two steps with ``nn.Dropout(0.1)``
               on: finite losses, one key per dropout call. One
               ``nn.Linear(2048, 5632)`` after ``paddle.seed(0)`` on the
               card and on the CPU: bit-identical. Peak memory, seconds.
22. layer_trainstep — phase 21's bf16 layer-API Llama (full depth)
               through ``paddle.jit.TrainStep`` (``tools/layer_api_train.
               replay_against_calls``): two models from one seed, each
               behind a TrainStep built from the same generator state.
               Dropout 0: 8 ``__call__`` steps against two dispatches of
               ``run_steps(4)`` (the first: its first step eager as the
               capture's warm-up, then the capture and 3 replays; the
               second: 4 replays): losses and every parameter bit-
               identical; per-step p50 of the calls and of the replays
               beside phase 18's module TrainStep p50s. ``nn.Dropout(0.1)``
               on its 33 activations: 2 ``__call__`` steps against
               ``run_steps(2)``: losses, parameters, the masks (the
               calls' against the warm-up's and the replay's) and the
               chains' final words bit-identical; the generator's counter
               moves by 1 at each TrainStep's construction and by 0 over
               its steps. K2-K4 on the tensor cores, no plain version.
23. tiers     — tiered KV at Llama-3-8B (``tools/llama3_8b_tiers.py``:
               bf16, 32 layers, random weights from seed 0, block 16, a
               512-token step budget). A greedy request of a 3000-token
               prompt and 32 new tokens on a tiered engine of 64 device
               blocks (1024 tokens) and 512 host blocks: it demotes
               (``num_demotes`` > 0), steps read the host tier's mirror,
               and its tokens equal an untiered 1024-block engine's.
               K1 at the first such step's tables (layer 0's caches and
               mirror, random queries) against its plain version with the
               mirror and bit for bit against one pool holding the same
               pages; both times (CUDA events, L2 flushed). Then 8 greedy
               two-turn sessions (turn 1: 400-900-token prompts, 32 new;
               parked; turn 2: turn 1's tokens and 64 more, 32 new):
               ``resume_session`` returns each parked coverage, 0 tokens
               recomputed, ``kv_tier_park_resumes`` 8, the resumed
               chains' bytes (read from the tier holding each block) equal
               to what turn 1 left, and turn 2 against the same prompts
               served cold by an untiered engine. Demotes, promotes, the
               host ms of ``apply_moves`` and of ``claim_resume`` (which
               holds the tail restore); the tiered steps run as captured
               graphs (captures only at a bucket's first use).
24. long_tail — the rest of the manifest and the nn long tail
               (``tools/long_tail_cases.py``, ``tools/long_tail_sizes.py``,
               ``tools/ds2_ctc_train.py``; f32, TF32 off). Every case of
               the vision, long-tail and nn long tail sections on the card
               against the same case on the CPU: outputs and the gradients
               of a seeded cotangent at the sweep's tolerances (1e-4 / 1e-5
               for the ops whose card kernels add in another order), the
               generator's state equal after each. At published sizes,
               forward + backward timed (CUDA events) with peak memory, and
               held against the CPU at a reduced batch (values and
               gradients within rtol 1e-4 and 1e-4 x the largest CPU
               magnitude, CTC's gradient 1e-3 x): CTC at DeepSpeech2-on-LibriSpeech sizes (logits
               [800, 32, 29], labels of 150-250), RNN-T at B 8, T 200, U 50,
               V 1024, RoIAlign at Mask R-CNN R50-FPN's P2 ([2, 256, 200,
               336], 1024 boxes, 7 x 7, sampling ratio 2, aligned), DCNv2
               with its mask ([2, 256, 100, 168], 3 x 3, 256 out),
               affine_grid + grid_sample at [32, 3, 224, 224], and
               yolo_loss on YOLOv3's stride-8 head ([8, 255, 76, 76], 50
               boxes, 80 classes). ``flash_attn_qkvpacked`` at (4, 2048, 3,
               16, 128), bf16, causal, forward and backward, with K2-K4's
               counts set to 0 before and read after (1 each, no plain
               version): bit-identical to ``F.flash_attention`` on the
               unpacked q/k/v, its gradient packed, and within
               ``flash_check``; ``flash_attn_varlen_qkvpacked`` bit-identical
               to ``flash_attn_unpadded`` on the same rows. The DeepSpeech2
               widths model (``nn.GRU(161, 1024, num_layers=3, direction=
               "bidirect")``, ``nn.Linear(2048, 29)``, ``nn.CTCLoss``) at
               batch 32 x 800 frames: 4 AdamW steps, losses finite and
               falling, step p50 and peak memory; at 1 layer, batch 4, 100
               frames, card against CPU: loss within rtol 1e-4, every
               gradient within relative L2 1e-4.
25. tp        — tensor-parallel serving at ``tp_degree=2``
               (``tools/llama3_8b_tp.py``), both ranks on this one card
               through the testing hook ``paddle_tpu_torch.testing.
               tp_hooks.ranks_share_one_device`` (the reference forces
               host devices the same way; two ranks on one card measure
               the TP path, not TP speed). K1 at the per-rank shape (16
               query heads, 4 kv heads, D 128, bf16) on phase 3's mixed
               batch against its plain version at phase 3's tolerance.
               At f32 with 2 of the 32 layers, phase 4's workload at
               tp_degree 1 and 2: token-identical. Then phase 4's model
               (bf16, full depth, seed 0) and workload at tp_degree=2:
               the device backend, the weight hand-off's seconds, each
               rank's peak memory and K1 launches (both ranks' counts set
               to 0 before the workload and read after), TPOT p50 and
               tokens/s beside phase 4's (tp_degree=1, captured graphs;
               the TP step runs uncaptured), and, reported only, the
               greedy streams' first divergences from phase 4 with both
               logit rows there (two partial sums round differently
               from one product in bf16).
26. fleet     — the serving fleet (``paddle_tpu_torch.serving.fleet``,
               ``tools/llama3_8b_fleet.py``), phase 4's engine settings
               with zero drain grace and phase 4's workload. (a) f32 with
               2 of the 32 layers: a two-replica ``FleetRouter`` over
               ``InProcessReplica``s of one model, a prefill/decode pair
               with the KV shipped, and two replicas with the first
               drained after one router step: each 8 of 8 token-identical
               to one engine, every request finished once. (b) Phase 4's
               model (bf16, full depth) behind a prefill and a decode
               replica: ships, bytes, each ship's export (gather) and
               import (scatter) host ms, client TTFT and TPOT p50 beside
               phase 4's, K1 launches per replica, peak memory, and,
               reported only, the greedy streams against phase 4's; K1 at
               the decode replica's first step after an import against
               its plain version (phase 3's tolerance). (c) Two worker
               processes (``ReplicaSupervisor``, prefill and decode) over
               4 of the 32 layers in f32, the KV shipped worker to worker
               over loopback TCP, the decode worker SIGKILLed mid-run:
               8 of 8 token-identical to one engine, every request
               finished once; worker start-up s and peer ship MB/s. (d)
               Beside (c), on a thread that only drives its worker, one
               worker process whose spec sets ``tp_degree=2`` (2 of
               the 32 layers in f32, its two ranks on this card through
               ``PADDLE_TORCH_RANKS_SHARE_DEVICE``): 8 of 8
               token-identical to (a)'s engine, K1 launched on both
               ranks alike, start-up s; then a SIGKILL of the worker, and
               no rank process left within 10 s (each rank watches its
               parent).
27. tp_serving_features — what the fleet, the tiers and speculative
               decoding bring at ``tp_degree=2`` (``tools/llama3_8b_tp.
               py``), both ranks on this card through the testing hook as
               in phase 25. (a) f32 with 2 of the 32 layers, each case
               token-identical to one rank on the same weights: phase 4's
               workload exported mid-decode by a tp 1 engine and imported
               by a tp 2 one, then the other way round (every ship a
               reshard, one prompt token computed a request); a tp 1
               replica drained into a tp 2 peer behind a ``FleetRouter``,
               clean (0 tokens recomputed) and under one
               ``serving.kv_scatter`` fault (a recompute fallback); phase
               23's over-pool request (3000 + 32 tokens on 64 device +
               512 host blocks) at tp 2 against an untiered tp 1 engine;
               phase 4's prompts with 16 new tokens (cut for the run's
               time) through a tp 2 spec engine whose draft is its
               target (4 drafts a row) against tp 1, with equal draft
               counters. (b) bf16 at 2 of the 32 layers (widths not
               cut; ``TP_FEATURES_LAYERS``, cut for the run's time),
               each 8B engine built after the last
               one is dropped: phase 26 (b)'s prefill/decode
               pair with the decode replica at tp 2 (ships, bytes,
               export / import / gather / scatter ms, client TTFT and
               TPOT p50 beside phase 26's, K1 per rank); phase 23's
               over-pool request at tp 2 against an untiered tp 2 engine
               (identical tokens; demotes, mirror steps, K1 per rank);
               phase 9's draft over a tp 2 target (draft ms, acceptance,
               TPOT beside phase 9's; K1 per rank, K2 on rank 0 only);
               the greedy streams against phase 4's, with the logit rows
               where they leave it (spec). K1 at a rank's heads (16 / 4)
               against its plain version at phase 3's tolerance: with the
               mirror as its second pool at the tiered engine's first
               mirror step, and at the spec engine's first verify step.
               Peak memory per rank for each.
28. hybrid_train — hybrid-parallel training over torch.distributed
               (``tools/gpt_1b_hybrid_train.py``): one world of 4 ranks
               started by ``distributed.spawn``, all on this card through
               the testing hook (gloo through the host), kept up for
               every case and shared with phases 29-31 (their parts run
               one after another in it, ``run_jobs``: one start-up). (a) f32 at bench_gpt_1b widths with 2 of its
               16 layers, batch 4 x 2048, three AdamW steps per case: dp
               2, mp 2, dp 2 x mp 2, with SP, ZeRO 1, 2 and 3 at dp 2,
               eager DataParallel at dp 2, dp 2 x mp 2 with ZeRO 1 and
               recompute (two 2-rank cases at once, on ranks 0-1 and
               2-3), each against a one-rank TrainStep
               of the same model and batches (losses rtol 1e-4; every
               rank's shards against the same slices: the elements
               outside rtol 2e-3 / atol 2e-5 counted, and each
               parameter shard held to the AdamW bound of
               tests/test_torch_train.py, its largest |diff| within
               2.5e-4); each rank's
               optimizer state is the reckoned share;
               peaks per rank. (b) bf16 at full width and depth, dp 2 x
               mp 2, ZeRO 1, SP: one warm-up and one timed step; each
               step's loss within 0.02 nats of phase 7's at that step,
               falling; K2-K4 launched 16 times a step on each rank; the
               step p50, the collectives' host ms a step, rank 0's
               device-phase breakdown of its timed step, peaks per rank.
               Not a speed figure: four ranks share one card over gloo.
               K2-K4 at a rank's shape (B 2, S 2048, H 8, D 128, bf16)
               against their plain versions (``flash_check``), timed,
               with bounds.

29. pipeline_train — pipeline-parallel training over torch.distributed
               (``tools/gpt_1b_pipe_train.py``): phase 28's world of 4
               ranks, all on this card through the testing hook (gloo
               through the host), kept up for every case, each rank
               building only
               its stage of LlamaForCausalLMPipe from the seed-0 model.
               (a) f32 at bench_gpt_1b widths with 8 of its 16 layers,
               batch 4 x 2048, three AdamW steps per case: pp 4 "1f1b"
               M 4, pp 2 "1f1b" M 4 (two chunks), dp 2 x pp 2, pp 2 x
               mp 2, pp 4 "gpipe", "zero_bubble" and "interleave" V 2,
               each against a one-rank TrainStep of LlamaForCausalLM
               with the same weights and batch (losses rtol 1e-4; each
               rank's parameter shards at phase 28's AdamW bound); the
               pre/post parameters hold 1/S of their elements, the slots
               the reckoned bytes; peaks per rank. Three more cases:
               pp4_1f1b saves a multi-rank checkpoint after step 2,
               rebuilds its stages and steps, restores and reruns step 3,
               whose loss, parameters and slots are bit-identical to the
               unbroken step 3's (save and restore s, bytes a rank);
               pp2_lamb, pp 2 "1f1b" M 4 with Lamb (one trust ratio per
               parameter) against a one-rank TrainStep with Lamb, each
               parameter moved and its update within
               gpt_1b_pipe_train.LAMB_UPDATE_REL of the one-rank update;
               pp2_sp2_cp, the context-parallel Pipe at pp 2 x sp 2 (each
               microbatch's sequence cut over sp, the body's attention
               the ring; largest |diff| within
               gpt_1b_pipe_train.CP_PARAM_MAX_ABS), K2-K4 launched as
               reckoned (r + 1 chunks a layer and microbatch at sp index
               r, K2 again in the recompute). The worst element of each
               case carries the one-rank run's first gradient there.
               (b) bf16 at full
               width and depth, pp 4, "1f1b", M 4, pre/post sliced over
               pp, remat: one warm-up and one timed step; each step's
               loss within 0.02 nats of phase 7's at that step, falling;
               K2 launched 32 times a step on each rank (4 layers x 4
               microbatches, and again in the recompute), K3 and K4 16;
               the step p50, the P2P and collective host ms a step, rank
               0's device-phase breakdown of its timed step, peaks per
               rank. Not a speed figure: four ranks share one card over
               gloo. K2-K4 at a pp rank's microbatch (B 1, S 2048, H 16,
               D 128, bf16) against their plain versions
               (``flash_check``), timed, with bounds.
30. cp_train  — context-parallel training over torch.distributed
               (``tools/gpt_1b_cp_train.py``): phase 28's world of 4
               ranks on this card through the testing hook (gloo through
               the host), one job with phase 31, the Llama with
               ``context_parallel=True``: each rank of sp holds its chunk
               of the sequence through the whole stack, the attention is
               the ring (K2 a chunk, merged by lse; K3 and K4 given the
               merged lse and delta; k/v and the f32 dK/dV passed around
               the ring by batched isend/irecv). First, on this process:
               K2-K4 at a ring chunk (B 2, 1024 x 1024, H 16, D 128,
               bf16), the diagonal (causal) and an earlier (whole) chunk,
               against their plain versions (``flash_check``), timed, with
               bounds and SDPA's times; the ring's chunked path for a
               ring of 2 at that chunk: f32 against the reference's plain
               recurrence and its autograd (``flash_check.TOL``), bf16
               chunk by chunk (``flash_check``'s forward and backward
               halves, given the merged lse). (a) f32 at bench_gpt_1b
               widths with 2 of its 16 layers, batch 4 x 2048, three
               AdamW steps per case: dp 2 x sp 2, sp 4 (``cp_batch_axis=
               None``), dp 2 x sp 2 with ZeRO 1, each against a one-rank
               TrainStep of the dense model at phase 28's bounds, slots
               the reckoned bytes; then cp_dp2_sp2_masked: 2 layers, a
               padding mask keeping 2048, 1701, 1250 and 731 keys of the
               four sequences, one forward and backward (each rank its
               query rows, K and V all-gathered over sp, dense attention
               with the mask, not causal: the reference's masked branch)
               against the one-rank dense model's, every reading's
               largest |diff| within 1e-4 of its largest value. (b) bf16
               at full width and depth, dp 2
               x sp 2, ZeRO 1 over dp: one warm-up and one timed step;
               losses within 0.02 nats of phase 7's, falling; K2-K4
               launched (r + 1) x 16 times on the rank at sp index r
               (its diagonal chunk and the r earlier ones a layer); the
               step p50, the ring's P2P and the collectives' host ms and
               bytes a step, peaks per rank. Not a speed figure.
31. moe_train — ``tests/test_moe.py``'s MoEModel at the 1B Llama's
               widths (d 2048, 8 experts of 2048 -> 5632 -> 2048, gate
               gshard with its capacity factors: C 1229 at 8192 tokens;
               ``tools/moe_train.py``), MSE + 0.01 aux on 4 x 2048 tokens,
               in phase 30's world. (a) f32, three AdamW steps at ep 4
               (batch replicated over ep), ep 4 (batch sharded over ep:
               the all-to-all) and dp 2 x ep 2, each against a one-rank
               TrainStep at phase 28's bounds; (b) bf16 ep 4 sharded, one
               warm-up and three steps, within 0.02 of the one-rank bf16
               losses. Per step: choices dropped per rank, aux, the
               all-to-all and collective bytes and host ms; step times,
               peaks.

32. gang      — the gang (slice D4): every job is started by
               ``python -m paddle_tpu_torch.distributed.launch
               --nproc_per_node 4`` with PADDLE_TORCH_RANKS_SHARE_DEVICE=1
               (four ranks on this card over gloo, each reporting cuda:0
               and gloo), running ``tools/gpt_1b_gang_train.py``:
               bench_gpt_1b's widths at 2 of its 16 layers, bf16 with f32
               master weights, dp 2 x mp 2, ZeRO 1, SP, async checkpoints
               every step (the last two kept); one gang at a time, three
               launches, four gang start-ups. The launches run on a
               thread beside phases 26 (c)-(d) and 27 (a), which time no
               kernel (27 (b) waits for them); this line comes at its
               turn. (a) 4 steps unbroken. (b)
               rank 1 hangs in step 3 (PADDLE_STEP_TIMEOUT 20 s, poll
               1 s; the tool's hang switch lets rank 1's step-2 save
               land, then arms its collective's tag at a quarter of the
               timeout): it exits 6 naming
               all_reduce@ranks[0, 1, 2, 3], ranks 0, 2, 3 exit 7 naming
               rank 1, the last at most 2 poll intervals plus the abort
               linger (a poll and two monitor periods) after the hang's
               deadline; the launcher (--max_restart 2) relaunches once,
               attempt 1 restores the agreed step 2 and runs step 3. (c)
               SIGTERM to that launcher once every rank of attempt 1 has
               restored, so after step 2 is committed: every rank takes
               its final blocking save at step 3, the launcher exits 0
               without another relaunch, and a new launch resumes there
               and finishes step 4. (b) and (c) bit-identical to (a):
               the losses of steps 3 and 4, and every parameter shard's
               and slot's sha256 after step 4. Seconds per launch, each
               rank's start-up and restore seconds, bytes saved per rank,
               snapshot ms and write s per save, the abort latency, K2-K4
               launches and peaks per rank. The checkpoint directory goes
               at the end.

33. bert      — slice E2a and the high-level API: BERT-base (the
               published uncased_L-12_H-768_A-12 config; random weights
               from the seed, synthetic token ids;
               ``tools/bert_base_train.py``), run after phase 24. (a) f32,
               TF32 off, full widths at 2 of 12 layers: three
               ``Model.fit`` batches of 8 x 128 (dropout on) on the card
               and on the CPU from one set of weights and generator
               state, losses within rtol 1e-4, ``evaluate``'s accuracy
               equal, ``predict``'s logits within 1e-4 of their largest.
               (b) fine-tuning, bf16 autocast ("O1"), 12 layers:
               ``Model.fit`` over 12 batches of 32 x 128 with
               ModelCheckpoint (flat) and EarlyStopping, each batch after
               the first a replay of the captured step; ``evaluate``,
               ``predict``; a Model loaded from the epoch's checkpoint
               predicts the same logits bit for bit. Step p50 over the
               replayed batches, tokens/s, MFU (6 * N_gemm + 12 * L * S *
               h a token, N_gemm 84,934,656 at S 128, over
               ``profiler.device_peak_flops``), peak memory, finite
               losses. (c) masked-LM pre-training, bf16 autocast, 12
               layers, 16 x 512, 15% labelled, through ``jit.TrainStep``:
               the warm-up, the capture and 4 replays, losses and every
               parameter bit-identical to 5 ``__call__`` steps of a twin;
               step p50 over the replays, tokens/s, MFU (N_gemm with the
               tied decoder's 23,440,896), the dropout masks' share of
               the step (the step's 37 masks drawn alone, CUDA events),
               peak memory. (d) K1-K4 launched 0 times over (a)-(c), and
               no plain version of theirs called.

Then one line with the kernel table (name, route, source, launches on
the main paths — ``launches_by_path`` splits them: serve, spec, swap
(both modes), drain, the watched run and cached generate for the ragged
kernel, train, spec and naive generate for the flash forward, and
eager_train and trainstep_scaler (phase 15), fed_train (phase 18),
tensor_api (phase 20), layer_api (phase 21), layer_trainstep (phase
22), long_tail (phase 24's packed flash wrapper) and bert (phase 33, 0
by design) for K2-K4, bert also for K1, and tiers (phase 23's tiered engines), tp (phase 25's
two ranks, summed), fleet (phase 26 (b)'s two replicas), tp_worker
(phase 26 (d)'s two ranks, summed) and tp_disagg,
tp_tiers, tp_spec (phase 27 (b)'s paths, every rank) for K1, tp_spec
for K2, hybrid_train (phase 28 (b)'s four ranks, summed),
pipeline_train (phase 29 (b)'s four ranks, summed), pipeline_train_cp
(phase 29 (a)'s pp2_sp2_cp, four ranks, summed), cp_train (phase
30 (b)'s four ranks, summed) and gang_train (phase 32 (a)'s four
ranks, summed) for K2-K4; on the
paths that replay graphs they are the launches the card ran, the eager
warm-ups plus captured x replays — error, times, bound, library time;
``spec_shapes``, ``generate_shapes``, ``tiers_shapes``, ``tp_shapes``,
``fleet_shapes``, ``tp_tiers_shapes``, ``tp_spec_shapes``,
``hybrid_rank_shapes``, ``pipeline_rank_shapes`` and
``cp_ring_chunk_shapes`` (diagonal and earlier chunk) repeat them at
those paths' shapes; ``gang_rank_shapes`` gives phase 32's launches by
rank at the hybrid rank's shape),
nvidia-smi's line, and last ``{"ok": true, "device": {...}}``.
"""
import gc
import json
import os
import re
import subprocess
import sys
import threading
import time
import weakref

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
SWAP_BLOCKS = 128              # about half the serve workload's KV blocks
STEP_TIMEOUT_S = 2.0           # the watchdog's deadline in phase 12
GENERATE_PROMPT = (2, 128)     # phase 13's generate: (batch, prompt)
GENERATE_NEW = 16              # and its new tokens
H100_BF16_FLOP_PER_S = 989e12  # dense bf16 tensor-core peak


_CLOCK = [time.perf_counter()] * 2   # the run's start, the last line's


def emit(obj):
    """One JSON line on stdout; on stderr, the seconds since the last
    line (the phase's, for a phase's line) and since the start."""
    print(json.dumps(obj), flush=True)
    now = time.perf_counter()
    print("chip_smoke: %s %.1f s, %.1f s in all" % (
        obj.get("phase", "line"), now - _CLOCK[1], now - _CLOCK[0]),
        file=sys.stderr, flush=True)
    _CLOCK[1] = now


class _Beside(threading.Thread):
    """``fn(*args)`` on a thread beside the phases that follow;
    :meth:`result` waits for it and returns its value, or raises its
    error on the caller's thread."""

    def __init__(self, fn, *args):
        super().__init__(name=fn.__name__, daemon=True)
        self._call, self._out, self._err = (fn, args), None, None

    def run(self):
        fn, args = self._call
        try:
            self._out = fn(*args)
        except BaseException as e:      # raised by result()
            self._err = e

    def result(self):
        self.join()
        if self._err is not None:
            raise self._err
        return self._out


def cuda_ms(fn, iters, flush=None):
    """Mean device time of ``fn`` over ``iters`` launches, each timed on
    its own between CUDA events; ``flush`` runs before each (outside the
    timed window)."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def _bound(nbytes, flops):
    """The least time for the work: bytes over the memory rate or flops
    over the bf16 peak, whichever is larger."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_flops = flops / H100_BF16_FLOP_PER_S * 1e3
    return {"bytes": nbytes, "flops": flops,
            "bound_ms": max(t_bytes, t_flops),
            "bound_by": "bytes" if t_bytes >= t_flops else "operations"}


# ---------------------------------------------------------------------------
def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi


def _hgmma_counts(lib_path, nvcc):
    """wgmma (SASS ``HGMMA``) instructions per kernel instance of a built
    library, from ``cuobjdump -sass``; an instance is named by its kernel
    and template arguments (f32 or bf16, head dim)."""
    sass = subprocess.run(
        [os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass",
         lib_path], capture_output=True, text=True, timeout=300,
        check=True).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : \S*?\d((?:flash|ragged)_\w+?kernel"
                      r"(?:_tc)?)(?:I(f?)\S*?Li(\d+)E)?", line)
        if m:
            args = ([] if m.group(3) is None else
                    ["f32" if m.group(2) else "bf16", m.group(3)])
            cur = f"{m.group(1)}<{', '.join(args)}>"
            counts[cur] = 0
        elif "Function :" in line:
            cur = None
        elif cur is not None and "HGMMA" in line:
            counts[cur] += 1
    return counts


def phase_build():
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa

    t0 = time.perf_counter()
    infos = _build.build_all(["ragged_paged_attention", "flash_attention",
                              "shm_queue"])
    from paddle_tpu_torch.io import shm_queue
    assert shm_queue.native_available(), shm_queue._LIB_ERR
    dts = ("bfloat16", "float32")
    smem = {f"ragged_paged_attention_{dt}":
            rpa.smem_bytes(128, getattr(torch, dt)) for dt in dts}
    smem.update({f"{k}_{dt}": fa.smem_bytes(k, 128, getattr(torch, dt))
                 for k in fa.launches for dt in dts})
    # every bf16 kernel runs on the tensor cores: each instance of the
    # `_tc` kernels (flash forward, dQ, dK/dV and ragged, at 4 head dims)
    # holds wgmma instructions; the f32 FMA kernels and the split combine
    # hold none
    hgmma = {}
    for name in ("ragged_paged_attention", "flash_attention"):
        hgmma.update(_hgmma_counts(infos[name]["path"], _build._nvcc()))
    tc = {k: n for k, n in hgmma.items() if "_tc" in k.split("<")[0]}
    assert len(tc) == 16 and all(n > 0 for n in tc.values()), hgmma
    assert all(n == 0 for k, n in hgmma.items() if k not in tc), hgmma
    assert sum(k.startswith("ragged_combine_kernel<") for k in hgmma) == 4, \
        hgmma
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "sources": {name: {"nvcc_seconds": round(info["seconds"], 3),
                             "built": info["built"],
                             "ptxas": info["ptxas"].splitlines()}
                      for name, info in infos.items()},
          "dynamic_smem_bytes_per_cta_d128": smem,
          "hgmma_per_kernel": hgmma})


# Llama-3-8B head shapes: H=32, KH=8, D=128, block 16, bf16.
# (rows this step, context after the step) per live slot
MIXED_LIVE = [(1, 17), (1, 300), (512, 1536), (1, 1000), (100, 100),
              (1, 2048)]
DECODE_LIVE = [(1, c) for c in (512, 1024, 1536, 2048, 2560, 3072, 3584,
                                4096)]
VERIFY_LIVE = [(5, c) for c in (300, 450, 600, 700, 800, 900, 1000, 1100)]


def _ragged_batch(dev, gen, live, s_slots, mb, nb, pad_rows, h=32, kh=8):
    """A ragged batch: ``live`` slots of (rows, context) out of
    ``s_slots``, distinct random pages, -1 table entries past each
    context, ``pad_rows`` padding rows past cu[num_seqs]; ``h`` query
    and ``kh`` kv heads (default: the 8B's; a TP rank holds a share)."""
    d, bs = 128, 16
    ns = len(live)
    cu = np.zeros((s_slots + 1,), np.int32)
    cu[1:ns + 1] = np.cumsum([n for n, _ in live])
    cu[ns + 1:] = cu[ns]
    ctx = np.zeros((s_slots,), np.int32)
    ctx[:ns] = [c for _, c in live]
    bt = np.full((s_slots, mb), -1, np.int32)
    perm = np.random.default_rng(0).permutation(nb)
    k = 0
    for i, (_, c) in enumerate(live):
        need = -(-c // bs)
        bt[i, :need] = perm[k:k + need]
        k += need
    t_total = int(cu[ns]) + pad_rows

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(torch.bfloat16)

    return dict(q=randn(t_total, h, d), k_new=randn(t_total, kh, d),
                v_new=randn(t_total, kh, d), key_cache=randn(nb, bs, kh, d),
                value_cache=randn(nb, bs, kh, d),
                block_tables=torch.from_numpy(bt).to(dev),
                cu_seqlens=torch.from_numpy(cu).to(dev),
                context_lens=torch.from_numpy(ctx).to(dev),
                num_seqs=torch.tensor([ns], dtype=torch.int32, device=dev))


def _ragged_case(b, live, flush):
    """One batch through the kernels (the entry point: cache write, then
    attention) against the plain version on the same inputs; times and
    the bound of the attention call."""
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa

    q = b["q"]
    t_total, h, d = q.shape
    kh = b["key_cache"].shape[2]
    scale = d ** -0.5
    n_live = int(sum(n for n, _ in live))

    kc_ref = b["key_cache"].clone()
    vc_ref = b["value_cache"].clone()
    routes = rpa.route_launches()
    out, kc, vc = rpa.ragged_paged_attention(
        q, b["k_new"], b["v_new"], b["key_cache"], b["value_cache"],
        b["block_tables"], b["cu_seqlens"], b["context_lens"],
        b["num_seqs"], scale=scale)
    routes = {k: n - routes[k] for k, n in rpa.route_launches().items()}
    split, nsplit = rpa.kernel_split(q, kc, b["block_tables"])
    seg, pos, _ = rpa._token_layout(t_total, b["block_tables"].shape[0],
                                    b["cu_seqlens"], b["context_lens"],
                                    b["num_seqs"])
    rpa._write_kv(kc_ref, b["k_new"], b["block_tables"], seg, pos)
    rpa._write_kv(vc_ref, b["v_new"], b["block_tables"], seg, pos)
    plain_args = (q, kc_ref, vc_ref, b["block_tables"], b["cu_seqlens"],
                  b["context_lens"], b["num_seqs"], scale)
    ref = rpa._ragged_attend_ref(*plain_args, out_dtype=torch.float32,
                                 round_to=torch.bfloat16, split=split)
    torch.cuda.synchronize()
    assert routes == {"fma": 0, "tensor_cores": 1,
                      "combine": int(nsplit > 1)}, routes
    assert torch.equal(kc, kc_ref) and torch.equal(vc, vc_ref), \
        "kernel path and plain path left different caches"
    assert torch.all(out[n_live:] == 0), "padding rows are not exact zeros"
    max_abs_err = float((out[:n_live].float() - ref[:n_live]).abs().max())
    # tolerance: the kernel accumulates in f32 like the plain version; it
    # rounds P to bf16 per chunk of 64 positions (as the TPU kernel rounds
    # it per page) and so does the plain version it is held against
    # (`round_to`, in the kernel's splits), so only the summation order
    # and the output's rounding to bf16 differ (at most half a relative
    # step of 2^-8, which rtol covers). atol stays well under |out|
    # (~0.05 on the long-context rows), so a dropped chunk cannot pass
    torch.testing.assert_close(out[:n_live].float(), ref[:n_live],
                               rtol=1e-2, atol=1e-3)

    args = (q, kc, vc, b["block_tables"], b["cu_seqlens"],
            b["context_lens"], b["num_seqs"], scale)
    launches_before = rpa.launches
    ms = cuda_ms(lambda: rpa._ragged_attend_cuda(*args), 20, flush=flush)
    plain_ms = cuda_ms(lambda: rpa._ragged_attend_ref(
        *args, round_to=torch.bfloat16, split=split), 3, flush=flush)
    assert rpa.launches > launches_before

    # least work: Q read, O written (all T rows), each slot's K and V
    # read once; 4*H*D flops per (row, visible position)
    esz = q.element_size()
    kv_tokens = sum(c for _, c in live)
    nbytes = (n_live * h * d * esz + t_total * h * d * esz
              + 2 * kv_tokens * kh * d * esz)
    flops = 0
    for n, c in live:
        pos_plus_1 = np.arange(c - n + 1, c + 1, dtype=np.int64)
        flops += 4 * h * d * int(pos_plus_1.sum())
    res = {"rows_live": n_live, "rows": t_total, "slots_live": len(live),
           "contexts": [c for _, c in live], "split": split,
           "nsplit": nsplit, "routes": routes, "max_abs_err": max_abs_err,
           "tolerance": "rtol=1e-2, atol=1e-3 vs the f32 plain version's "
                        "round_to=bfloat16 form (bf16 output)",
           "ms": ms, "plain_ms": plain_ms, **_bound(nbytes, flops)}
    res["bound_share"] = res["bound_ms"] / ms
    return res


def phase_kernel(dev):
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    from paddle_tpu_torch.serving import EngineConfig
    from paddle_tpu_torch.serving.engine import token_buckets
    from paddle_tpu_torch.tools import llama3_8b_serve, llama3_8b_spec_serve

    gen = torch.Generator(device=dev).manual_seed(1)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev).zero_
    mixed = _ragged_case(_ragged_batch(dev, gen, MIXED_LIVE, 8, 128, 1024,
                                       37), MIXED_LIVE, flush)
    decode = _ragged_case(_ragged_batch(dev, gen, DECODE_LIVE, 8, 256, 1152,
                                        0), DECODE_LIVE, flush)
    assert decode["nsplit"] > 1, decode
    # the spec path's verify launch (phase 9): k + 1 rows per slot, at
    # the engine's token bucket, so with pad rows past cu[num_seqs], and
    # at the split the kernel takes for the engine's shapes
    ecfg = EngineConfig(**llama3_8b_serve.ENGINE)
    assert {n for n, _ in VERIFY_LIVE} == {
        llama3_8b_spec_serve.NUM_SPEC_TOKENS + 1}
    assert len(VERIFY_LIVE) == ecfg.max_num_seqs
    n_rows = sum(n for n, _ in VERIFY_LIVE)
    t_verify = min(b for b in token_buckets(ecfg) if b >= n_rows)
    mb = ecfg.max_model_len // ecfg.block_size
    verify = _ragged_case(_ragged_batch(
        dev, gen, VERIFY_LIVE, ecfg.max_num_seqs, mb, 640,
        t_verify - n_rows), VERIFY_LIVE, flush)
    _, want = rpa._splits(t_verify, ecfg.max_num_seqs, 8, 4, mb,
                          ecfg.block_size, rpa._sm_count(dev.index))
    assert verify["rows"] == t_verify > n_rows, verify
    assert verify["nsplit"] == want > 1, (verify, want)
    gen_cases = _generate_k1_cases(dev, gen, flush)
    emit({"phase": "kernel", "mixed": mixed, "decode": decode,
          "verify": verify, "generate": gen_cases})
    return mixed, verify, gen_cases


def _generate_k1_cases(dev, gen, flush):
    """K1 at the steps of phase 13's cached ``generate`` (the engine it
    builds for GENERATE_PROMPT, Llama-3-8B): its prefill step (both
    prompts whole, at their bucket) and its last decode step (one row
    per slot at the longest context, padded to the smallest bucket), at
    the split the kernel takes for that engine's shapes."""
    from paddle_tpu_torch.models.llama import (LlamaConfig,
                                               generate_engine_config)
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    from paddle_tpu_torch.serving.engine import token_buckets

    b, s = GENERATE_PROMPT
    ecfg = generate_engine_config(LlamaConfig.llama3_8b(), b, s,
                                  GENERATE_NEW)
    mb = ecfg.max_model_len // ecfg.block_size
    cases = {}
    for name, live in (("prefill", [(s, s)] * b),
                       ("decode", [(1, s + GENERATE_NEW - 1)] * b)):
        rows = sum(n for n, _ in live)
        t = min(k for k in token_buckets(ecfg) if k >= rows)
        case = _ragged_case(_ragged_batch(
            dev, gen, live, ecfg.max_num_seqs, mb, ecfg.max_num_seqs * mb,
            t - rows), live, flush)
        _, want = rpa._splits(t, ecfg.max_num_seqs, 8, 4, mb,
                              ecfg.block_size, rpa._sm_count(dev.index))
        assert case["rows"] == t and case["nsplit"] == want, (case, want)
        cases[name] = case
    return cases


class _GreedyRows:
    """While active, keep the target's logit row behind each token that
    the greedy requests ``rids`` emit, in the order of their positions,
    on the card: the row the sampler took its argmax from (a slot with d
    drafts finds its j-th emitted token's row at R-1-d+j of the R
    gathered rows). ``stop`` (request id -> phase 4's tokens) ends a
    request's record at the first position where it differs. Reads the
    step graph's static logits output after each step; launches no
    kernel, only one row gather per step. Also keeps, per step key, the
    host arrays of the first step at it (``inputs``)."""

    def __init__(self, eng, rids, stop=None):
        self.eng, self.stop = eng, stop or {}
        self.rows = {rid: [] for rid in rids}
        self.done = set()
        self.inputs = {}
        self.logits = self.pending = None

    def __enter__(self):
        dispatch = self.eng._dispatch

        def dispatching(reqs, key, arrays):
            out = dispatch(reqs, key, arrays)
            self.inputs.setdefault(key, [a.copy() for a in arrays])
            self.logits = self.eng._graphs.outputs(key)[1]
            self.pending = [(i, r, len(r.generated), len(r.draft_tokens))
                            for i, r in enumerate(reqs)
                            if r.request_id in self.rows]
            return out

        self.eng._dispatch = dispatching
        return self

    def __exit__(self, *exc):
        del self.eng._dispatch
        self.eng = None

    def after_step(self):
        """File the rows of the tokens this step emitted."""
        slots, picks, owners = [], [], []
        for i, r, g0, d in self.pending or ():
            rid = r.request_id
            for p in range(g0, len(r.generated)):
                if rid in self.done:
                    break
                slots.append(i)
                picks.append(self.logits.shape[1] - 1 - d + p - g0)
                owners.append(rid)
                ref = self.stop.get(rid)
                if ref is not None and r.generated[p] != ref[p]:
                    self.done.add(rid)
        self.pending = None
        if slots:
            for rid, row in zip(owners, self.logits[slots, picks]):
                self.rows[rid].append(row)


def _margin(row, a, b):
    """row[a] - row[b] in f32."""
    return float(row[a].float() - row[b].float())


def _divergences(serve_rows, serve_tokens, spec_rows, spec_tokens,
                 names=("serve", "spec")):
    """Per greedy request: the first position where phase 9's stream
    leaves phase 4's, phase 4's margin of its token over phase 9's in its
    decode row and phase 9's margin of its token over phase 4's in its
    verify row (both >= 0: each row's argmax), the two rows' largest
    difference there, and the largest over the equal prefix before.
    ``names`` label the two sides' keys (phase 13: cached and naive
    ``generate``)."""
    for rows, tokens in ((serve_rows, serve_tokens),
                         (spec_rows, spec_tokens)):
        for rid, kept in rows.items():   # each row is its token's argmax
            got = torch.stack(kept).float().argmax(dim=-1).tolist()
            assert got == tokens[rid][:len(kept)], (rid, got, tokens[rid])
    out = {}
    for rid, rows9 in spec_rows.items():
        t4, t9 = serve_tokens[rid], spec_tokens[rid]
        p = next((q for q, (a, b) in enumerate(zip(t4, t9)) if a != b),
                 None)
        diffs = [float((rows9[q].float() - serve_rows[rid][q].float())
                       .abs().max()) for q in range(len(rows9))]
        res = {"first_divergence": p,
               "max_abs_diff_equal_prefix": max(
                   diffs if p is None else diffs[:p], default=None)}
        if p is not None:
            r4, r9 = serve_rows[rid][p], rows9[p]
            res.update({
                "tokens": [int(t4[p]), int(t9[p])],
                f"{names[0]}_margin": _margin(r4, t4[p], t9[p]),
                f"{names[1]}_margin": _margin(r9, t9[p], t4[p]),
                f"{names[0]}_top": float(r4.float().max()),
                "max_abs_diff": diffs[p]})
        out[rid] = res
    return out


def phase_serve(dev):
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    from paddle_tpu_torch.tools import llama3_8b_serve

    t0 = time.perf_counter()
    eng = llama3_8b_serve.build_engine(dev)   # model, engine, warm-up
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cfg = eng.model.config
    n_params = sum(p.numel() for p in eng.model.parameters())
    rids, lens = llama3_8b_serve.add_requests(eng)
    torch.cuda.reset_peak_memory_stats()
    routes = rpa.route_launches()
    snap = eng._graphs.snapshot()
    with _GreedyRows(eng, rids[:-1]) as rows:   # for phase 9's comparison
        rpa.launches = 0                  # main path starts here
        t1 = time.perf_counter()
        step_ms = []
        while eng.has_unfinished():
            t2 = time.perf_counter()
            eng.step()
            step_ms.append((time.perf_counter() - t2) * 1e3)
            rows.after_step()
            assert len(step_ms) < 1000, "engine failed to converge"
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        wrapped = rpa.launches            # main path ends here
    routes = {k: n - routes[k] for k, n in rpa.route_launches().items()}
    window = eng._graphs.since(snap)
    model_steps = eng.metrics.engine_steps
    layers = cfg.num_hidden_layers
    replayed = window["replayed_launches"].get("ragged_paged_attention", 0)
    launches = window["executed_launches"].get("ragged_paged_attention", 0)
    # one replay per model step, the kernel once per layer in each; the
    # wrapper counts launches only where it launches them: once in each
    # capture's eager warm-up and once in the capture itself
    assert sum(window["replays"].values()) == model_steps, window
    assert replayed == layers * model_steps, (replayed, model_steps)
    assert wrapped == 2 * layers * window["captures"], (wrapped, window)
    assert launches == replayed + wrapped // 2, (launches, replayed, wrapped)
    # bf16: every launch on the tensor cores, captured ones too (the
    # combine runs on the steps whose batch is split)
    assert routes["fma"] == 0 and routes["tensor_cores"] == wrapped, routes
    graphs = eng._graphs.since()
    assert graphs["captures"] == len(eng._seen_shapes), graphs
    for key, captured in graphs["captured_launches"].items():
        assert captured["ragged_paged_attention/tensor_cores"] == layers \
            and "ragged_paged_attention/fma" not in captured, (key, captured)
    lattice = {("ragged", b, eng.cfg.max_num_seqs) for b in eng.step_buckets}
    assert eng._seen_shapes <= lattice, (eng._seen_shapes, lattice)
    gen_tokens = 0
    for rid in rids:
        r = eng.get_request(rid)
        assert r.finish_reason == "length", (rid, r.finish_reason)
        assert len(r.generated) == llama3_8b_serve.MAX_NEW_TOKENS
        assert all(0 <= t < cfg.vocab_size for t in r.generated)
        gen_tokens += len(r.generated)
    assert eng.block_manager.num_free_blocks == eng.cfg.num_blocks
    m = eng.metrics
    res = {"phase": "serve", "model": "llama3_8b", "params": n_params,
           "layers": cfg.num_hidden_layers, "dtype": "bfloat16",
           "prompt_lens": [int(x) for x in lens],
           "prompt_tokens": int(lens.sum()), "generated_tokens": gen_tokens,
           "wall_s": wall, "tokens_per_s": gen_tokens / wall,
           "ttft_ms_p50": float(np.percentile(m.ttfts_s, 50) * 1e3),
           "tpot_ms_p50": float(np.percentile(m.tpots_s, 50) * 1e3),
           "steps": model_steps, "step_ms": step_ms,
           "prefill_chunks": int(eng.scheduler.num_prefill_chunks),
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "setup_s": setup_s, "kernel_launches": launches,
           "kernel_launches_replayed": replayed,
           "kernel_launches_wrapper": wrapped, "route_launches": routes,
           "step_buckets": list(eng.step_buckets),
           "graphs": {"engine": graphs, "window": window},
           "sampled": eng.get_request("r7").generated[:8]}
    # at each bucket stepped, one recorded step's inputs: a replay of the
    # bucket's graph against the eager step on the same buffers (the
    # same shapes and kernels, so bit-identical; no tolerance)
    from paddle_tpu_torch.tools.step_checks import replay_matches_eager

    same = {"x".join(map(str, key[1:])):
            replay_matches_eager(eng, key, arrays)
            for key, arrays in sorted(rows.inputs.items())}
    assert same and all(all(v.values()) for v in same.values()), same
    res["replay_vs_eager_bit_identical"] = same
    emit(res)
    res["tokens"] = {rid: eng.get_request(rid).generated for rid in rids}
    res["rows"] = rows.rows
    assert all(len(v) == llama3_8b_serve.MAX_NEW_TOKENS
               for v in rows.rows.values())
    gone = [weakref.ref(x) for x in (eng, eng.model)]
    del eng
    # no reference cycle holds the engine: it and its model go now
    assert not any(r() for r in gone), "the engine outlived its references"
    torch.cuda.empty_cache()
    return res


def phase_parity(dev):
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    from paddle_tpu_torch.serving import (EngineConfig, LLMEngine,
                                          SamplingParams)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = LlamaConfig.tiny()
    cpu_model = LlamaForCausalLM(cfg, device="cpu")
    cpu_model.init_weights(torch.Generator().manual_seed(0))
    card_model = LlamaForCausalLM(cfg, device=dev)
    card_model.load_state_dict(cpu_model.state_dict())
    prompts = [list(map(int, np.random.default_rng(i).integers(
        0, cfg.vocab_size, size=n))) for i, n in enumerate([5, 17, 33, 9])]
    sp = SamplingParams(max_new_tokens=8)
    ecfg = dict(block_size=4, max_num_seqs=4, max_model_len=64,
                max_batched_tokens=32)
    before = rpa.launches
    card_eng = LLMEngine(card_model, EngineConfig(**ecfg))
    on_card = card_eng.generate(prompts, sp)
    card_launches = rpa.launches - before
    on_cpu = LLMEngine(cpu_model, EngineConfig(**ecfg)).generate(prompts,
                                                                 sp)
    assert card_launches > 0
    assert set(card_eng._graphs.keys) == card_eng._seen_shapes
    assert on_card == on_cpu, (on_card, on_cpu)
    emit({"phase": "parity", "model": "tiny", "dtype": "float32",
          "requests": len(prompts), "identical": True,
          "kernel_launches": card_launches,
          "graphs": card_eng._graphs.since(), "tokens": on_card})


# ---------------------------------------------------------------------------
# flash attention (K2-K4) and training
# ---------------------------------------------------------------------------
# kernel vs plain: ``testing/flash_check.py`` holds every case at its
# TOL (and says why those tolerances); in bf16 it adds the one-ulp effect
# of each P or dS entry near a rounding boundary to the elements it feeds.
FLASH_CASES = [  # name, dtype, B, Sq, Sk, H, D, causal
    ("train_shapes", torch.bfloat16, 4, 2048, 2048, 16, 128, True),
    ("draft_max_len", torch.bfloat16, 8, 2048, 2048, 32, 64, True),
    ("f32", torch.float32, 2, 512, 512, 4, 64, True),
    ("sq_ne_sk_ragged_tail", torch.bfloat16, 2, 300, 500, 4, 128, True),
]


def _visible_pairs(sq, sk, causal):
    """(query row, key column) pairs the mask lets through, per b*h."""
    if not causal:
        return sq * sk
    rows = np.arange(sq, dtype=np.int64)
    return int(np.clip(rows + (sk - sq) + 1, 0, sk).sum())


def phase_flash(dev, draft_shape):
    """``draft_shape``: (batch, width) of phase 9's widest draft forward,
    checked and timed as the ``draft_shapes`` case. Phase 13's naive
    ``generate`` (Llama-3-8B heads, GENERATE_PROMPT) runs the forward at
    widths prompt .. prompt + GENERATE_NEW - 1: its first ragged tail
    tile and its widest, checked and timed as ``generate_s*``."""
    import torch.nn.functional as F

    from paddle_tpu_torch.models.llama import LlamaConfig
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.testing import flash_check
    from paddle_tpu_torch.tools.llama3_8b_spec_serve import DRAFT

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(2)
    res = {"phase": "flash", "cases": {}, "fwd_only": {}}
    db, dw = draft_shape
    dh = DRAFT["num_attention_heads"]
    draft_case = ("draft_shapes", torch.bfloat16, db, dw, dw, dh,
                  DRAFT["hidden_size"] // dh, True)
    big = LlamaConfig.llama3_8b()
    gb, gs = GENERATE_PROMPT
    gh = big.num_attention_heads
    generate_cases = [(f"generate_s{w}", torch.bfloat16, gb, w, w, gh,
                       big.hidden_size // gh, True)
                      for w in (gs + 1, gs + GENERATE_NEW - 1)]
    fwd_only = {c[0] for c in [draft_case] + generate_cases}
    # the generate cases draw last, so the earlier cases keep the inputs
    # they were checked on before the generate cases came in
    for name, dtype, b, sq, sk, h, d, causal in (
            [draft_case] + FLASH_CASES + generate_cases):
        def randn(s):
            return torch.randn((b, s, h, d), generator=gen, device=dev,
                               dtype=torch.float32).to(dtype)

        q, k, v, do = randn(sq), randn(sk), randn(sk), randn(sq)
        scale = d ** -0.5
        o, lse = fa._flash_fwd_cuda(q, k, v, scale, causal)
        delta = fa._delta(o, do)
        dq = fa._flash_bwd_dq_cuda(q, k, v, do, lse, delta, scale, causal)
        dk, dv = fa._flash_bwd_dkv_cuda(q, k, v, do, lse, delta, scale,
                                        causal)
        torch.cuda.synchronize()
        # element-wise at flash_check.TOL, plus, in bf16, the allowance of
        # the P and dS entries near a rounding boundary (F4's check)
        rep = flash_check.check(q, k, v, do, {"o": o, "lse": lse, "dq": dq,
                                              "dk": dk, "dv": dv},
                                scale, causal)
        errs = rep["max_abs_err"]
        res["cases"][name] = {"dtype": str(dtype).split(".")[-1],
                              "shape": [b, sq, sk, h, d], "causal": causal,
                              "max_abs_err": errs,
                              "tolerance": str(rep["tolerance"]),
                              "check": {key: rep[key] for key in (
                                  "outside_plain_tol", "near_boundary",
                                  "max_extra", "extra_over_atol", "loose",
                                  "elements_loosened", "elements")}}
        flush = torch.empty(64 * 2 ** 20, dtype=torch.int32,
                            device=dev).zero_
        args = (q, k, v, scale, causal)
        pairs = _visible_pairs(sq, sk, causal) * b * h
        esz, n_q, n_k = q.element_size(), q.numel(), k.numel()
        stats = 4 * b * h * sq                  # lse or delta, f32
        if name in fwd_only:   # inference: the forward timed alone
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            ms = {"fwd": cuda_ms(lambda: fa._flash_fwd_cuda(*args), 10,
                                 flush),
                  "plain_fwd": cuda_ms(lambda: fa._flash_fwd_ref(
                      *args, round_to=dtype), 3, flush)}
            with torch.no_grad():
                ms["sdpa_fwd"] = cuda_ms(
                    lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True), 10, flush)
            bound = _bound(esz * (2 * n_q + 2 * n_k) + stats, 4 * d * pairs)
            res["fwd_only"][name] = {
                "ms": ms, "bound": bound,
                "tflops": bound["flops"] / (ms["fwd"] * 1e-3) / 1e12,
                "bound_share": bound["bound_ms"] / ms["fwd"]}
            continue
        if name != "train_shapes":
            continue
        res.update(_flash_train_times(q, k, v, do, o, lse, delta, scale,
                                      causal, flush))
    emit(res)
    return res


def _flash_train_times(q, k, v, do, o, lse, delta, scale, causal, flush):
    """The training kernels (forward, dQ, dK/dV) timed at the inputs'
    shape (CUDA events, L2 flushed before each launch), their plain
    versions' and SDPA's forward and backward, the bounds, TFLOP/s and
    the share of the bound reached."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import flash_attention as fa

    dtype = q.dtype
    b, sq, h, d = q.shape
    sk = k.shape[1]
    args = (q, k, v, scale, causal)
    bargs = (q, k, v, do, lse, delta, scale, causal)
    ms = {"fwd": cuda_ms(lambda: fa._flash_fwd_cuda(*args), 10, flush),
          "dq": cuda_ms(lambda: fa._flash_bwd_dq_cuda(*bargs), 10, flush),
          "dkv": cuda_ms(lambda: fa._flash_bwd_dkv_cuda(*bargs), 10,
                         flush),
          "plain_fwd": cuda_ms(lambda: fa._flash_fwd_ref(
              *args, round_to=dtype), 3, flush),
          "plain_bwd": cuda_ms(lambda: fa._flash_bwd_ref(
              q, k, v, o, lse, do, scale, causal, round_to=dtype), 3,
              flush)}
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    with torch.no_grad():
        ms["sdpa_fwd"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal), 10, flush)
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    ms["sdpa_bwd"] = cuda_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), 10, flush)
    pairs = _visible_pairs(sq, sk, causal) * b * h
    esz, n_q, n_k = q.element_size(), q.numel(), k.numel()
    stats = 4 * b * h * sq                  # lse or delta, f32
    bounds = {
        "fwd": _bound(esz * (2 * n_q + 2 * n_k) + stats, 4 * d * pairs),
        "dq": _bound(esz * (3 * n_q + 2 * n_k) + 2 * stats, 6 * d * pairs),
        "dkv": _bound(esz * (2 * n_q + 4 * n_k) + 2 * stats,
                      8 * d * pairs)}
    return {"ms": ms, "bounds": bounds,
            "tflops": {key: bd["flops"] / (ms[key] * 1e-3) / 1e12
                       for key, bd in bounds.items()},
            "bound_share": {key: bd["bound_ms"] / ms[key]
                            for key, bd in bounds.items()}}


def phase_train(dev):
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.tools import gpt_1b_train

    t0 = time.perf_counter()
    model, step, x, y = gpt_1b_train.build(dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cfg = model.config
    torch.cuda.reset_peak_memory_stats()
    losses = [float(step(x, y))]          # warm-up step
    routes = fa.route_launches()
    for name in fa.launches:              # main path starts here
        fa.launches[name] = 0
    times = []
    for _ in range(5):
        t1 = time.perf_counter()
        loss = step(x, y)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(loss))
    launches = dict(fa.launches)          # main path ends here
    routes = {k: {r: n - routes[k][r] for r, n in v.items()}
              for k, v in fa.route_launches().items()}
    want = cfg.num_hidden_layers * len(times)
    assert all(n == want for n in launches.values()), (launches, want)
    assert all(r == {"fma": 0, "tensor_cores": want}
               for r in routes.values()), routes
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    p50 = float(np.percentile(times, 50))
    tokens = gpt_1b_train.BATCH * gpt_1b_train.SEQ
    fpt = gpt_1b_train.flops_per_token(model)
    res = {"phase": "train", "model": "gpt_1b (bench.py bench_gpt_1b)",
           "params": sum(p.numel() for p in model.parameters()),
           "layers": cfg.num_hidden_layers, "hidden": cfg.hidden_size,
           "dtype": "bfloat16", "batch": [gpt_1b_train.BATCH,
                                          gpt_1b_train.SEQ],
           "losses": losses, "step_ms": times, "step_ms_p50": p50,
           "tokens_per_s": tokens / (p50 / 1e3),
           "flops_per_token": fpt,
           "mfu": fpt * tokens / (p50 / 1e3) / H100_BF16_FLOP_PER_S,
           "mfu_peak": "989 TFLOP/s dense bf16 (H100 SXM data sheet)",
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "setup_s": setup_s, "kernel_launches": launches,
           "route_launches": routes}
    emit(res)
    del model, step
    torch.cuda.empty_cache()
    return res


def phase_train_parity(dev):
    from paddle_tpu_torch.tools import tiny_train_parity

    emit({"phase": "train_parity", **tiny_train_parity.run(dev)})


# ---------------------------------------------------------------------------
# speculative decoding (K1 verify rows, K2 draft forwards)
# ---------------------------------------------------------------------------
class _PlainCalls:
    """Count calls of the kernels' plain versions while active: the card's
    main path must reach none of them."""

    NAMES = (("rpa", "_ragged_attend_ref"), ("fa", "_flash_fwd_ref"),
             ("fa", "_flash_bwd_ref"))

    def __enter__(self):
        from paddle_tpu_torch.ops import flash_attention as fa
        from paddle_tpu_torch.ops import ragged_paged_attention as rpa

        self.mods = {"rpa": rpa, "fa": fa}
        self.calls = {name: 0 for _, name in self.NAMES}
        self.saved = []
        for mod, name in self.NAMES:
            fn = getattr(self.mods[mod], name)
            self.saved.append((mod, name, fn))

            def counted(*a, _fn=fn, _name=name, **kw):
                self.calls[_name] += 1
                return _fn(*a, **kw)

            setattr(self.mods[mod], name, counted)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(self.mods[mod], name, fn)


def phase_spec(dev, serve_res, draft_shape):
    """``draft_shape``: phase 6's draft case, (batch, width); the widest
    draft forward of this run must have had it."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    from paddle_tpu_torch.tools import llama3_8b_serve, llama3_8b_spec_serve

    t0 = time.perf_counter()
    eng = llama3_8b_spec_serve.build_engine(dev)  # models, engine, warm-up
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cfg = eng.model.config
    dcfg = eng.cfg.draft_model.config
    k = eng.cfg.num_spec_tokens
    rids, lens = llama3_8b_serve.add_requests(eng)
    # draft time per proposal: synchronized wall time around each call;
    # and the (batch, width) bucket of its forwards
    spec = eng._spec
    propose, draft_ms, buckets = spec.propose, [], {}

    def timed_propose(lists):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = propose(lists)
        torch.cuda.synchronize()
        draft_ms.append((time.perf_counter() - t) * 1e3)
        bw = (spec._bucket(len(lists)),
              spec._bucket(max(len(x) for x in lists) + k, 8))
        buckets[bw] = buckets.get(bw, 0) + 1
        return out

    eng._spec.propose = timed_propose
    torch.cuda.reset_peak_memory_stats()
    rroutes, froutes = rpa.route_launches(), fa.route_launches()
    tsnap, dsnap = eng._graphs.snapshot(), spec.graphs.snapshot()
    greedy = rids[:-1]
    with _PlainCalls() as plain, _GreedyRows(
            eng, greedy, stop=serve_res["tokens"]) as rows:
        rpa.launches = 0                  # main path starts here
        for name in fa.launches:
            fa.launches[name] = 0
        t1 = time.perf_counter()
        step_ms = []
        while eng.has_unfinished():
            t2 = time.perf_counter()
            eng.step()
            step_ms.append((time.perf_counter() - t2) * 1e3)
            rows.after_step()
            assert len(step_ms) < 1000, "engine failed to converge"
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        # main path ends here
        wrapped = {"ragged_paged_attention": rpa.launches, **fa.launches}
    rroutes = {r: n - rroutes[r] for r, n in rpa.route_launches().items()}
    froutes = {name: {r: n - froutes[name][r] for r, n in v.items()}
               for name, v in fa.route_launches().items()}
    twin = eng._graphs.since(tsnap)
    dwin = spec.graphs.since(dsnap)
    model_steps = eng.metrics.engine_steps
    # the target: one replay per model step, K1 once per layer in each;
    # the draft: one replay per proposal, K2 once per layer and forward
    assert sum(twin["replays"].values()) == model_steps, twin
    assert sum(dwin["replays"].values()) == len(draft_ms) > 0, dwin
    k1_replayed = twin["replayed_launches"].get("ragged_paged_attention", 0)
    assert k1_replayed == cfg.num_hidden_layers * model_steps, \
        (k1_replayed, model_steps)
    k2_replayed = dwin["replayed_launches"].get("flash_attention_fwd", 0)
    want_k2 = dcfg.num_hidden_layers * k * len(draft_ms)
    assert k2_replayed == want_k2, (k2_replayed, want_k2)
    # the wrappers counted the warm-ups and the captures only
    assert wrapped["ragged_paged_attention"] == \
        2 * cfg.num_hidden_layers * twin["captures"], (wrapped, twin)
    assert wrapped["flash_attention_fwd"] == \
        2 * dcfg.num_hidden_layers * k * dwin["captures"], (wrapped, dwin)
    assert wrapped["flash_attention_bwd_dq"] == \
        wrapped["flash_attention_bwd_dkv"] == 0, wrapped
    assert rroutes["fma"] == 0 and \
        rroutes["tensor_cores"] == wrapped["ragged_paged_attention"], rroutes
    assert froutes["flash_attention_fwd"] == {
        "fma": 0, "tensor_cores": wrapped["flash_attention_fwd"]}, froutes
    tall, dall = eng._graphs.since(), spec.graphs.since()
    for graphs, name in ((tall, "ragged_paged_attention"),
                         (dall, "flash_attention_fwd")):
        for key, captured in graphs["captured_launches"].items():
            assert f"{name}/fma" not in captured and \
                captured[f"{name}/tensor_cores"] == captured[name], \
                (key, captured)
    k1 = twin["executed_launches"].get("ragged_paged_attention", 0)
    k2 = {name: dwin["executed_launches"].get(name, 0)
          for name in fa.launches}
    assert not any(plain.calls.values()), plain.calls
    widest = max(buckets, key=lambda bw: bw[0] * bw[1])
    assert widest == tuple(draft_shape), (buckets, draft_shape)
    gen_tokens, equal, first_diff = 0, 0, []
    for i, rid in enumerate(rids):
        r = eng.get_request(rid)
        assert r.finish_reason == "length", (rid, r.finish_reason)
        assert len(r.generated) == llama3_8b_serve.MAX_NEW_TOKENS
        assert all(0 <= t < cfg.vocab_size for t in r.generated)
        gen_tokens += len(r.generated)
        if i < llama3_8b_serve.NUM_REQUESTS - 1:   # the greedy ones
            same = [a == b for a, b in zip(r.generated,
                                           serve_res["tokens"][rid])]
            equal += sum(same)
            # where the stream first leaves phase 4's (32: never)
            first_diff.append(same.index(False) if False in same
                              else len(same))
    assert eng.block_manager.num_free_blocks == eng.cfg.num_blocks
    m = eng.metrics
    res = {"phase": "spec", "model": "llama3_8b",
           "draft": "llama3.2-1b widths (random weights)",
           "draft_params": sum(p.numel() for p in
                               eng.cfg.draft_model.parameters()),
           "num_spec_tokens": k, "dtype": "bfloat16",
           "generated_tokens": gen_tokens, "wall_s": wall,
           "tokens_per_s": gen_tokens / wall,
           "ttft_ms_p50": float(np.percentile(m.ttfts_s, 50) * 1e3),
           "tpot_ms_p50": float(np.percentile(m.tpots_s, 50) * 1e3),
           "steps": model_steps, "step_ms": step_ms,
           "spec_proposed": eng.num_spec_proposed,
           "spec_accepted": eng.num_spec_accepted,
           "spec_acceptance_rate": eng.spec_acceptance_rate,
           "proposals": len(draft_ms),
           "draft_ms_mean": float(np.mean(draft_ms)),
           "draft_ms_p50": float(np.percentile(draft_ms, 50)),
           "draft_share_of_wall": sum(draft_ms) / 1e3 / wall,
           "draft_buckets": {f"{b}x{w}": n for (b, w), n
                             in sorted(buckets.items())},
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "setup_s": setup_s,
           "kernel_launches": {"ragged_paged_attention": k1, **k2},
           "kernel_launches_replayed": {
               "ragged_paged_attention": k1_replayed,
               "flash_attention_fwd": k2_replayed},
           "kernel_launches_wrapper": wrapped,
           "route_launches": {"ragged_paged_attention": rroutes,
                              "flash_attention_fwd":
                                  froutes["flash_attention_fwd"]},
           "graphs": {"target": {"engine": tall, "window": twin},
                      "draft": {"engine": dall, "window": dwin}},
           "plain_calls": plain.calls,
           "greedy_tokens_equal_serve": equal,
           "greedy_first_divergence": first_diff,
           "greedy_tokens": (llama3_8b_serve.NUM_REQUESTS - 1)
           * llama3_8b_serve.MAX_NEW_TOKENS,
           # the target's logit rows where a greedy stream leaves phase
           # 4's (bf16 logits, compared in f32)
           "greedy_divergence_rows": _divergences(
               serve_res["rows"], serve_res["tokens"], rows.rows,
               {rid: eng.get_request(rid).generated for rid in greedy})}
    emit(res)
    del spec.propose                      # the timing wrapper holds spec
    gone = [weakref.ref(x) for x in (eng, eng.model, spec, spec.model)]
    del eng, spec, propose, timed_propose
    # no reference cycle holds the engine: it and its models go now
    assert not any(r() for r in gone), "the engine outlived its references"
    torch.cuda.empty_cache()
    return res


def phase_spec_parity(dev):
    from paddle_tpu_torch.tools import tiny_spec_parity

    emit({"phase": "spec_parity", **tiny_spec_parity.run(dev)})


# ---------------------------------------------------------------------------
# one-card resilience: host swap, drain, the watchdog, the bucketed path
# ---------------------------------------------------------------------------
def _serve_8b(eng):
    """Queue the serve workload on ``eng`` and step it to the end. Returns
    the request ids, every output, the wall seconds and the step ms."""
    from paddle_tpu_torch.tools import llama3_8b_serve

    rids, _ = llama3_8b_serve.add_requests(eng)
    outs, step_ms = [], []
    t0 = time.perf_counter()
    while eng.has_unfinished():
        t1 = time.perf_counter()
        outs.extend(eng.step())
        step_ms.append((time.perf_counter() - t1) * 1e3)
        assert len(step_ms) < 2000, "engine failed to converge"
    torch.cuda.synchronize()
    return rids, outs, time.perf_counter() - t0, step_ms


def _latency(eng, wall) -> dict:
    m = eng.metrics
    return {"ttft_ms_p50": float(np.percentile(m.ttfts_s, 50) * 1e3),
            "tpot_ms_p50": float(np.percentile(m.tpots_s, 50) * 1e3),
            "tokens_per_s": m.num_generated_tokens / wall,
            "generated_tokens": m.num_generated_tokens, "wall_s": wall,
            "steps": m.engine_steps}


def _k1(window) -> int:
    return window["executed_launches"].get("ragged_paged_attention", 0)


def _freed(*objs):
    """Weak references to ``objs``, which must be dead once the caller
    drops its own references (no reference cycle holds them)."""
    return [weakref.ref(o) for o in objs]


def phase_swap(dev, model):
    """Serve on half the KV blocks the workload needs, preempting by host
    swap, then by recompute; the restored bytes checked bit for bit."""
    from paddle_tpu_torch.serving import EngineConfig, LLMEngine
    from paddle_tpu_torch.tools import llama3_8b_serve
    from paddle_tpu_torch.tools.step_checks import SwapCheck

    t0 = time.perf_counter()
    runs, tokens = {}, {}
    for mode in ("host", "recompute"):
        eng = LLMEngine(model, EngineConfig(**llama3_8b_serve.ENGINE,
                                            num_blocks=SWAP_BLOCKS,
                                            swap_mode=mode))
        check = SwapCheck(eng) if mode == "host" else None
        caches = (eng._kcs, eng._vcs)
        addr = [t.data_ptr() for t in caches]
        snap = eng._graphs.snapshot()
        rids, _, wall, step_ms = _serve_8b(eng)
        # the graphs hold the caches' addresses: restores write in place
        assert eng._kcs is caches[0] and eng._vcs is caches[1]
        assert [t.data_ptr() for t in caches] == addr
        window = eng._graphs.since(snap)
        sch, bm = eng.scheduler, eng.block_manager
        for rid in rids:
            r = eng.get_request(rid)
            assert r.finish_reason == "length", (rid, r.finish_reason)
            assert len(r.generated) == llama3_8b_serve.MAX_NEW_TOKENS
        assert bm.num_free_blocks == eng.cfg.num_blocks
        assert bm.num_free_host_blocks == eng.cfg.num_host_blocks
        assert _k1(window) > 0, window
        run = {"preemptions": sch.num_preemptions,
               "swap_outs": sch.num_swap_outs, "swap_ins": sch.num_swap_ins,
               **_latency(eng, wall), "step_ms_p50":
                   float(np.percentile(step_ms, 50)),
               "captures": window["captures"],
               "capture_s": window["capture_s"],
               "kernel_launches": _k1(window)}
        if check is not None:
            check.close()
            assert sch.num_swap_outs > 0, run
            assert sch.num_swap_ins == sch.num_swap_outs, run
            assert check.restored == sch.num_swap_ins, check.restored
            assert not check.mismatches, check.mismatches
            assert eng._host_k.is_pinned() and eng._host_v.is_pinned()
            run.update({
                "restored_bit_identical": True,
                "spill_bytes": check.spilled_bytes,
                "host_pool_bytes": 2 * eng._host_k.numel()
                * eng._host_k.element_size(),
                **{f"{k}_ms": v for k, v in check.ms.items()}})
        runs[mode] = run
        tokens[mode] = [eng.get_request(r).generated for r in rids]
        gone = _freed(eng)
        del eng, check, caches
        assert not any(r() for r in gone), "the engine outlived its refs"
        torch.cuda.empty_cache()
    greedy = llama3_8b_serve.NUM_REQUESTS - 1
    res = {"phase": "swap", "model": "llama3_8b", "dtype": "bfloat16",
           "num_blocks": SWAP_BLOCKS, **runs,
           # bf16: recompute rebuilds a victim's K/V in a prefill chunk,
           # swap keeps the decode rows' bytes (reported, not asserted)
           "greedy_streams_equal": sum(
               a == b for a, b in zip(tokens["host"][:greedy],
                                      tokens["recompute"][:greedy])),
           "greedy_streams": greedy,
           "wall_s": time.perf_counter() - t0}
    emit(res)
    return res


def phase_drain(dev, model):
    """The serve workload with a real SIGTERM after the first decode step;
    then a run with the watchdog armed across fresh captures; then a warm
    step that sleeps past the deadline."""
    from paddle_tpu_torch.distributed.watchdog import PreemptionMonitor
    from paddle_tpu_torch.serving import (EngineConfig, LLMEngine,
                                          SamplingParams, StepHungError)
    from paddle_tpu_torch.testing import faults
    from paddle_tpu_torch.tools import llama3_8b_serve

    t0 = time.perf_counter()
    eng = LLMEngine(model, EngineConfig(**llama3_8b_serve.ENGINE,
                                        num_blocks=SWAP_BLOCKS,
                                        swap_mode="host"))
    monitor = eng.install_preemption_handler(PreemptionMonitor())
    at_drain = {}
    start_drain = eng.start_drain

    def recorded_start(*a, **kw):
        at_drain.update({rid: (r.status.value, len(r.generated))
                         for rid, r in eng._requests.items()})
        return start_drain(*a, **kw)

    eng.start_drain = recorded_start
    snap = eng._graphs.snapshot()
    rids, _ = llama3_8b_serve.add_requests(eng)
    outs, steps, sent = [], 0, False
    try:
        while eng.has_unfinished():
            outs.extend(eng.step())
            steps += 1
            assert steps < 2000, "engine failed to converge"
            if not sent and eng.metrics.decode_steps >= 1:
                # the next dispatch raises a real SIGTERM
                faults.install(f"{faults.SERVING_STEP}:sigterm*1")
                sent = True
        torch.cuda.synchronize()
    finally:
        monitor.uninstall()
        faults.clear()
    del eng.start_drain
    window = eng._graphs.since(snap)
    finals = [o for o in outs if o.finished]
    assert sorted(o.request_id for o in finals) == sorted(rids), finals
    reasons = {o.request_id: o.finish_reason for o in finals}
    assert set(reasons.values()) <= {"length", "aborted:drain"}, reasons
    waiting = [rid for rid, (st, _) in at_drain.items() if st == "waiting"]
    assert waiting and all(reasons[rid] == "aborted:drain"
                           and len(eng.get_request(rid).generated)
                           == at_drain[rid][1] for rid in waiting), at_drain
    assert any(at_drain[rid][1] == 0 for rid in waiting), at_drain
    assert eng.drained and eng.num_drains_completed == 1
    assert eng.block_manager.num_free_blocks == eng.cfg.num_blocks
    assert eng.block_manager.num_free_host_blocks == eng.cfg.num_host_blocks
    late = eng.add_request([1, 2, 3], SamplingParams(max_new_tokens=2))
    assert eng.get_request(late).finish_reason == "rejected"
    drain = {"steps": steps, "finish": reasons,
             "at_drain": {k: list(v) for k, v in at_drain.items()},
             "drain_aborted": eng.num_drain_aborted,
             "kernel_launches": _k1(window), "late": "rejected"}
    gone = _freed(eng)
    del eng, start_drain, recorded_start
    assert not any(r() for r in gone), "the engine outlived its refs"

    # the watchdog armed across the workload's fresh captures
    eng = LLMEngine(model, EngineConfig(**llama3_8b_serve.ENGINE,
                                        step_timeout_s=STEP_TIMEOUT_S))
    snap = eng._graphs.snapshot()
    rids, _, wall, _ = _serve_8b(eng)
    window = eng._graphs.since(snap)
    wd = eng._watchdog
    assert not wd.fired and wd._prober is not None, wd.fired
    assert all(eng.get_request(r).finish_reason == "length" for r in rids)
    watched = {"step_timeout_s": STEP_TIMEOUT_S, **_latency(eng, wall),
               "captures": window["captures"],
               "capture_s": window["capture_s"],
               "kernel_launches": _k1(window), "false_alarms": 0}
    # a warm step (a decode at a captured bucket) sleeping past it
    hung = [eng.add_request(f"h{i}", list(range(1, 17)),
                            SamplingParams(max_new_tokens=4))
            for i in range(2)]
    faults.install(f"{faults.SERVING_STEP}:sleep:{STEP_TIMEOUT_S + 1.0}"
                   f"@1*1")
    t1 = time.perf_counter()
    try:
        while eng.has_unfinished():
            eng.step()
        raise AssertionError("the hung step was not caught")
    except StepHungError as e:
        reasons = sorted(o.finish_reason for o in e.outputs)
        assert sorted(o.request_id for o in e.outputs) == sorted(hung)
        assert reasons == ["aborted:error"] * len(hung), reasons
        assert all(eng.get_request(r).finish_reason == "aborted:error"
                   for r in hung)
        watched["hung_step"] = {"raised": type(e).__name__,
                                "seconds": time.perf_counter() - t1,
                                "outputs": reasons}
    finally:
        faults.clear()
    assert wd.fired
    assert eng.block_manager.num_free_blocks == eng.cfg.num_blocks
    gone = _freed(eng, wd)
    del eng, wd
    assert not any(r() for r in gone), "the engine outlived its refs"
    torch.cuda.empty_cache()
    res = {"phase": "drain", "model": "llama3_8b", "dtype": "bfloat16",
           "drain": drain, "watchdog": watched,
           "wall_s": time.perf_counter() - t0}
    emit(res)
    return res


class _TokenRows:
    """While active, keep the logit row behind each token that ``eng``
    emits (no draft rows: the slot's one row), per (request id, position
    of the token), and the request ids in the order they were added."""

    def __init__(self, eng):
        self.eng, self.rids, self.rows = eng, [], {}

    def __enter__(self):
        eng = self.eng
        dispatch, add = eng._dispatch, eng.add_request

        def adding(*a, **kw):
            self.rids.append(add(*a, **kw))
            return self.rids[-1]

        def dispatching(reqs, key, arrays):
            at = [(r.request_id, len(r.generated)) for r in reqs]
            out = dispatch(reqs, key, arrays)
            logits = eng._graphs.outputs(key)[1]
            for i, k in enumerate(at):   # a later chunk's row wins
                self.rows[k] = logits[i, -1].clone()
            return out

        eng._dispatch, eng.add_request = dispatching, adding
        return self

    def __exit__(self, *exc):
        del self.eng._dispatch, self.eng.add_request
        self.eng = None


def phase_bucketed(dev, model):
    """The serve workload through the bucketed path (ragged=False): one
    graph per (kind, B, S) key, no K1; then generate, cached and naive."""
    from paddle_tpu_torch.models.llama import generate_engine_config
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    from paddle_tpu_torch.serving import EngineConfig, LLMEngine
    from paddle_tpu_torch.tools import llama3_8b_serve
    from paddle_tpu_torch.tools.step_checks import replay_matches_eager

    t0 = time.perf_counter()
    eng = LLMEngine(model, EngineConfig(**llama3_8b_serve.ENGINE,
                                        ragged=False))
    first, stepped = {}, []
    dispatch = eng._dispatch

    def recording(reqs, key, arrays):
        first.setdefault(key, [a.copy() for a in arrays])
        stepped.append(key)
        return dispatch(reqs, key, arrays)

    eng._dispatch = recording
    torch.cuda.reset_peak_memory_stats()
    routes = rpa.route_launches()
    rpa.launches = 0
    rids, _, wall, step_ms = _serve_8b(eng)
    wrapped = rpa.launches
    del eng._dispatch
    graphs = eng._graphs.since()
    assert eng._seen_shapes == set(first) == set(eng._graphs.keys), \
        (eng._seen_shapes, sorted(first))
    assert wrapped == 0 and _k1(graphs) == 0, (wrapped, graphs)
    assert len(stepped) == len(step_ms), (len(stepped), len(step_ms))
    by_key = {}
    for key, ms in zip(stepped, step_ms):
        by_key.setdefault("x".join(map(str, key)), []).append(ms)
    assert rpa.route_launches() == routes
    for rid in rids:
        r = eng.get_request(rid)
        assert r.finish_reason == "length", (rid, r.finish_reason)
        assert len(r.generated) == llama3_8b_serve.MAX_NEW_TOKENS
    assert eng.block_manager.num_free_blocks == eng.cfg.num_blocks
    peak = torch.cuda.max_memory_allocated()
    # replay vs eager at one prefill key and one decode key
    keys = [min(k for k in first if k[0] == kind)
            for kind in ("prefill", "decode")]
    same = {"x".join(map(str, k)): replay_matches_eager(eng, k, first[k])
            for k in keys}
    assert all(all(v.values()) for v in same.values()), same
    snap = eng.metrics.snapshot()
    res = {"phase": "bucketed", "model": "llama3_8b", "dtype": "bfloat16",
           **_latency(eng, wall),
           "step_ms_p50": float(np.percentile(step_ms, 50)),
           # each key's first step includes its warm-up and capture
           "step_ms_by_key": by_key,
           "padded_token_frac": snap["padded_token_frac"],
           "keys": sorted("x".join(map(str, k)) for k in eng._seen_shapes),
           "captures": graphs["captures"], "capture_s": graphs["capture_s"],
           "capture_bytes": graphs["capture_bytes"],
           "max_memory_allocated": peak,
           "replay_vs_eager_bit_identical": same,
           "kernel_launches_ragged": 0}
    gone = _freed(eng)
    del eng, dispatch, recording
    assert not any(r() for r in gone), "the engine outlived its refs"
    torch.cuda.empty_cache()

    # generate on GENERATE_PROMPT: cached (the ragged engine, K1) and
    # naive (forward, K2), compared (bf16: reported) with the logit row
    # behind each token. The cached engine is built here as generate
    # builds it, so that its rows can be kept from its first step
    b, s = GENERATE_PROMPT
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, model.config.vocab_size, size=(b, s))).to(dev)
    fa_before = fa.launches["flash_attention_fwd"]
    rpa.launches = 0
    t1 = time.perf_counter()
    geng = LLMEngine(model, generate_engine_config(model.config, b, s,
                                                   GENERATE_NEW))
    model._serving_engine = geng
    with _TokenRows(geng) as kept:
        cached = model.generate(ids, max_new_tokens=GENERATE_NEW)
    torch.cuda.synchronize()
    cached_s = time.perf_counter() - t1
    assert model._serving_engine is geng, "generate built another engine"
    k1 = _k1(geng._graphs.since())
    del geng
    model.close()
    naive_rows = []
    hook = model.register_forward_hook(
        lambda mod, args, out: naive_rows.append(out[:, -1].clone()))
    try:
        t1 = time.perf_counter()
        naive = model.generate(ids, max_new_tokens=GENERATE_NEW,
                               use_cache=False)
        torch.cuda.synchronize()
        naive_s = time.perf_counter() - t1
    finally:
        hook.remove()
    k2 = fa.launches["flash_attention_fwd"] - fa_before
    layers = model.config.num_hidden_layers
    assert k1 > 0 and k2 == layers * GENERATE_NEW, (k1, k2)
    assert cached.shape == naive.shape == (b, s + GENERATE_NEW)
    assert torch.equal(cached[:, :s], ids)
    new_c, new_n = cached[:, s:].tolist(), naive[:, s:].tolist()
    assert len(kept.rids) == b and len(naive_rows) == GENERATE_NEW
    div = _divergences(
        {i: [kept.rows[(rid, p)] for p in range(GENERATE_NEW)]
         for i, rid in enumerate(kept.rids)}, dict(enumerate(new_c)),
        {i: [row[i] for row in naive_rows] for i in range(b)},
        dict(enumerate(new_n)), names=("cached", "naive"))
    res["generate"] = {
        "prompt": [b, s], "new_tokens": GENERATE_NEW, "cached_s": cached_s,
        "naive_s": naive_s, "tokens_equal": sum(
            a == c for rc, rn in zip(new_c, new_n) for a, c in zip(rc, rn)),
        "tokens": b * GENERATE_NEW, "divergences": div,
        "kernel_launches": {"ragged_paged_attention": k1,
                            "flash_attention_fwd": k2}}
    res["wall_s"] = time.perf_counter() - t0
    emit(res)
    return res


def phase_resilience_parity(dev):
    from paddle_tpu_torch.tools import tiny_resilience_parity

    t0 = time.perf_counter()
    res = tiny_resilience_parity.run(dev)
    emit({"phase": "resilience_parity", **res,
          "wall_s": time.perf_counter() - t0})


# ---------------------------------------------------------------------------
# the eager training loop (phases 15-17)
# ---------------------------------------------------------------------------
EAGER_STEPS = 6                # measured steps of phase 15, after a warm-up
RESUME_LAYERS = 2              # phase 16: phase 15's widths at 2 layers
CKPT_DIR = "_ckpt_smoke"       # phase 16's checkpoints, under the checkout


def phase_eager_train(dev, tr):
    """Phase 7's configuration through the user's eager loop
    (``tools/eager_train.py``): warm-up and EAGER_STEPS timed steps, an
    inf injected into one gradient, then the same configuration through
    ``TrainStep(scaler=...)``. ``tr``: phase 7's result (its p50)."""
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.optimizer.lr import (CosineAnnealingDecay,
                                               LinearWarmup)
    from paddle_tpu_torch.tools import eager_train, gpt_1b_train

    cfg = gpt_1b_train.config()
    batch = (gpt_1b_train.BATCH, gpt_1b_train.SEQ)
    t0 = time.perf_counter()
    run = eager_train.build(cfg, dev, batch)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    losses = [float(eager_train.step(run))]          # warm-up step
    routes = fa.route_launches()
    for name in fa.launches:                         # main path starts here
        fa.launches[name] = 0
    times, lrs, scales = [], [], []
    for _ in range(EAGER_STEPS):
        lrs.append(run.opt.get_lr())
        t1 = time.perf_counter()
        loss = eager_train.step(run)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(loss))
        scales.append(run.scaler._scale)
    launches = dict(fa.launches)                     # main path ends here
    routes = {k: {r: n - routes[k][r] for r, n in v.items()}
              for k, v in fa.route_launches().items()}
    peak = torch.cuda.max_memory_allocated()
    want = cfg.num_hidden_layers * EAGER_STEPS
    assert all(n == want for n in launches.values()), (launches, want)
    assert all(r == {"fma": 0, "tensor_cores": want}
               for r in routes.values()), routes
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    # the lr each step used is the scheduler's host value at that step
    host = LinearWarmup(CosineAnnealingDecay(eager_train.PEAK_LR, T_max=8),
                        warmup_steps=2, start_lr=0.0,
                        end_lr=eager_train.PEAK_LR)
    host.step()                                      # the warm-up's step
    want_lrs = []
    for _ in range(EAGER_STEPS):
        want_lrs.append(host())
        host.step()
    assert lrs == want_lrs, (lrs, want_lrs)
    # the scale as a host GradScaler with no inf takes it: the loop runs
    # update() twice a step (GradScaler.step runs it too, as the JAX
    # package's does), so with incr_every_n_steps=2 it doubles a step
    ref = GradScaler(init_loss_scaling=eager_train.INIT_SCALE,
                     incr_every_n_steps=2)
    want_scales = []
    for _ in range(EAGER_STEPS + 1):
        ref.update()
        ref.update()
        want_scales.append(ref._scale)
    assert scales == want_scales[1:], (scales, want_scales)

    # one gradient set to inf before scaler.step: no update at all
    before = {k: v for k, v in eager_train._snapshot(run, "cpu").items()
              if isinstance(v, torch.Tensor)}
    scale0, skipped0 = run.scaler._scale, run.scaler.skipped_steps

    def corrupt(model):
        model.lm_head.weight.grad[0, 0] = float("inf")

    inf_loss = float(eager_train.step(run, corrupt=corrupt))
    after = eager_train._snapshot(run, "cpu")
    changed = [k for k in before if not torch.equal(before[k], after[k])]
    assert not changed, changed[:4]
    inf = {"loss": inf_loss, "scale_before": scale0,
           "scale_after": run.scaler._scale,
           "skipped_steps_before": skipped0,
           "skipped_steps_after": run.scaler.skipped_steps,
           "params_and_slots_bit_identical": True,
           "tensors_compared": len(before)}
    del before, after
    # two bad updates (decr_every_n_nan_or_inf = 2): the scale halves
    assert inf["scale_after"] == scale0 / 2, inf
    assert inf["skipped_steps_after"] > skipped0, inf
    del run
    torch.cuda.empty_cache()

    # the same configuration through TrainStep(scaler=...)
    run = eager_train.build(cfg, dev, batch)
    step = TrainStep(run.model, run.model.criterion(), run.opt,
                     scaler=run.scaler)
    ts_losses = [float(step(run.x, run.y))]
    run.sched.step()
    ts_routes = fa.route_launches()
    for name in fa.launches:                         # main path starts here
        fa.launches[name] = 0
    ts_times = []
    for _ in range(EAGER_STEPS):
        t1 = time.perf_counter()
        loss = step(run.x, run.y)
        torch.cuda.synchronize()
        ts_times.append((time.perf_counter() - t1) * 1e3)
        ts_losses.append(float(loss))
        run.sched.step()
    ts_launches = dict(fa.launches)                  # main path ends here
    ts_routes = {k: {r: n - ts_routes[k][r] for r, n in v.items()}
                 for k, v in fa.route_launches().items()}
    assert all(n == want for n in ts_launches.values()), ts_launches
    assert all(r == {"fma": 0, "tensor_cores": want}
               for r in ts_routes.values()), ts_routes
    assert all(np.isfinite(ts_losses)) and ts_losses[-1] < ts_losses[0]
    ts_scale = run.scaler._scale
    del step, run
    torch.cuda.empty_cache()

    p50 = float(np.percentile(times, 50))
    tokens = batch[0] * batch[1]
    model_fpt = tr["flops_per_token"]
    res = {"phase": "eager_train",
           "model": "gpt_1b (bench.py bench_gpt_1b)", "dtype": "bfloat16",
           "loop": "scaler.scale(loss).backward(); scaler.step(opt); "
                   "scaler.update(); opt.clear_grad(); sched.step()",
           "optimizer": "AdamW(multi_precision) + ClipGradByGlobalNorm(1.0)"
                        " over LinearWarmup(CosineAnnealingDecay(3e-4, 8))",
           "losses": losses, "step_ms": times, "step_ms_p50": p50,
           "trainstep_p50_phase7": tr["step_ms_p50"],
           "p50_over_phase7": p50 / tr["step_ms_p50"],
           "tokens_per_s": tokens / (p50 / 1e3),
           "mfu": model_fpt * tokens / (p50 / 1e3) / H100_BF16_FLOP_PER_S,
           "lrs": lrs, "loss_scales": scales, "inf_injection": inf,
           "max_memory_allocated": peak, "setup_s": setup_s,
           "kernel_launches": launches, "route_launches": routes,
           "trainstep_scaler": {
               "losses": ts_losses, "step_ms": ts_times,
               "step_ms_p50": float(np.percentile(ts_times, 50)),
               "loss_scale": ts_scale, "kernel_launches": ts_launches,
               "route_launches": ts_routes,
               "max_abs_loss_diff_vs_eager": float(np.max(np.abs(
                   np.array(ts_losses) - np.array(losses))))}}
    emit(res)
    return res


def phase_resume(dev):
    """Phase 15's widths at RESUME_LAYERS layers: 6 unbroken steps (run
    twice), then 3, a blocking CheckpointManager save, a fresh model and
    optimizer restored, 3 more: bit-identical (``eager_train.resume``)."""
    import shutil

    from paddle_tpu_torch.tools import eager_train, gpt_1b_train

    cfg = gpt_1b_train.config()
    cfg.num_hidden_layers = RESUME_LAYERS
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), CKPT_DIR)
    try:
        rep = eager_train.resume(
            cfg, dev, (gpt_1b_train.BATCH, gpt_1b_train.SEQ), root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    res = {"phase": "resume", "layers": RESUME_LAYERS, **rep}
    emit(res)
    return res


def phase_eager_parity(dev):
    from paddle_tpu_torch.tools import tiny_train_parity

    emit({"phase": "eager_parity",
          **tiny_train_parity.run_eager(dev, "momentum")})


# ---------------------------------------------------------------------------
# the fed training loop and the phase breakdown (phases 18-19)
# ---------------------------------------------------------------------------
def phase_fed_train(dev, tr):
    """Phase 18, and phase 19 on the same two models. ``tr``: phase 7's
    result (its p50)."""
    import gc

    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.tools import fed_train, gpt_1b_train

    k = fed_train.K
    data = fed_train.TokenBatches(k * fed_train.DISPATCHES,
                                  gpt_1b_train.config().vocab_size)
    torch.cuda.reset_peak_memory_stats()
    model, opt, step = fed_train.build(dev)
    loader = fed_train.make_loader(data, dev)
    routes = fa.route_launches()
    for name in fa.launches:                         # main path starts here
        fa.launches[name] = 0
    fed = fed_train.run_fed(step, loader)
    launches = dict(fa.launches)                     # main path ends here
    routes = {n: {r: c - routes[n][r] for r, c in v.items()}
              for n, v in fa.route_launches().items()}
    graphs = step.graph_stats()
    fed_state = fed_train.snapshot(model, opt)
    n_steps = len(data)
    (key, captured), = graphs["captured_launches"].items()
    replays = graphs["replays"][key]
    # the wrappers count where they issue: the warm-up step and the
    # capture; the card ran warm-up + captured x replays
    assert replays == n_steps - 1, graphs
    layers = gpt_1b_train.config().num_hidden_layers
    for name in fa.launches:
        assert launches[name] == 2 * layers, launches
        assert captured[name] == layers, captured
        assert captured[f"{name}/tensor_cores"] == layers, captured
        assert routes[name] == {"fma": 0, "tensor_cores": 2 * layers}, routes
        assert graphs["executed_launches"][name] == layers * n_steps, graphs
    transport, pf = loader.transport, loader.prefetcher
    assert transport == "ShmQueue", transport
    assert pf.batches == fed_train.DISPATCHES and \
        pf.transfers == pf.batches, (pf.batches, pf.transfers)
    assert all(np.isfinite(fed["losses"])), fed["losses"]
    # phase 19's run_steps half: one more dispatch, profiled
    stack = [torch.from_numpy(np.stack(a)).to(dev) for a in zip(
        *(data[i] for i in range(k)))]
    ph_run = profiler.device_phases(
        lambda: step.run_steps(k, *stack, stacked=True), steps=1, warmup=0)
    peak_fed = torch.cuda.max_memory_allocated()
    del model, opt, step, loader, stack
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    model, opt, step = fed_train.build(dev)
    calls = fed_train.run_calls(step, data, dev)
    diff = fed_train.first_difference(fed_state, fed_train.snapshot(model,
                                                                    opt))
    assert fed["losses"] == calls["losses"], (fed["losses"],
                                              calls["losses"])
    assert diff is None, f"first tensor that differs: {diff}"
    ids, labels = (torch.from_numpy(a).to(dev) for a in data[0])
    ph_call = profiler.device_phases(lambda: step(ids, labels), steps=1,
                                     warmup=0)
    peak_call = torch.cuda.max_memory_allocated()
    n_state = len(fed_state)
    del model, opt, step, fed_state, ids, labels
    gc.collect()
    torch.cuda.empty_cache()

    per_step = [ms / k for ms in fed["dispatch_ms"][1:]]   # measured
    p50 = float(np.percentile(per_step, 50))
    call_p50 = float(np.percentile(calls["step_ms"][1:], 50))
    tokens = gpt_1b_train.BATCH * gpt_1b_train.SEQ
    fpt = tr["flops_per_token"]
    peak = profiler.device_peak_flops()
    res = {"phase": "fed_train", "model": "gpt_1b (bench.py bench_gpt_1b)",
           "dtype": "bfloat16", "steps_per_dispatch": k,
           "dispatches": fed_train.DISPATCHES,
           "loader": {"num_workers": fed_train.WORKERS,
                      "use_shared_memory": True, "use_device_prefetch": True,
                      "device_prefetch_depth": fed_train.DEPTH,
                      "transport": transport,
                      "h2d_copies_per_batch": pf.transfers / pf.batches},
           "losses": fed["losses"],
           "dispatch_ms": fed["dispatch_ms"],
           "run_steps_step_ms": per_step, "run_steps_step_ms_p50": p50,
           "call_step_ms": calls["step_ms"], "call_step_ms_p50": call_p50,
           "run_steps_over_call": p50 / call_p50,
           "trainstep_p50_phase7": tr["step_ms_p50"],
           "tokens_per_s": tokens / (p50 / 1e3),
           "mfu": profiler.estimate_mfu(fpt * tokens, p50 / 1e3, peak),
           "mfu_peak_flops": peak,
           "capture_s": graphs["capture_s"],
           "loader_wait_ms": fed["wait_ms"],
           "graph_key": key, "captured_launches": captured,
           "replays": replays,
           "replayed_launches": {n: captured[n] * replays
                                 for n in fa.launches},
           "executed_launches": {n: graphs["executed_launches"][n]
                                 for n in fa.launches},
           "wrapper_launches": launches, "route_launches": routes,
           "bit_identical_to_call": {"losses": True,
                                     "tensors_compared": n_state},
           "max_memory_allocated": {"run_steps": peak_fed,
                                    "call": peak_call}}
    emit(res)
    phases = {"phase": "phases", "call_step": ph_call,
              "run_steps_dispatch": ph_run, "run_steps_k": k}
    for name, ph in (("call_step", ph_call), ("run_steps_dispatch", ph_run)):
        assert ph and ph["total_device_ms"] > 0, (name, ph)
    emit(phases)
    return res


# ---------------------------------------------------------------------------
# the eager Tensor API (phase 20)
# ---------------------------------------------------------------------------
TENSOR_API_STEPS = 4
UNPADDED_SEQS = 8


def phase_tensor_api(dev):
    """Phase 20: the Tensor API's training path against the module path,
    double grad and ``flash_attn_unpadded`` against the CPU, and the
    registry's host cost per op."""
    import dataclasses
    import gc

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.testing import flash_check
    from paddle_tpu_torch.tools import gpt_1b_train
    from paddle_tpu_torch.tools import tensor_api_train as T

    gc.collect()
    torch.cuda.empty_cache()
    paddle.set_device("gpu")
    torch.backends.cuda.matmul.allow_tf32 = False    # the f32 checks
    batch = (gpt_1b_train.BATCH, gpt_1b_train.SEQ)
    res = {"phase": "tensor_api", "batch": list(batch)}

    # f32, full width, 2 layers: the FMA kernels
    cfg32 = dataclasses.replace(gpt_1b_train.config(), num_hidden_layers=2,
                                dtype="float32")
    model = T.build(cfg32, dev)
    params = T.tensor_params(model)
    ids, labels = T.batch(cfg32, *batch, dev)
    routes = fa.route_launches()
    c32 = T.compare_step0(model, params, ids, labels)
    r32 = {k: {r: n - routes[k][r] for r, n in v.items()}
           for k, v in fa.route_launches().items()}
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    assert abs(c32["loss_tensor_api"] - c32["loss_module"]) <= \
        1e-5 * abs(c32["loss_module"]), c32
    assert c32["grad_rel_l2_max"] <= 1e-4, c32
    assert all(r["fma"] > 0 and r["tensor_cores"] == 0
               for r in r32.values()), r32
    res["f32_2_layers"] = {**c32, "route_launches": r32}

    # bf16, full depth
    cfg = gpt_1b_train.config()
    torch.cuda.reset_peak_memory_stats()
    model = T.build(cfg, dev)
    params = T.tensor_params(model)
    ids, labels = T.batch(cfg, *batch, dev)
    with _PlainCalls() as plain:
        c16 = T.compare_step0(model, params, ids, labels)
        routes = fa.route_launches()
        for name in fa.launches:              # the Tensor API path starts
            fa.launches[name] = 0
        tens = T.train_tensor_api(model, params, ids, labels,
                                  TENSOR_API_STEPS)
        launches = dict(fa.launches)          # ... and ends here
        r16 = {k: {r: n - routes[k][r] for r, n in v.items()}
               for k, v in fa.route_launches().items()}
        mod = T.train_module(model, ids, labels, TENSOR_API_STEPS)
    peak = torch.cuda.max_memory_allocated()
    del model, params, ids, labels
    gc.collect()
    torch.cuda.empty_cache()
    assert abs(c16["loss_tensor_api"] - c16["loss_module"]) <= 1e-3, c16
    assert c16["grad_cosine_min"] >= 0.9999, c16
    assert all(np.isfinite(tens["losses"])) and \
        tens["losses"][-1] < tens["losses"][0], tens
    want = cfg.num_hidden_layers * TENSOR_API_STEPS
    assert all(n == want for n in launches.values()), (launches, want)
    assert all(r == {"fma": 0, "tensor_cores": want}
               for r in r16.values()), r16
    assert not any(plain.calls.values()), plain.calls
    p50 = float(np.percentile(tens["step_ms"], 50))
    mp50 = float(np.percentile(mod["step_ms"], 50))
    res["bf16_full_depth"] = {
        "layers": cfg.num_hidden_layers, "step0": c16,
        "tensor_api": tens, "module": mod, "step_ms_p50": p50,
        "module_step_ms_p50": mp50, "p50_ratio": p50 / mp50,
        "kernel_launches": launches, "route_launches": r16,
        "plain_calls": plain.calls, "max_memory_allocated": peak}

    # double grad, card against the CPU
    card = T.double_grad(paddle.CUDAPlace(0))
    cpu = T.double_grad(paddle.CPUPlace())
    dg = []
    for got, want_ in zip(card, cpu):
        scale = float(np.abs(want_).max())
        np.testing.assert_allclose(got, want_, rtol=1e-5, atol=1e-5 * scale)
        dg.append(float(np.abs(got - want_).max() / scale))
    res["double_grad"] = {"shape": [256, 512],
                          "max_abs_err_over_max": dg}

    # flash_attn_unpadded, card bf16 against the CPU in f32
    rng = np.random.default_rng(20)
    lengths = [2048, 37] + list(rng.integers(37, 2049, UNPADDED_SEQS - 2))
    q, k, v, cu = T.unpadded_case(lengths, 32, 8, 128)
    t0 = time.perf_counter()
    got = T.unpadded(q, k, v, cu, paddle.CUDAPlace(0), "bfloat16")
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = T.unpadded(*(paddle.to_tensor(a, dtype="bfloat16").astype(
        "float32").numpy() for a in (q, k, v)), cu, paddle.CPUPlace(),
        "float32")
    cpu_s = time.perf_counter() - t0
    tol = flash_check.TOL[torch.bfloat16]
    np.testing.assert_allclose(got, ref, **tol)
    res["flash_attn_unpadded"] = {
        "lengths": [int(n) for n in lengths], "heads": [32, 8],
        "head_dim": 128, "max_abs_err": float(np.abs(got - ref).max()),
        "tol": tol, "card_s": card_s, "cpu_s": cpu_s}
    res["host_cost_per_op"] = T.host_cost_per_op(dev)
    emit(res)
    gc.collect()
    torch.cuda.empty_cache()
    return res


LAYER_API_STEPS = 4
LAYER_API_DROPOUT = 0.1
LAYER_API_DROPOUT_STEPS = 2
MASK_SHAPE = (4, 2048, 2048)   # one dropout mask of the training batch
LAYER_API_DIR = "_layer_api_smoke"   # phase 21's save, under the checkout


def phase_layer_api(dev):
    """Phase 21: the layer API's Llama against the module path, trained
    with AdamW, with dropout from the global generator, saved and loaded;
    the generator's draws on the card against the CPU's."""
    import dataclasses
    import gc

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.profiler import device_phases
    from paddle_tpu_torch.tools import gpt_1b_train
    from paddle_tpu_torch.tools import layer_api_train as L
    from paddle_tpu_torch.tools import tensor_api_train as T

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    paddle.set_device("gpu")
    torch.backends.cuda.matmul.allow_tf32 = False    # the f32 checks
    batch = (gpt_1b_train.BATCH, gpt_1b_train.SEQ)
    res = {"phase": "layer_api", "batch": list(batch)}

    def fresh_pair(cfg):
        module = T.build(cfg, dev)
        model = L.build(paddle, L.from_llama_config(cfg))
        model.set_state_dict(L.layer_state_from_module(module))
        return module, model

    # f32, full width, 2 layers: the FMA kernels
    cfg32 = dataclasses.replace(gpt_1b_train.config(), num_hidden_layers=2,
                                dtype="float32")
    module, model = fresh_pair(cfg32)
    ids, labels = T.batch(cfg32, *batch, dev)
    routes = fa.route_launches()
    c32 = L.compare_step0(module, model, ids, labels)
    r32 = {k: {r: n - routes[k][r] for r, n in v.items()}
           for k, v in fa.route_launches().items()}
    del module, model
    gc.collect()
    torch.cuda.empty_cache()
    assert abs(c32["loss_layer_api"] - c32["loss_module"]) <= \
        1e-5 * abs(c32["loss_module"]), c32
    assert c32["grad_rel_l2_max"] <= 1e-4, c32
    assert all(r["fma"] > 0 and r["tensor_cores"] == 0
               for r in r32.values()), r32
    res["f32_2_layers"] = {**c32, "route_launches": r32}

    # bf16, full depth, dropout 0: step 0, then AdamW steps of each path
    cfg = gpt_1b_train.config()
    lcfg = L.from_llama_config(cfg)
    torch.cuda.reset_peak_memory_stats()
    module, model = fresh_pair(cfg)
    tids, tlabels = paddle.to_tensor(ids), paddle.to_tensor(labels)
    sync = torch.cuda.synchronize
    with _PlainCalls() as plain:
        c16 = L.compare_step0(module, model, ids, labels)
        routes = fa.route_launches()
        for name in fa.launches:              # the layer API path starts
            fa.launches[name] = 0
        lay = L.train(paddle, model, tids, tlabels, LAYER_API_STEPS,
                      sync=sync)
        launches = dict(fa.launches)          # ... and ends here
        r16 = {k: {r: n - routes[k][r] for r, n in v.items()}
               for k, v in fa.route_launches().items()}
        mod = T.train_module(module, ids, labels, LAYER_API_STEPS)
    del module
    gc.collect()
    torch.cuda.empty_cache()
    assert abs(c16["loss_layer_api"] - c16["loss_module"]) <= 1e-3, c16
    assert c16["grad_cosine_min"] >= 0.9999, c16
    assert all(np.isfinite(lay["losses"])) and \
        lay["losses"][-1] < lay["losses"][0], lay["losses"]
    want = cfg.num_hidden_layers * LAYER_API_STEPS
    assert all(n == want for n in launches.values()), (launches, want)
    assert all(r == {"fma": 0, "tensor_cores": want}
               for r in r16.values()), r16
    assert not any(plain.calls.values()), plain.calls
    opt = lay.pop("opt")
    p50 = float(np.percentile(lay["step_ms"], 50))
    mp50 = float(np.percentile(mod["step_ms"], 50))
    res["bf16_full_depth"] = {
        "layers": cfg.num_hidden_layers, "step0": c16, "layer_api": lay,
        "module": mod, "step_ms_p50": p50, "module_step_ms_p50": mp50,
        "p50_ratio": p50 / mp50, "kernel_launches": launches,
        "route_launches": r16, "plain_calls": plain.calls}

    # paddle.save / paddle.load of the bf16 state_dict, then the next step
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        LAYER_API_DIR)
    os.makedirs(root, exist_ok=True)
    try:
        sl = L.save_load_resume(paddle, model, lcfg, tids, tlabels, opt,
                                path=os.path.join(root, "model.pdparams"),
                                sync=sync)
    finally:
        os.rmdir(root)
    gc.collect()
    torch.cuda.empty_cache()
    assert not sl["missing"] and not sl["unexpected"], sl
    assert sl["bit_identical"], sl
    res["save_load"] = sl

    # one dropout mask from one generator state, on the card and the CPU
    state = paddle.get_rng_state()
    card = L.mask_draw(paddle, MASK_SHAPE, LAYER_API_DROPOUT, "gpu:0", state)
    t0 = time.perf_counter()
    host = L.mask_draw(paddle, MASK_SHAPE, LAYER_API_DROPOUT, "cpu", state)
    cpu_s = time.perf_counter() - t0
    assert torch.equal(card.cpu(), host), "card mask != CPU mask"
    ones = paddle.ones(list(MASK_SHAPE), dtype="float32")
    draw = lambda: paddle.nn.functional.dropout(  # noqa: E731
        ones, LAYER_API_DROPOUT)
    mask_ms = cuda_ms(draw, 5)
    ph = device_phases(draw, steps=1, warmup=1)
    kernels = sum(v for k, v in ph.items() if k.endswith("_ops"))
    res["dropout_mask"] = {
        "shape": list(MASK_SHAPE), "p": LAYER_API_DROPOUT,
        "card_equals_cpu": True,
        "keep_frac": float(card.float().mean()), "ms_per_mask": mask_ms,
        "kernels_per_draw": kernels, "cpu_s": cpu_s}
    del card, host, ones

    # two training steps with nn.Dropout(0.1) on, one key per dropout call
    for layer in model.sublayers():
        if isinstance(layer, paddle.nn.Dropout):
            layer.p = LAYER_API_DROPOUT
    before = paddle.get_rng_state()
    drop = L.train(paddle, model, tids, tlabels, LAYER_API_DROPOUT_STEPS,
                   opt=opt, sync=sync)
    drop.pop("opt")
    keys = paddle.get_rng_state()[1] - before[1]
    calls = (2 * cfg.num_hidden_layers + 1) * LAYER_API_DROPOUT_STEPS
    assert all(np.isfinite(drop["losses"])), drop["losses"]
    assert keys == calls, (keys, calls)
    res["dropout_train"] = {**drop, "keys_drawn": keys}
    peak = torch.cuda.max_memory_allocated()
    del model, opt, tids, tlabels, ids, labels
    gc.collect()
    torch.cuda.empty_cache()

    # initialisation: one seeded nn.Linear on the card and on the CPU
    wc, bc = L.seeded_linear(paddle, 2048, 5632)
    paddle.set_device("cpu")
    try:
        wh, bh = L.seeded_linear(paddle, 2048, 5632)
    finally:
        paddle.set_device("gpu")
    assert torch.equal(wc._data.cpu(), wh._data), "card Linear != CPU"
    assert torch.equal(bc._data.cpu(), bh._data)
    res["seeded_linear"] = {"shape": [2048, 5632], "card_equals_cpu": True}
    res["max_memory_allocated"] = peak
    res["seconds"] = time.perf_counter() - t_phase
    emit(res)
    return res


TRAINSTEP_STEPS = 4       # phase 22: run_steps(4) against 4 calls, twice
TRAINSTEP_DROPOUT_STEPS = 2


def phase_layer_trainstep(dev, fe):
    """Phase 22: the layer-API Llama through ``jit.TrainStep``: replayed
    steps against ``__call__`` steps, without and with dropout.
    ``fe``: phase 18's result (its p50s)."""
    import gc

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.tools import gpt_1b_train
    from paddle_tpu_torch.tools import layer_api_train as L
    from paddle_tpu_torch.tools import tensor_api_train as T

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    paddle.set_device("gpu")
    cfg = gpt_1b_train.config()
    ids, labels = T.batch(cfg, gpt_1b_train.BATCH, gpt_1b_train.SEQ, dev)
    tids, tlabels = paddle.to_tensor(ids), paddle.to_tensor(labels)
    sync = torch.cuda.synchronize
    routes = fa.route_launches()
    runs, launches = {}, {}
    with _PlainCalls() as plain:
        for name, dropout, steps, rounds in (
                ("dropout_0", 0.0, TRAINSTEP_STEPS, 2),
                ("dropout_0.1", LAYER_API_DROPOUT,
                 TRAINSTEP_DROPOUT_STEPS, 1)):
            r = L.replay_against_calls(
                paddle, L.from_llama_config(cfg, dropout=dropout), tids,
                tlabels, steps, rounds=rounds, sync=sync)
            del r["models"]
            gc.collect()
            torch.cuda.empty_cache()
            # the calls' launches, then the replayed step's: warm-up plus
            # captured x replays, by kernel (and by route: tensor cores)
            executed = r["graph_stats"]["executed_launches"]
            for k in r["call_launches"]:
                launches[k] = launches.get(k, 0) + r["call_launches"][k] \
                    + executed.get(k, 0)
                assert executed.get(f"{k}/tensor_cores") == \
                    executed.get(k), executed
            runs[name] = r
    r16 = {k: {r: n - routes[k][r] for r, n in v.items()}
           for k, v in fa.route_launches().items()}
    for name, r in runs.items():
        assert r["losses_bit_identical"], (name, r["call_losses"],
                                           r["replay_losses"])
        assert r["params_bit_identical"], name
        assert r["chains_equal"], name
        assert r["generator_keys"] == {"call": (1, 0),
                                       "replay": (1, 0)}, r
        assert all(np.isfinite(r["call_losses"])), r["call_losses"]
        assert r["graph_stats"]["captures"] == 1, r["graph_stats"]
    assert runs["dropout_0"]["masks_bit_identical"] is None
    assert runs["dropout_0.1"]["masks_bit_identical"], runs["dropout_0.1"]
    assert runs["dropout_0.1"]["masks_per_step"] == \
        2 * cfg.num_hidden_layers + 1
    assert runs["dropout_0"]["call_losses"][-1] < \
        runs["dropout_0"]["call_losses"][0]
    want = cfg.num_hidden_layers * 2 * (2 * TRAINSTEP_STEPS
                                        + TRAINSTEP_DROPOUT_STEPS)
    assert all(n == want for n in launches.values()), (launches, want)
    assert all(v["fma"] == 0 and v["tensor_cores"] > 0
               for v in r16.values()), r16
    assert not any(plain.calls.values()), plain.calls
    a = runs["dropout_0"]
    res = {"phase": "layer_trainstep", "layers": cfg.num_hidden_layers,
           "batch": [gpt_1b_train.BATCH, gpt_1b_train.SEQ], **runs,
           "call_step_ms_p50": float(np.percentile(a["call_step_ms"], 50)),
           "replay_step_ms_p50": float(np.percentile(a["replay_step_ms"],
                                                     50)),
           "dropout_call_step_ms_p50": float(np.percentile(
               runs["dropout_0.1"]["call_step_ms"], 50)),
           "module_call_step_ms_p50_phase18": fe["call_step_ms_p50"],
           "module_run_steps_step_ms_p50_phase18":
               fe["run_steps_step_ms_p50"],
           "kernel_launches": launches, "route_launches": r16,
           "plain_calls": plain.calls,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "seconds": time.perf_counter() - t_phase}
    del tids, tlabels, ids, labels
    gc.collect()
    torch.cuda.empty_cache()
    emit(res)
    return res


def _rank_heads(eng):
    """(query heads, kv heads, head_dim) of one rank of ``eng``: the
    model's at tp_degree 1, a k-th of the heads at tp_degree k."""
    attn = eng.model.llama.layers[0].self_attn
    return attn.n_heads, int(eng._kcs.shape[3]), int(eng._kcs.shape[4])


def _tiers_k1(dev, eng, arrays, flush):
    """K1 at one tiered step's tables (``arrays``: bt, cu, ctx,
    num_seqs of a step whose table names the host tier), on the tiered
    engine's layer-0 cache and mirror with random queries: against the
    plain version with the mirror (the ``round_to`` form in the kernel's
    splits), bit for bit against the kernel on one pool holding the same
    pages; both kernels' times and the plain version's."""
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa

    bt, cu, ctx, ns = (torch.from_numpy(a).to(dev) for a in arrays)
    ns = ns.reshape(1)
    h, kh, d = _rank_heads(eng)
    t_total = int(eng._ragged_T)
    gen = torch.Generator(device=dev).manual_seed(23)
    q = torch.randn((t_total, h, d), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    kc, vc, hk, hv = eng._kcs[0], eng._vcs[0], eng._htk[0], eng._htv[0]
    scale = d ** -0.5
    idx = (bt, cu, ctx, ns)
    out = rpa._ragged_attend_cuda(q, kc, vc, *idx, scale, hk, hv)
    one_k, one_v = torch.cat([kc, hk]), torch.cat([vc, hv])
    one = rpa._ragged_attend_cuda(q, one_k, one_v, *idx, scale)
    split, nsplit = rpa.kernel_split(q, kc, bt)
    ref = rpa._ragged_attend_ref(q, kc, vc, *idx, scale,
                                 out_dtype=torch.float32,
                                 round_to=torch.bfloat16, split=split,
                                 hkc=hk, hvc=hv)
    torch.cuda.synchronize()
    n = int(ns[0])
    live = int(cu[n])
    assert torch.equal(out, one), "the two pools and one pool differ"
    assert torch.all(out[live:] == 0)
    from paddle_tpu_torch.testing import flash_check

    max_abs_err = float((out[:live].float() - ref[:live]).abs().max())
    torch.testing.assert_close(out[:live].float(), ref[:live],
                               **flash_check.TOL[torch.bfloat16])
    ms = cuda_ms(lambda: rpa._ragged_attend_cuda(
        q, kc, vc, *idx, scale, hk, hv), 20, flush=flush)
    one_ms = cuda_ms(lambda: rpa._ragged_attend_cuda(
        q, one_k, one_v, *idx, scale), 20, flush=flush)
    plain_ms = cuda_ms(lambda: rpa._ragged_attend_ref(
        q, kc, vc, *idx, scale, round_to=torch.bfloat16, split=split,
        hkc=hk, hvc=hv), 3, flush=flush)
    cu_h, ctx_h = cu.tolist(), ctx.tolist()
    rows = [cu_h[i + 1] - cu_h[i] for i in range(n)]
    contexts = ctx_h[:n]
    nb = eng.cfg.num_blocks
    virtual = int((bt[:n] >= nb).sum())
    esz = q.element_size()
    nbytes = (live * h * d * esz + t_total * h * d * esz
              + 2 * sum(contexts) * kh * d * esz)
    flops = 0
    for r, c in zip(rows, contexts):
        flops += 4 * h * d * int(np.arange(c - r + 1, c + 1).sum())
    res = {"rows": rows, "contexts": contexts, "t_bucket": t_total,
           "virtual_entries": virtual, "split": split, "nsplit": nsplit,
           "max_abs_err": max_abs_err,
           "tolerance": "flash_check.TOL[bfloat16] vs the f32 plain "
                        "version's round_to=bfloat16 form with the mirror",
           "bit_identical_to_one_pool": True, "ms": ms,
           "one_pool_ms": one_ms, "plain_ms": plain_ms,
           **_bound(nbytes, flops), "library_ms": None}
    del one_k, one_v
    return res


def _step_k1(dev, eng, arrays, flush):
    """K1 at one recorded step's tables (``arrays``: bt, cu, ctx,
    num_seqs) on an untiered engine's layer-0 cache with random queries:
    against the plain version (the ``round_to`` form in the kernel's
    splits); the kernel's time and the plain version's."""
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    from paddle_tpu_torch.testing import flash_check

    bt, cu, ctx, ns = (torch.from_numpy(a).to(dev) for a in arrays)
    ns = ns.reshape(1)
    h, kh, d = _rank_heads(eng)
    t_total = int(eng._ragged_T)
    gen = torch.Generator(device=dev).manual_seed(26)
    q = torch.randn((t_total, h, d), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    kc, vc = eng._kcs[0], eng._vcs[0]
    scale = d ** -0.5
    idx = (bt, cu, ctx, ns)
    out = rpa._ragged_attend_cuda(q, kc, vc, *idx, scale)
    split, nsplit = rpa.kernel_split(q, kc, bt)
    ref = rpa._ragged_attend_ref(q, kc, vc, *idx, scale,
                                 out_dtype=torch.float32,
                                 round_to=torch.bfloat16, split=split)
    torch.cuda.synchronize()
    n = int(ns[0])
    live = int(cu[n])
    assert torch.all(out[live:] == 0)
    max_abs_err = float((out[:live].float() - ref[:live]).abs().max())
    torch.testing.assert_close(out[:live].float(), ref[:live],
                               **flash_check.TOL[torch.bfloat16])
    ms = cuda_ms(lambda: rpa._ragged_attend_cuda(q, kc, vc, *idx, scale),
                 20, flush=flush)
    plain_ms = cuda_ms(lambda: rpa._ragged_attend_ref(
        q, kc, vc, *idx, scale, round_to=torch.bfloat16, split=split), 3,
        flush=flush)
    cu_h, ctx_h = cu.tolist(), ctx.tolist()
    rows = [cu_h[i + 1] - cu_h[i] for i in range(n)]
    contexts = ctx_h[:n]
    esz = q.element_size()
    nbytes = (live * h * d * esz + t_total * h * d * esz
              + 2 * sum(contexts) * kh * d * esz)
    flops = 0
    for r, c in zip(rows, contexts):
        flops += 4 * h * d * int(np.arange(c - r + 1, c + 1).sum())
    return {"rows": rows, "contexts": contexts, "t_bucket": t_total,
            "split": split, "nsplit": nsplit, "max_abs_err": max_abs_err,
            "tolerance": "flash_check.TOL[bfloat16] vs the f32 plain "
                         "version's round_to=bfloat16 form",
            "ms": ms, "plain_ms": plain_ms, **_bound(nbytes, flops),
            "library_ms": None}


def phase_tiers(dev):
    """Phase 23: tiered KV serving at Llama-3-8B: a request past the
    device pool, and parked sessions resumed."""
    import gc

    from paddle_tpu_torch.tools import llama3_8b_serve
    from paddle_tpu_torch.tools import llama3_8b_tiers as TT

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev).zero_
    model = llama3_8b_serve.target_model(dev)
    with _PlainCalls() as plain:
        op = TT.over_pool(model)
    r = op["result"]
    eng = op["engine"]
    assert r["finish_reason"] == "length" and r["new_tokens"] == 32, r
    assert r["num_demotes"] > 0, r
    assert r["mirror_steps"] > 0 and op["mirror"].first is not None, r
    assert r["tokens_identical"], r
    assert r["preemptions"] == 0, r
    window = op["window"]
    assert _k1(window) > 0, window
    k1 = _tiers_k1(dev, eng, op["mirror"].first, flush)
    over = {**r, "captures": window["captures"],
            "capture_s": window["capture_s"],
            "replays": window["replays"], "kernel_launches": _k1(window),
            "k1_mirror_step": k1}
    del op, eng, window
    gc.collect()
    torch.cuda.empty_cache()
    with _PlainCalls() as plain2:
        se = TT.sessions(model)
    r = se["result"]
    window = se["window"]
    assert r["resume_hits_equal_parked"], r
    assert r["num_resume_recomputed_tokens"] == 0, r
    assert r["kv_tier_park_resumes"] == TT.SESSIONS, r
    assert r["resumed_chain_bytes_equal"], r
    assert r["turn2_mirror_steps"] > 0, r
    assert all(d > 0 for d in r["parked_demoted"]), r
    assert _k1(window) > 0, window
    assert not any(plain.calls.values()) and \
        not any(plain2.calls.values()), (plain.calls, plain2.calls)
    sess = {**r, "captures": window["captures"],
            "replays": window["replays"], "kernel_launches": _k1(window)}
    # bf16: a cold run computes the turn-1 tokens' K/V in prefill chunks
    # where the session computed them in its turn-1 steps (reported)
    del se, window
    gone = _freed(model)
    del model, flush
    gc.collect()
    assert not any(g() for g in gone), "the 8B model outlived its refs"
    torch.cuda.empty_cache()
    res = {"phase": "tiers", "model": "llama3_8b", "dtype": "bfloat16",
           "engine": TT.ENGINE, "over_pool": over, "sessions": sess,
           "kernel_launches": over["kernel_launches"]
           + sess["kernel_launches"],
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "seconds": time.perf_counter() - t_phase}
    emit(res)
    return res


def _scaled_err(got, want):
    """max |got - want| / max |want| (1 where want is all zero)."""
    scale = float(np.abs(want).max()) if want.size else 0.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    return err / (scale if scale > 0 else 1.0)


def _long_tail_sweep():
    """Every long-tail case on the card against the CPU."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.tools import long_tail_cases as LC

    out, failed = {}, {}
    for case in LC.CASES:
        t0 = time.perf_counter()
        try:
            paddle.set_device("gpu")
            got, ggot, sgot = LC.run_case(case, paddle.CUDAPlace(0))
            torch.cuda.synchronize()
            card_ms = (time.perf_counter() - t0) * 1e3
            paddle.set_device("cpu")
            want, gwant, swant = LC.run_case(case, paddle.CPUPlace())
        except Exception as e:      # recorded; the sweep fails at its end
            failed[case.id] = [repr(e)[:600]]
            continue
        finally:
            paddle.set_device("gpu")
        bad, err, gerr = LC.compare(case, (got, ggot, sgot),
                                    (want, gwant, swant))
        if bad:
            failed[case.id] = bad
        out[case.id] = {"max_abs_err": err, "grad_max_abs_err": gerr,
                        "card_ms": card_ms}
    assert not failed, json.dumps(failed)[:20000]
    return out


def _long_tail_sizes(dev):
    """The ops at published sizes: card time and memory, CPU check at a
    reduced batch."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.tools import long_tail_sizes as LS

    out, failed = {}, {}
    for name, spec in LS.WORKLOADS.items():
        paddle.set_device("gpu")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        full = spec["make"](spec["full"], paddle.CUDAPlace(0))
        ms = cuda_ms(lambda: LS.forward_backward(full), 3)
        peak = torch.cuda.max_memory_allocated() - base
        del full
        small = spec["make"](spec["check"], paddle.CUDAPlace(0))
        got = LS.numpy(LS.forward_backward(small))
        paddle.set_device("cpu")
        t0 = time.perf_counter()
        small_cpu = spec["make"](spec["check"], paddle.CPUPlace())
        want = LS.numpy(LS.forward_backward(small_cpu))
        cpu_s = time.perf_counter() - t0
        paddle.set_device("gpu")
        errs = {}
        rtol, share = spec.get("tol", LS.TOL)
        for key in want:
            a, b = got[key], want[key]
            scale = float(np.abs(b).max())
            try:
                np.testing.assert_allclose(a, b, rtol=rtol,
                                           atol=share * scale)
            except AssertionError as e:
                failed[f"{name} {key}"] = str(e)[:600]
            errs[key] = _scaled_err(a, b)
        out[name] = {"full": spec["full"], "check": spec["check"],
                     "tol": [rtol, share],
                     "ms_fwd_bwd": ms, "peak_bytes": peak,
                     "check_err_over_max": errs, "check_cpu_s": cpu_s}
        del small, small_cpu
        torch.cuda.empty_cache()
    assert not failed, json.dumps(failed)
    return out


QKV_PACKED = (4, 2048, 16, 128)     # B, S, H, D: phase 6's training shape


def _packed_flash(dev):
    """``flash_attn_qkvpacked`` through K2-K4 (counted), bit-identical to
    ``F.flash_attention`` on the unpacked tensors; the varlen wrapper
    against ``flash_attn_unpadded``."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.testing import flash_check

    paddle.set_device("gpu")
    b, s, h, d = QKV_PACKED
    gen = torch.Generator(device=dev).manual_seed(24)
    qkv_d = torch.randn((b, s, 3, h, d), generator=gen, device=dev,
                        dtype=torch.float32).to(torch.bfloat16)
    do_d = torch.randn((b, s, h, d), generator=gen, device=dev,
                       dtype=torch.float32).to(torch.bfloat16)
    qkv = paddle.to_tensor(qkv_d, stop_gradient=False)
    for name in fa.launches:          # phase 24's path starts here
        fa.launches[name] = 0
    with _PlainCalls() as plain:
        out, _ = F.flash_attn_qkvpacked(qkv, causal=True)
        out.backward(paddle.to_tensor(do_d))
        torch.cuda.synchronize()
    launches = dict(fa.launches)      # ... and ends here
    assert launches == {"flash_attention_fwd": 1,
                        "flash_attention_bwd_dq": 1,
                        "flash_attention_bwd_dkv": 1}, launches
    assert not any(plain.calls.values()), plain.calls
    g = qkv.grad._data
    assert tuple(g.shape) == (b, s, 3, h, d), g.shape
    # the same kernels on the unpacked q, k, v
    parts = [paddle.to_tensor(qkv_d[:, :, i].contiguous(),
                              stop_gradient=False) for i in range(3)]
    ref, _ = F.flash_attention(*parts, causal=True)
    ref.backward(paddle.to_tensor(do_d))
    identical = bool(torch.equal(out._data, ref._data)) and all(
        torch.equal(g[:, :, i], parts[i].grad._data) for i in range(3))
    assert identical
    q, k, v = (qkv_d[:, :, i].contiguous() for i in range(3))
    scale = d ** -0.5
    _, lse = fa._flash_fwd_cuda(q, k, v, scale, True)
    rep = flash_check.check(q, k, v, do_d, {
        "o": out._data.detach(), "lse": lse,
        "dq": g[:, :, 0].contiguous(), "dk": g[:, :, 1].contiguous(),
        "dv": g[:, :, 2].contiguous()}, scale, True)
    t_ms = cuda_ms(lambda: F.flash_attn_qkvpacked(qkv, causal=True), 3)
    # varlen: packed rows of 4 sequences against flash_attn_unpadded
    lens = [2048, 37, 1000, 513]
    cu = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    vq = torch.randn((int(cu[-1]), 3, h, d), generator=gen, device=dev,
                     dtype=torch.float32).to(torch.bfloat16)
    vt = paddle.to_tensor(vq)
    cut = paddle.to_tensor(cu)
    vo, _ = F.flash_attn_varlen_qkvpacked(vt, cut, cut, max(lens),
                                          max(lens), causal=True)
    uo, _ = F.flash_attn_unpadded(*(paddle.to_tensor(vq[:, i].contiguous())
                                    for i in range(3)), cut, cut, max(lens),
                                  max(lens), scale=scale, causal=True)
    varlen_identical = bool(torch.equal(vo._data, uo._data))
    assert varlen_identical
    return {"shape": [b, s, 3, h, d], "dtype": "bfloat16", "causal": True,
            "kernel_launches": launches, "plain_calls": plain.calls,
            "bit_identical_to_flash_attention": identical,
            "flash_check": {"max_abs_err": rep["max_abs_err"],
                            "outside_plain_tol": rep["outside_plain_tol"],
                            "tolerance": rep["tolerance"]},
            "fwd_ms": t_ms, "varlen_lengths": lens,
            "varlen_bit_identical_to_unpadded": varlen_identical}


def phase_long_tail(dev):
    """Phase 24: the long tail of the manifest, the nn long tail, the
    packed flash wrappers and a DeepSpeech2-widths CTC model."""
    import gc

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.tools import ds2_ctc_train as D

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {"phase": "long_tail"}
    errors = {}

    def section(name, fn):
        # every section runs; the phase fails at its end if one did
        t0 = time.perf_counter()
        try:
            res[name] = fn()
        except Exception as e:
            errors[name] = repr(e)[:20000]
        res[name + "_s"] = time.perf_counter() - t0

    def ds2():
        gc.collect()
        torch.cuda.empty_cache()
        paddle.set_device("gpu")
        torch.cuda.reset_peak_memory_stats()
        model, loss_fn = D.build(paddle)
        tr = D.train(paddle, model, loss_fn, D.batch(), 4,
                     place=paddle.CUDAPlace(0), sync=torch.cuda.synchronize)
        peak = torch.cuda.max_memory_allocated()
        del model, loss_fn
        gc.collect()
        torch.cuda.empty_cache()
        cc = D.card_against_cpu(paddle)
        paddle.set_device("gpu")
        out = {"gru": [D.INPUT, D.HIDDEN, D.LAYERS, "bidirect"],
               "classes": D.CLASSES, "batch": [D.BATCH, D.FRAMES], **tr,
               "step_ms_p50": float(np.percentile(tr["step_ms"], 50)),
               "max_memory_allocated": peak, "card_against_cpu": cc}
        assert all(np.isfinite(tr["losses"])), out
        assert tr["losses"][-1] < tr["losses"][0], out
        assert cc["loss_rel_err"] <= 1e-4, out
        assert cc["grad_rel_l2_max"] <= 1e-4, out
        return out

    section("sweep", _long_tail_sweep)
    res["sweep_cases"] = len(res.get("sweep", {}))
    section("sizes", lambda: _long_tail_sizes(dev))
    section("qkvpacked", lambda: _packed_flash(dev))
    section("ds2", ds2)
    if errors:
        emit({**res, "errors": errors})
        raise AssertionError(f"phase 24 failed: {sorted(errors)}")
    res["kernel_launches"] = res["qkvpacked"]["kernel_launches"]
    res["seconds"] = time.perf_counter() - t_phase
    emit(res)
    return res


# ---------------------------------------------------------------------------
# slice E2a and the high-level API: BERT-base through hapi.Model
# ---------------------------------------------------------------------------
BERT_CPU_RTOL = 1e-4   # phase 33 (a): the card against the CPU, f32


def phase_bert(dev):
    """Phase 33: BERT-base through ``Model.fit`` / ``evaluate`` /
    ``predict`` and ``jit.TrainStep``; no K1-K4 launch on its path."""
    import tempfile

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.profiler import device_peak_flops
    from paddle_tpu_torch.tools import bert_base_train as B

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    sync = torch.cuda.synchronize
    peak = device_peak_flops()
    res = {"phase": "bert", "peak_flops": peak}
    before = ops.kernel_launches()
    with _PlainCalls() as plain:
        t0 = time.perf_counter()
        cc = B.card_against_cpu(paddle)
        res["a_card_against_cpu"] = {**cc, "seconds": time.perf_counter()
                                     - t0}
        paddle.set_device("gpu")
        # (b) fine-tuning through Model.fit, bf16 autocast, full depth
        t0 = time.perf_counter()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with tempfile.TemporaryDirectory(prefix="bert_ft_") as d:
            ft = B.finetune(paddle, save_dir=d, sync=sync)
        ft["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        ft.pop("logits")
        ft_stats = ft.pop("model")._train_step.graph_stats()
        p50 = float(np.percentile(ft["step_ms"][1:], 50))
        tps = B.BATCH * B.SEQ / (p50 / 1e3)
        res["b_finetune"] = {
            **ft, "graph_stats": ft_stats, "step_ms_p50": p50,
            "tokens_per_s": tps, "n_gemm": B.N_GEMM,
            "flops_per_token_formula": "6 * N_gemm + 12 * L * S * h",
            "mfu": ft["flops_per_token"] * tps / peak,
            "seconds": time.perf_counter() - t0}
        # (c) masked-LM pre-training through jit.TrainStep, 16 x 512
        t0 = time.perf_counter()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mlm = B.mlm_replay(paddle, sync=sync)
        mlm["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        del mlm["model"], mlm["step"]
        gc.collect()
        torch.cuda.empty_cache()
        mp50 = float(np.percentile(mlm["replay_step_ms"], 50))
        mtps = B.MLM_BATCH * B.MLM_SEQ / (mp50 / 1e3)
        masks = B.mask_ms()
        res["c_mlm"] = {
            **mlm, "step_ms_p50": mp50, "tokens_per_s": mtps,
            "n_gemm": B.N_GEMM + B.N_DECODER,
            "mfu": mlm["flops_per_token"] * mtps / peak,
            "dropout_masks": {**masks, "share_of_step": masks["ms"] / mp50},
            "seconds": time.perf_counter() - t0}
    after = ops.kernel_launches()
    launches = {k: after.get(k, 0) - before.get(k, 0)
                for k in ("ragged_paged_attention", "flash_attention_fwd",
                          "flash_attention_bwd_dq",
                          "flash_attention_bwd_dkv")}
    res["kernel_launches"] = launches
    res["plain_calls"] = plain.calls
    res["seconds"] = time.perf_counter() - t_phase
    emit(res)
    cc, ft, mlm = res["a_card_against_cpu"], res["b_finetune"], res["c_mlm"]
    assert cc["loss_rel_err_max"] <= BERT_CPU_RTOL, cc
    assert cc["acc_card"] == cc["acc_cpu"], cc
    assert cc["logits_rel_err_max"] <= BERT_CPU_RTOL, cc
    assert all(np.isfinite(ft["losses"])) and \
        np.isfinite(ft["evaluate"]["loss"]), ft
    assert ft["reload_bit_identical"], ft
    assert ft["files"] == ["0.pdopt", "0.pdparams", "final.pdopt",
                           "final.pdparams"], ft["files"]
    assert ft["graph_stats"]["captures"] == 1 and \
        sum(ft["graph_stats"]["replays"].values()) == \
        B.FINETUNE_BATCHES - 1, ft["graph_stats"]
    assert all(np.isfinite(mlm["call_losses"])), mlm
    assert mlm["losses_bit_identical"] and mlm["params_bit_identical"], mlm
    assert mlm["graph_stats"]["captures"] == 1, mlm["graph_stats"]
    assert not any(launches.values()), launches
    assert not any(plain.calls.values()), plain.calls
    return res


# ---------------------------------------------------------------------------
# tensor-parallel serving, both ranks on this card
# ---------------------------------------------------------------------------
def phase_tp(dev, serve, serve_rows):
    """Phase 25 (see the module docstring). ``serve`` is phase 4's result
    (its tokens and times), ``serve_rows`` its greedy logit rows."""
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    from paddle_tpu_torch.tools import llama3_8b_serve
    from paddle_tpu_torch.tools import llama3_8b_tp as TPC

    gen = torch.Generator(device=dev).manual_seed(25)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev).zero_
    h, kh = 32 // TPC.TP, 8 // TPC.TP
    k1 = _ragged_case(_ragged_batch(dev, gen, MIXED_LIVE, 8, 128, 1024, 37,
                                    h=h, kh=kh), MIXED_LIVE, flush)
    k1["heads"] = {"query": h, "kv": kh, "head_dim": 128}
    del flush
    t0 = time.perf_counter()
    parity = TPC.f32_parity(dev)
    parity["seconds"] = time.perf_counter() - t0
    assert parity["token_identical"], parity
    assert parity["backend"] == "gloo", parity
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    eng = TPC.engine(TPC.model(dev))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    tp = eng._tp
    llama3_8b_serve.warm_up(eng)
    tp.report(reset=True)                 # rank 1's counts set to 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    rids, _ = llama3_8b_serve.add_requests(eng)
    step_ms = []
    with _GreedyRows(eng, rids[:-1]) as rows:
        rpa.launches = 0                  # the main path starts here
        t1 = time.perf_counter()
        while eng.has_unfinished():
            t2 = time.perf_counter()
            eng.step()
            step_ms.append((time.perf_counter() - t2) * 1e3)
            rows.after_step()
            assert len(step_ms) < 1000, "engine failed to converge"
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        k1_rank0 = rpa.launches           # the main path ends here
    (rank1,) = tp.report()
    steps = eng.metrics.engine_steps
    layers = eng.model.config.num_hidden_layers
    # uncaptured: every step launches K1 once a layer on each rank
    assert k1_rank0 == rank1["k1_launches"] == layers * steps, (
        k1_rank0, rank1, steps)
    tokens = {rid: list(eng.get_request(rid).generated) for rid in rids}
    gen_tokens = sum(len(v) for v in tokens.values())
    assert gen_tokens == len(rids) * llama3_8b_serve.MAX_NEW_TOKENS
    for v in tokens.values():
        assert all(0 <= t < eng.model.config.vocab_size for t in v)
    m = eng.metrics
    greedy = rids[:-1]
    res = {"phase": "tp", "model": "llama3_8b", "dtype": "bfloat16",
           "tp_degree": TPC.TP,
           "placement": "both ranks on cuda:0 through the testing hook "
                        "paddle_tpu_torch.testing.tp_hooks."
                        "ranks_share_one_device",
           "device_backend": tp.backend, "handoff_s": tp.handoff_s,
           "setup_s": setup_s, "k1_per_rank_shape": k1,
           "f32_parity": parity,
           "max_memory_allocated": {
               "rank0": torch.cuda.max_memory_allocated(dev),
               "rank1": rank1["max_memory_allocated"]},
           "kernel_launches": {"rank0": k1_rank0,
                               "rank1": rank1["k1_launches"]},
           "steps": steps, "step_ms": step_ms, "wall_s": wall,
           "tokens_per_s": gen_tokens / wall,
           "tpot_ms_p50": float(np.percentile(m.tpots_s, 50) * 1e3),
           "ttft_ms_p50": float(np.percentile(m.ttfts_s, 50) * 1e3),
           "tp1": {"tokens_per_s": serve["tokens_per_s"],
                   "tpot_ms_p50": serve["tpot_ms_p50"],
                   "ttft_ms_p50": serve["ttft_ms_p50"]},
           "note": "two ranks share one card: no TP speed is measured; "
                   "tp1 is phase 4 (captured graphs), the TP step runs "
                   "uncaptured",
           "greedy_equal_to_tp1": sum(
               tokens[r] == serve["tokens"][r] for r in greedy),
           "greedy_divergence_rows": _divergences(
               serve_rows, serve["tokens"], rows.rows,
               {r: tokens[r] for r in greedy}, names=("tp1", "tp2"))}
    emit(res)
    gone = [weakref.ref(x) for x in (eng, eng.model)]
    procs = list(tp._procs)
    del eng, tp, rows
    assert not any(r() for r in gone), "the TP engine outlived its refs"
    assert not any(p.is_alive() for p in procs), "a TP worker outlived it"
    torch.cuda.empty_cache()
    return res


def phase_fleet(dev, serve, beside=None):
    """Phase 26 (see the module docstring). ``serve`` is phase 4's result
    (its tokens and times); ``beside`` is called once (b) has timed its
    kernel, before the worker processes start (phase 32's launches start
    there)."""
    import gc

    from paddle_tpu_torch.tools import llama3_8b_fleet as FL
    from paddle_tpu_torch.tools import llama3_8b_serve

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    # (a) f32, 2 of 32 layers: three fleets against one engine
    t0 = time.perf_counter()
    one_engine = {}
    with _PlainCalls() as plain:
        ident = FL.f32_identity(FL.model(dev, "float32", FL.PARITY_LAYERS),
                                one_engine)
    for name, r in ident.items():
        assert r["tokens_identical"] == r["requests"] == 8, (name, r)
        assert r["finished_once"] and r["finish"] == {"length": 8}, r
    assert ident["prefill_decode"]["kv_ship_requests"] == 8, ident
    assert ident["prefill_decode"]["tokens_recomputed"] == 0, ident
    assert ident["drain"]["drained"] == ["a"], ident
    assert ident["drain"]["handoffs"] >= 1, ident
    ident["seconds"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()

    # (b) bf16, full depth: the prefill/decode fleet on phase 4's model
    t0 = time.perf_counter()
    model = llama3_8b_serve.target_model(dev)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev).zero_
    with _PlainCalls() as plain2:
        dg = FL.disagg(model)
    r = dg["result"]
    assert r["finished_once"], r
    assert r["ships"] == llama3_8b_serve.NUM_REQUESTS, r
    assert r["recompute_fallbacks"] == 0 and r["tokens_recomputed"] == 0, r
    assert all(n > 0 for n in r["k1_launches"].values()), r
    assert not any(plain.calls.values()) and \
        not any(plain2.calls.values()), (plain.calls, plain2.calls)
    first = dg["first_after_import"].first
    assert first is not None
    dec = dg["replicas"][1].engine
    k1 = _step_k1(dev, dec, first, flush)
    tokens = r.pop("tokens")
    greedy = [f"r{i}" for i in range(llama3_8b_serve.NUM_REQUESTS - 1)]
    r["greedy_equal_to_serve"] = sum(
        tokens[g] == serve["tokens"][g] for g in greedy)
    # reported, not asserted: the decode replica's batches differ from
    # phase 4's, so its bf16 sums round differently at near-ties
    r["greedy_first_divergence"] = {
        g: next((i for i, (x, y) in enumerate(zip(tokens[g],
                                                  serve["tokens"][g]))
                 if x != y), None) for g in greedy}
    r["serve"] = {k: serve[k] for k in ("ttft_ms_p50", "tpot_ms_p50",
                                        "tokens_per_s")}
    r["tokens_per_s"] = r["generated_tokens"] / r["wall_s"]
    r["k1_first_after_import"] = k1
    r["seconds"] = time.perf_counter() - t0
    gone = _freed(model, dec)
    del dg, dec, model, flush
    gc.collect()
    assert not any(g() for g in gone), "the 8B fleet outlived its refs"
    torch.cuda.empty_cache()

    # (c) two worker processes over 4 of 32 layers in f32, and beside
    # them (d) one worker at tp_degree=2, f32, 2 of 32 layers, then a
    # SIGKILL: (d) runs on a thread of this process that only drives its
    # worker (no work on the card here), so that the start-ups overlap
    if beside is not None:
        beside()

    def tp_worker():
        t = time.perf_counter()
        out = FL.tp_worker(one_engine, dev)
        out["seconds"] = time.perf_counter() - t
        return out

    tp = _Beside(tp_worker)
    tp.start()
    t0 = time.perf_counter()
    try:
        wk = FL.workers(FL.model(dev, "float32", FL.WORKER_LAYERS))
        wk["seconds"] = time.perf_counter() - t0
    finally:
        tw = tp.result()
    assert wk["tokens_identical"] == wk["requests"] == 8, wk
    assert wk["finished_once"] and wk["finish"] == {"length": 8}, wk
    assert wk["victim_sigkilled"] and wk["replicas_dead"] == 1, wk
    assert wk["workers_exited"], wk
    assert wk["peer"]["ships"] >= 1 and wk["peer"]["relay_bytes"] == 0, wk
    assert wk["tickets_issued"] == sum(wk["ticket_outcomes"].values()), wk
    torch.cuda.empty_cache()
    res = {"phase": "fleet", "model": "llama3_8b", "engine": FL.ENGINE,
           "f32_identity": ident, "disagg_bf16": r, "workers": wk,
           "tp_worker": tw,
           "kernel_launches": sum(r["k1_launches"].values()),
           "seconds": time.perf_counter() - t_phase}
    emit(res)
    # (d)'s checks, after the numbers are out
    assert tw["tokens_identical"] == tw["requests"] == 8, tw
    assert tw["finished_once"], tw
    k1 = tw["k1_launches_per_rank"]
    assert len(k1) == 2 and k1[0] == k1[1] > 0, tw
    assert all(tw["ranks_alive_before_kill"]) and tw["worker_sigkilled"], tw
    assert tw["ranks_alive_after"] == [] and \
        tw["ranks_gone_s"] <= FL.RANK_EXIT_S, tw
    return res


class _FirstVerifyStep:
    """Keeps the index arrays ``(bt, cu, ctx, num_seqs)`` of the engine's
    first ragged step that verifies drafts (a row of 1 + d tokens
    mid-context)."""

    def __init__(self, eng):
        self.first = None
        self._eng = eng
        inner = eng._dispatch

        def dispatch(reqs, key, arrays):
            if self.first is None and any(r.draft_tokens for r in reqs):
                self.first = tuple(np.array(a) for a in arrays[1:5])
            return inner(reqs, key, arrays)

        eng._dispatch = dispatch

    def close(self):
        self._eng.__dict__.pop("_dispatch", None)
        self._eng = None


def _tp_f32_cases(dev):
    """Phase 27 (a): f32 at 2 of the 32 layers, each case token-identical
    to one rank on the same weights."""
    from paddle_tpu_torch.tools import llama3_8b_tiers as TT
    from paddle_tpu_torch.tools import llama3_8b_tp as TPC

    t0 = time.perf_counter()
    with _PlainCalls() as plain:
        ships = TPC.ships_and_handoff(dev)
    n = len(ships["tp1_to_tp2"]["export_ms"])
    for name in ("tp1_to_tp2", "tp2_to_tp1", "handoff_clean",
                 "handoff_fault"):
        r = ships[name]
        assert r["tokens_identical"] == r["requests"] == n, (name, r)
    for name in ("tp1_to_tp2", "tp2_to_tp1"):
        r = ships[name]
        # every ship a reshard, one prompt token computed a request
        assert r["reshards"] == r["ships"] == n, (name, r)
        assert r["computed_prompt_tokens"] == n, (name, r)
    for name in ("handoff_clean", "handoff_fault"):
        r = ships[name]
        assert r["finished_once"] and r["finish"] == {"length": n}, r
        assert r["ships"] >= 1 and r["reshards"] == r["ships"], r
    clean, fault = ships["handoff_clean"], ships["handoff_fault"]
    assert clean["tokens_recomputed"] == 0, clean
    assert clean["recompute_fallbacks"] == 0, clean
    assert fault["recompute_fallbacks"] >= 1, fault
    assert ships["workers_exited"], ships
    ships["seconds"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    op = TT.over_pool(TPC.model(dev, "float32", TPC.PARITY_LAYERS),
                      tp=TPC.TP, reference=(TPC.model(
                          dev, "float32", TPC.PARITY_LAYERS), 1))
    tiers = op["result"]
    assert tiers["tokens_identical"], tiers
    assert tiers["new_tokens"] == TT.MAX_NEW_TOKENS, tiers
    assert tiers["num_demotes"] > 0 and tiers["mirror_steps"] > 0, tiers
    tiers["seconds"] = time.perf_counter() - t0
    del op
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    with _PlainCalls() as plain2:
        spec = TPC.spec_parity(dev)
    assert spec["token_identical"], spec
    assert spec["tp2"]["draft_is_a_copy"], spec
    for key in ("proposed", "accepted"):
        assert spec["tp1"][key] == spec["tp2"][key], spec
    assert spec["tp2"]["accepted"] > 0, spec      # draft = target
    spec["seconds"] = time.perf_counter() - t0
    assert not any(plain.calls.values()) and \
        not any(plain2.calls.values()), (plain.calls, plain2.calls)
    torch.cuda.empty_cache()
    return {"ships": ships, "tiers": tiers, "spec": spec}


def _rank_counts(eng, window, reports) -> dict:
    """K1 and K2 launches by rank over a path: rank 0's from its step
    window (``executed_launches``), the workers' from ``reports``."""
    ex = window["executed_launches"]
    return {"rank0": {"k1": ex.get("ragged_paged_attention", 0),
                      "k2": ex.get("flash_attention_fwd", 0)},
            **{f"rank{w['rank']}": {"k1": w["k1_launches"],
                                    "k2": w["k2_launches"]}
               for w in reports}}


# phase 27 (b)'s depth: its bf16 8B engines run this many of the 32
# layers (widths not cut), so that chip_smoke.py keeps inside its time
# limit
TP_FEATURES_LAYERS = 2


def phase_tp_features(dev, serve, serve_rows, fleet, spec9, after_f32=None):
    """Phase 27 (see the module docstring). ``serve`` is phase 4's result
    (its tokens and times) and ``serve_rows`` its greedy logit rows;
    ``fleet`` and ``spec9`` are phases 26 and 9's, beside which the tp 2
    numbers are reported (None: not reported, when the phase runs
    alone); ``after_f32`` is called once (a) is done, before (b) times
    any kernel (it waits for phase 32's launches)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    from paddle_tpu_torch.tools import llama3_8b_fleet as FL
    from paddle_tpu_torch.tools import llama3_8b_serve
    from paddle_tpu_torch.tools import llama3_8b_tiers as TT
    from paddle_tpu_torch.tools import llama3_8b_tp as TPC

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    f32 = _tp_f32_cases(dev)
    if after_f32 is not None:
        after_f32()
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev).zero_
    greedy = [f"r{i}" for i in range(llama3_8b_serve.NUM_REQUESTS - 1)]
    peaks = {}

    # (b) bf16 at TP_FEATURES_LAYERS of the 32 layers: the prefill/decode
    # pair, decode at tp 2
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    model = llama3_8b_serve.target_model(dev, TP_FEATURES_LAYERS)
    with _PlainCalls() as plain:
        dg = FL.disagg(model, decode=(llama3_8b_serve.target_model(
            dev, TP_FEATURES_LAYERS), TPC.TP))
    d = dg["result"]
    assert d["finished_once"], d
    assert d["ships"] == llama3_8b_serve.NUM_REQUESTS, d
    assert d["recompute_fallbacks"] == 0 and d["tokens_recomputed"] == 0, d
    k1d = d["k1_launches_by_rank"]
    assert k1d["decode"][0] == k1d["decode"][1] > 0, k1d
    tokens = d.pop("tokens")
    d["greedy_equal_to_serve"] = sum(tokens[g] == serve["tokens"][g]
                                     for g in greedy)
    d["greedy_first_divergence"] = {
        g: next((i for i, (x, y) in enumerate(zip(tokens[g],
                                                  serve["tokens"][g]))
                 if x != y), None) for g in greedy}
    d["tokens_per_s"] = d["generated_tokens"] / d["wall_s"]
    d["fleet_tp1"] = fleet and {k: fleet["disagg_bf16"][k] for k in (
        "ttft_ms_p50", "tpot_ms_p50", "tokens_per_s", "export_ms_p50",
        "import_ms_p50", "gather_ms_p50", "scatter_ms_p50")}
    d["serve"] = {k: serve[k] for k in ("ttft_ms_p50", "tpot_ms_p50",
                                        "tokens_per_s")}
    d["seconds"] = time.perf_counter() - t0
    peaks["disagg"] = {"rank0": torch.cuda.max_memory_allocated(dev),
                       "rank1": d["worker_max_memory_allocated"]["decode"]}
    procs = list(dg["replicas"][1].engine._tp._procs)
    gone = _freed(model, dg["replicas"][1].engine)
    del dg, model
    gc.collect()
    assert not any(g() for g in gone), "the tp 2 fleet outlived its refs"
    assert not any(p.is_alive() for p in procs), "a TP worker outlived it"
    torch.cuda.empty_cache()

    # the tiers: 3000 + 32 tokens on 64 device + 512 host blocks at tp 2
    # against an untiered tp 2 engine (the same bf16 sums: identical)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    with _PlainCalls() as plain2:
        op = TT.over_pool(
            llama3_8b_serve.target_model(dev, TP_FEATURES_LAYERS),
            tp=TPC.TP, reference=(llama3_8b_serve.target_model(
                dev, TP_FEATURES_LAYERS), TPC.TP))
    ti = op["result"]
    eng = op["engine"]
    assert ti["finish_reason"] == "length", ti
    assert ti["tokens_identical"], ti
    assert ti["num_demotes"] > 0 and ti["mirror_steps"] > 0, ti
    assert op["mirror"].first is not None
    (w1,) = eng._tp.report()
    ti["kernel_launches"] = _rank_counts(eng, op["window"], [w1])
    assert ti["kernel_launches"]["rank0"]["k1"] == w1["k1_launches"] > 0, ti
    ti["k1_mirror_step"] = _tiers_k1(dev, eng, op["mirror"].first, flush)
    ti["seconds"] = time.perf_counter() - t0
    peaks["tiers"] = {"rank0": torch.cuda.max_memory_allocated(dev),
                      "rank1": w1["max_memory_allocated"]}
    procs = list(eng._tp._procs) + list(op["untiered"]._tp._procs)
    gone = _freed(eng, op["untiered"])
    del op, eng
    gc.collect()
    assert not any(g() for g in gone), "the tiered engines outlived refs"
    assert not any(p.is_alive() for p in procs), "a TP worker outlived it"
    torch.cuda.empty_cache()

    # spec: phase 9's Llama-3.2-1B-width draft over a tp 2 target
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    eng = TPC.spec_engine(dev, layers=TP_FEATURES_LAYERS)
    setup_s = time.perf_counter() - t0
    spec = eng._spec
    k = eng.cfg.num_spec_tokens
    rids, _ = llama3_8b_serve.add_requests(eng)
    propose, draft_ms = spec.propose, []

    def timed_propose(lists):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = propose(lists)
        torch.cuda.synchronize()
        draft_ms.append((time.perf_counter() - t) * 1e3)
        return out

    spec.propose = timed_propose
    verify = _FirstVerifyStep(eng)
    eng._tp.report(reset=True)            # rank 1's counts set to 0
    tsnap, dsnap = eng._graphs.snapshot(), spec.graphs.snapshot()
    with _PlainCalls() as plain3, _GreedyRows(
            eng, greedy, stop=serve["tokens"]) as rows:
        t1 = time.perf_counter()
        step_ms = []
        while eng.has_unfinished():
            t2 = time.perf_counter()
            eng.step()
            step_ms.append((time.perf_counter() - t2) * 1e3)
            rows.after_step()
            assert len(step_ms) < 1000, "engine failed to converge"
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    (w1,) = eng._tp.report()
    verify.close()
    twin, dwin = eng._graphs.since(tsnap), spec.graphs.since(dsnap)
    counts = _rank_counts(eng, twin, [w1])
    counts["rank0"]["k2"] = dwin["executed_launches"].get(
        "flash_attention_fwd", 0)
    steps = eng.metrics.engine_steps
    layers = eng.model.config.num_hidden_layers
    dlayers = spec.model.config.num_hidden_layers
    # uncaptured target: K1 once a layer a step on each rank; the draft
    # (captured, rank 0 only): K2 once a layer and forward in each replay
    # (executed: the replays and the new buckets' warm-ups)
    assert counts["rank0"]["k1"] == counts["rank1"]["k1"] == \
        layers * steps, (counts, steps)
    k2_replayed = dwin["replayed_launches"].get("flash_attention_fwd", 0)
    assert k2_replayed == dlayers * k * len(draft_ms) > 0, (counts, dwin)
    assert counts["rank1"]["k2"] == 0, counts
    assert verify.first is not None
    tokens = {rid: list(eng.get_request(rid).generated) for rid in rids}
    for rid in rids:
        r = eng.get_request(rid)
        assert r.finish_reason == "length", (rid, r.finish_reason)
        assert len(r.generated) == llama3_8b_serve.MAX_NEW_TOKENS
    assert eng.block_manager.num_free_blocks == eng.cfg.num_blocks
    m = eng.metrics
    sp = {"setup_s": setup_s, "handoff_s": eng._tp.handoff_s,
          "num_spec_tokens": k, "steps": steps, "step_ms": step_ms,
          "wall_s": wall,
          "tokens_per_s": sum(len(v) for v in tokens.values()) / wall,
          "ttft_ms_p50": float(np.percentile(m.ttfts_s, 50) * 1e3),
          "tpot_ms_p50": float(np.percentile(m.tpots_s, 50) * 1e3),
          "spec_proposed": eng.num_spec_proposed,
          "spec_accepted": eng.num_spec_accepted,
          "spec_acceptance_rate": eng.spec_acceptance_rate,
          "proposals": len(draft_ms),
          "draft_ms_p50": float(np.percentile(draft_ms, 50)),
          "draft_captures": dwin["captures"],
          "k2_replayed": k2_replayed,
          "kernel_launches": counts,
          "spec_tp1": spec9 and {key: spec9[key] for key in (
              "tpot_ms_p50", "draft_ms_p50", "spec_acceptance_rate",
              "tokens_per_s")},
          "greedy_equal_to_serve": sum(tokens[g] == serve["tokens"][g]
                                       for g in greedy),
          "greedy_divergence_rows": _divergences(
              serve_rows, serve["tokens"], rows.rows,
              {g: tokens[g] for g in greedy}, names=("tp1", "tp2"))}
    sp["k1_verify_step"] = _step_k1(dev, eng, verify.first, flush)
    peaks["spec"] = {"rank0": torch.cuda.max_memory_allocated(dev),
                     "rank1": w1["max_memory_allocated"]}
    assert not any(any(c.calls.values()) for c in (plain, plain2, plain3)), \
        (plain.calls, plain2.calls, plain3.calls)
    del spec.propose
    procs = list(eng._tp._procs)
    gone = [weakref.ref(x) for x in (eng, eng.model, spec, spec.model)]
    del eng, spec, propose, timed_propose, rows, verify, flush
    gc.collect()
    assert not any(g() for g in gone), "the spec engine outlived its refs"
    assert not any(p.is_alive() for p in procs), "a TP worker outlived it"
    torch.cuda.empty_cache()
    by_path = {"disagg": {"prefill": {"rank0": {
                   "k1": k1d["prefill"][0], "k2": 0}},
                          "decode": {f"rank{i}": {"k1": n, "k2": 0}
                                     for i, n in enumerate(k1d["decode"])}},
               "tiers": ti["kernel_launches"],
               "spec": sp["kernel_launches"]}
    res = {"phase": "tp_serving_features", "model": "llama3_8b",
           "tp_degree": TPC.TP,
           "placement": "both ranks on cuda:0 through the testing hook "
                        "paddle_tpu_torch.testing.tp_hooks."
                        "ranks_share_one_device",
           "f32": f32, "disagg_bf16": d, "tiers_bf16": ti, "spec_bf16": sp,
           "max_memory_allocated": peaks, "kernel_launches": by_path,
           "seconds": time.perf_counter() - t_phase}
    emit(res)
    return res


def _launch_sum(counts: dict, kernel: str) -> int:
    """The launches of ``kernel`` ("k1" or "k2") in a nested count by
    replica and rank."""
    if kernel in counts:
        return counts[kernel]
    return sum(_launch_sum(c, kernel) for c in counts.values())


HYBRID_NATS = 0.02     # phase 28 (b)'s losses against phase 7's


def _per_param(params_per_rank) -> dict:
    """Phase 28 (a)'s readings by parameter over a case's ranks: the
    largest |diff|, and the elements beyond the AdamW noise level and
    outside rtol / atol, of how many (summed over the ranks' shards)."""
    out = {}
    for c in params_per_rank:
        for name, r in c["per_param"].items():
            o = out.setdefault(name, {"max_abs_err": 0.0, "beyond_noise": 0,
                                      "outside_rtol_atol": 0,
                                      "elements": 0})
            o["max_abs_err"] = max(o["max_abs_err"], r["max_abs_err"])
            for k in ("beyond_noise", "outside_rtol_atol", "elements"):
                o[k] += r[k]
    return out


def phase_train_world():
    """Phases 28-31's one world of 4 ranks on this card (see the module
    docstring): the three tools' parts, one after another, so that the
    world's start-up is paid once. Each job's results by rank, and the
    world's seconds outside the jobs (its start-up and teardown)."""
    from paddle_tpu_torch.tools import gpt_1b_cp_train as C
    from paddle_tpu_torch.tools import gpt_1b_hybrid_train as H
    from paddle_tpu_torch.tools import gpt_1b_pipe_train as P

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = H.run_jobs([(H.__name__, {}), (P.__name__, {}),
                      (C.__name__, {"parts": ("a", "b", "moe")})],
                     timeout_s=1000.0, what="train_world")
    seconds = time.perf_counter() - t0
    assert out["alive_after"] == [], out["alive_after"]
    hyb, ppl, cp = out["jobs"]
    jobs_s = sum(max(r["seconds"] for r in job) for job in out["jobs"])
    return {"hybrid": hyb, "pipeline": ppl, "cp": cp, "seconds": seconds,
            "outside_jobs_s": seconds - jobs_s}


def _job_ranks(ranks, run, **kw):
    """A phase's job results by rank: ``ranks`` from
    :func:`phase_train_world`, or (None, the phase run alone) those of
    ``run(**kw)`` in a world of its own; each rank on this card over
    gloo."""
    if ranks is None:
        out = run(timeout_s=600.0, **kw)
        assert out["alive_after"] == [], out["alive_after"]
        ranks = out["ranks"]
    for r in ranks:
        assert r["backend"] == "gloo" and r["device"] == "cuda:0", r
    return ranks


def phase_hybrid_train(dev, train, ranks=None, world_s=None):
    """Phase 28 (see the module docstring). ``train`` is phase 7's result
    (its losses), ``ranks`` the world's results of this phase's job by
    rank (:func:`phase_train_world`; None: run alone) and ``world_s``
    that world's seconds outside its jobs."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.testing import flash_check
    from paddle_tpu_torch.tools import gpt_1b_hybrid_train as H

    t_phase = time.perf_counter()
    # K2-K4 at a rank's heads: B 4 / dp 2, H 16 / mp 2
    gen = torch.Generator(device=dev).manual_seed(28)
    b, s, h, d = 2, 2048, 8, 128
    q, k, v, do = (torch.randn((b, s, h, d), generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    scale = d ** -0.5
    o, lse = fa._flash_fwd_cuda(q, k, v, scale, True)
    delta = fa._delta(o, do)
    dq = fa._flash_bwd_dq_cuda(q, k, v, do, lse, delta, scale, True)
    dk, dv = fa._flash_bwd_dkv_cuda(q, k, v, do, lse, delta, scale, True)
    torch.cuda.synchronize()
    rep = flash_check.check(q, k, v, do, {"o": o, "lse": lse, "dq": dq,
                                          "dk": dk, "dv": dv}, scale, True)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev).zero_
    kern = {"shape": [b, s, s, h, d], "dtype": "bfloat16",
            "max_abs_err": rep["max_abs_err"],
            "tolerance": str(rep["tolerance"]),
            **_flash_train_times(q, k, v, do, o, lse, delta, scale, True,
                                 flush)}
    del q, k, v, do, o, lse, delta, dq, dk, dv, flush
    torch.cuda.empty_cache()

    checks_s = time.perf_counter() - t_phase
    ranks = _job_ranks(ranks, H.run)
    # its kernel checks here and its job on the ranks
    seconds = checks_s + max(r["seconds"] for r in ranks)
    names = [c[0] for c in H.CASES]
    cases = {}
    for name in names:
        per_rank = [r["cases"][name] for r in ranks if name in r["cases"]]
        cases[name] = {
            "ranks": len(per_rank), "losses": per_rank[0]["losses"],
            "losses_ok": all(c["losses_ok"] for c in per_rank),
            "params_per_rank": [
                {k: v for k, v in c["params"].items() if k != "per_param"}
                for c in per_rank],
            "per_param": _per_param([c["params"] for c in per_rank]),
            "step_s_per_rank": [c["step_s"] for c in per_rank],
            **({"slot_bytes_per_rank": [c["slot_bytes"] for c in per_rank],
                "max_memory_allocated_per_rank": [
                    c["max_memory_allocated"] for c in per_rank]}
               if "slot_bytes" in per_rank[0] else {})}
    full = [r["full"] for r in ranks]
    ref = train["losses"][:1 + H.TIMED_STEPS]
    res = {"phase": "hybrid_train", "world": H.WORLD,
           "placement": "all ranks on cuda:0 through the testing hook "
                        "paddle_tpu_torch.testing.tp_hooks."
                        "ranks_share_one_device (gloo through the host)",
           "seconds": seconds, "world_outside_jobs_s": world_s,
           "reference_losses_f32": ranks[0]["reference_losses"],
           "f32_cases": cases,
           "bf16_full": {
               "model": "gpt_1b (bench.py bench_gpt_1b), 16 layers",
               "mesh": "dp 2 x mp 2", "sharding_stage": 1,
               "sequence_parallel": True,
               "losses": full[0]["losses"], "phase7_losses": ref,
               "max_loss_diff_nats": max(abs(a - b_) for a, b_ in zip(
                   full[0]["losses"], ref)),
               "step_ms_per_rank": [f["step_ms"] for f in full],
               "step_ms_p50": max(f["step_ms_p50"] for f in full),
               "collective_host_ms_per_step": [
                   f["collective_host_ms_per_step"] for f in full],
               "collective_calls_per_step":
                   full[0]["collective_calls_per_step"],
               "collective_bytes_per_step": [
                   f["collective_bytes_per_step"] for f in full],
               "device_phases_rank0": full[0]["device_phases_one_step"],
               "max_memory_allocated_per_rank": [
                   f["max_memory_allocated"] for f in full],
               "local_params_per_rank": [f["local_params"] for f in full],
               "slot_bytes_per_rank": [f["slot_bytes"] for f in full],
               "setup_s": max(f["setup_s"] for f in full),
               "kernel_launches_per_rank": [f["kernel_launches"]
                                            for f in full]},
           "k2_k4_rank_shape": kern,
           "note": "four ranks share one card over gloo through the host: "
                   "no parallel speed is measured"}
    emit(res)
    # the checks, after the numbers are out
    for name in names:
        per_rank = [r["cases"][name] for r in ranks if name in r["cases"]]
        for c in per_rank:
            assert c["losses_ok"] and c["params"]["within_adam_bound"], (
                name, c)
            if "slot_bytes" in c:
                assert c["slot_bytes"] == c["reckoned_slot_bytes"], (name, c)
    for f in full:
        assert f["losses"] == full[0]["losses"], [x["losses"] for x in full]
        diffs = [abs(a - b_) for a, b_ in zip(f["losses"], ref)]
        assert max(diffs) <= HYBRID_NATS, (f["losses"], ref)
        assert f["losses"][-1] < f["losses"][0], f["losses"]
        want = train["layers"] * H.TIMED_STEPS
        assert all(n == want for n in f["kernel_launches"].values()), (
            f["kernel_launches"], want)
    return res


PIPE_NATS = 0.02       # phase 29 (b)'s losses against phase 7's


def phase_pipeline_train(dev, train, ranks=None):
    """Phase 29 (see the module docstring). ``train`` is phase 7's result
    (its losses), ``ranks`` the world's results of this phase's job by
    rank (:func:`phase_train_world`; None: run alone)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.testing import flash_check
    from paddle_tpu_torch.tools import gpt_1b_pipe_train as P

    t_phase = time.perf_counter()
    # K2-K4 at a pp rank's microbatch: B 4 / M 4, all 16 heads
    gen = torch.Generator(device=dev).manual_seed(29)
    b, s, h, d = 1, 2048, 16, 128
    q, k, v, do = (torch.randn((b, s, h, d), generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    scale = d ** -0.5
    o, lse = fa._flash_fwd_cuda(q, k, v, scale, True)
    delta = fa._delta(o, do)
    dq = fa._flash_bwd_dq_cuda(q, k, v, do, lse, delta, scale, True)
    dk, dv = fa._flash_bwd_dkv_cuda(q, k, v, do, lse, delta, scale, True)
    torch.cuda.synchronize()
    rep = flash_check.check(q, k, v, do, {"o": o, "lse": lse, "dq": dq,
                                          "dk": dk, "dv": dv}, scale, True)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev).zero_
    kern = {"shape": [b, s, s, h, d], "dtype": "bfloat16",
            "max_abs_err": rep["max_abs_err"],
            "tolerance": str(rep["tolerance"]),
            **_flash_train_times(q, k, v, do, o, lse, delta, scale, True,
                                 flush)}
    del q, k, v, do, o, lse, delta, dq, dk, dv, flush
    torch.cuda.empty_cache()

    checks_s = time.perf_counter() - t_phase
    ranks = _job_ranks(ranks, P.run)
    # its kernel checks here and its job on the ranks
    seconds = checks_s + max(r["seconds"] for r in ranks)
    names = [c[0] for c in P.CASES]
    cases = {}
    for name in names:
        per_rank = [r["cases"][name] for r in ranks if name in r["cases"]]
        cases[name] = {
            "ranks": len(per_rank), "losses": per_rank[0]["losses"],
            "losses_ok": all(c["losses_ok"] for c in per_rank),
            "params_per_rank": [
                {k: v for k, v in c["params"].items() if k != "per_param"}
                for c in per_rank],
            "per_param": _per_param([c["params"] for c in per_rank]),
            "layers_per_rank": [c["owned"] for c in per_rank],
            "pre_post_one_over_s": all(c["pre_post_one_over_s"]
                                       for c in per_rank),
            "pre_post_shares_rank0": per_rank[0]["pre_post_shares"],
            "param_bytes_per_rank": [c["param_bytes"] for c in per_rank],
            "slot_bytes_per_rank": [c["slot_bytes"] for c in per_rank],
            "bubble_fraction": per_rank[0]["bubble_fraction"],
            "step_s_per_rank": [c["step_s"] for c in per_rank],
            "max_memory_allocated_per_rank": [
                c["max_memory_allocated"] for c in per_rank],
            "optimizer": per_rank[0]["optimizer"]}
        for key in ("round_trip", "lamb_update", "kernel_launches",
                    "reckoned_launches"):
            if key in per_rank[0]:
                cases[name][key + "_per_rank"] = [c[key] for c in per_rank]
    full = [r["full"] for r in ranks]
    ref = train["losses"][:1 + P.TIMED_STEPS]
    want = {"flash_attention_fwd": 2 * 4 * 4 * P.TIMED_STEPS,
            "flash_attention_bwd_dq": 4 * 4 * P.TIMED_STEPS,
            "flash_attention_bwd_dkv": 4 * 4 * P.TIMED_STEPS}
    res = {"phase": "pipeline_train", "world": P.WORLD,
           "placement": "all ranks on cuda:0 through the testing hook "
                        "paddle_tpu_torch.testing.tp_hooks."
                        "ranks_share_one_device (gloo through the host)",
           "seconds": seconds, "f32_layers": P.F32_LAYERS,
           "reference_losses_f32": ranks[0]["reference_losses"],
           "f32_cases": cases,
           "bf16_full": {
               "model": "gpt_1b (bench.py bench_gpt_1b) as "
                        "LlamaForCausalLMPipe, 16 layers",
               "mesh": "pp 4", "schedule": "1f1b", "n_microbatches": 4,
               "shard_pre_post": True, "remat_body": True,
               "bubble_fraction": full[0]["bubble_fraction"],
               "losses": full[0]["losses"], "phase7_losses": ref,
               "max_loss_diff_nats": max(abs(a - b_) for a, b_ in zip(
                   full[0]["losses"], ref)),
               "layers_per_rank": [f["layers_owned"] for f in full],
               "step_ms_per_rank": [f["step_ms"] for f in full],
               "step_ms_p50": max(f["step_ms_p50"] for f in full),
               "p2p_host_ms_per_step": [f["p2p_host_ms_per_step"]
                                        for f in full],
               "p2p_calls_per_step": [f["p2p_calls_per_step"]
                                      for f in full],
               "p2p_bytes_per_step": [f["p2p_bytes_per_step"]
                                      for f in full],
               "collective_host_ms_per_step": [
                   f["collective_host_ms_per_step"] for f in full],
               "collective_calls_per_step":
                   full[0]["collective_calls_per_step"],
               "collective_bytes_per_step": [
                   f["collective_bytes_per_step"] for f in full],
               "device_phases_rank0": full[0]["device_phases_one_step"],
               "max_memory_allocated_per_rank": [
                   f["max_memory_allocated"] for f in full],
               "local_params_per_rank": [f["local_params"] for f in full],
               "param_bytes_per_rank": [f["param_bytes"] for f in full],
               "slot_bytes_per_rank": [f["slot_bytes"] for f in full],
               "setup_s": max(f["setup_s"] for f in full),
               "kernel_launches_per_rank": [f["kernel_launches"]
                                            for f in full],
               "reckoned_launches_per_rank": want},
           "k2_k4_rank_shape": kern,
           "note": "four ranks share one card over gloo through the host: "
                   "no pipeline speed is measured"}
    emit(res)
    # the checks, after the numbers are out
    for name in names:
        for c in [r["cases"][name] for r in ranks if name in r["cases"]]:
            assert c["losses_ok"] and c["params"]["within_adam_bound"], (
                name, c["losses"], {k: v for k, v in c["params"].items()
                                    if k != "per_param"})
            assert c["pre_post_one_over_s"], (name, c["pre_post_shares"])
            assert c["slot_bytes"] == c["reckoned_slot_bytes"], (
                name, c["slot_bytes"], c["reckoned_slot_bytes"])
            trip = c.get("round_trip")
            if trip is not None:
                assert trip["loss_bit_identical"] and \
                    trip["bit_identical_tensors"] == trip["tensors"] and \
                    trip["slots"] > 0, (name, trip)
            if "lamb_update" in c:
                assert c["lamb_update"]["within_lamb_bound"], (
                    name, {k: v for k, v in c["lamb_update"].items()
                           if k != "per_param"})
            if "reckoned_launches" in c:
                assert c["kernel_launches"] == c["reckoned_launches"], (
                    name, c["kernel_launches"], c["reckoned_launches"])
    assert any("round_trip" in r["cases"].get("pp4_1f1b", {})
               for r in ranks)
    for f in full:
        assert f["losses"] == full[0]["losses"], [x["losses"] for x in full]
        diffs = [abs(a - b_) for a, b_ in zip(f["losses"], ref)]
        assert max(diffs) <= PIPE_NATS, (f["losses"], ref)
        assert f["losses"][-1] < f["losses"][0], f["losses"]
        assert f["kernel_launches"] == want, (f["kernel_launches"], want)
    return res


CP_NATS = 0.02         # phase 30 (b)'s losses against phase 7's
# the ring's chunk shapes at phase 30 (b): B 4 / dp 2, S 2048 / sp 2
CP_CHUNK = (2, 1024, 16, 128)


def _ring_chunk_kernels(dev):
    """K2-K4 at a ring chunk of phase 30 (b) (B 2, 1024 queries and keys,
    H 16, D 128, bf16): the diagonal chunk (causal) and an earlier one
    (whole), each against its plain version (``flash_check``), timed,
    with bounds and SDPA's times."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.testing import flash_check

    gen = torch.Generator(device=dev).manual_seed(30)
    b, s, h, d = CP_CHUNK
    scale = d ** -0.5
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev).zero_
    out = {}
    for name, causal in (("diagonal", True), ("earlier", False)):
        q, k, v, do = (torch.randn((b, s, h, d), generator=gen, device=dev)
                       .to(torch.bfloat16) for _ in range(4))
        o, lse = fa._flash_fwd_cuda(q, k, v, scale, causal)
        delta = fa._delta(o, do)
        dq = fa._flash_bwd_dq_cuda(q, k, v, do, lse, delta, scale, causal)
        dk, dv = fa._flash_bwd_dkv_cuda(q, k, v, do, lse, delta, scale,
                                        causal)
        torch.cuda.synchronize()
        rep = flash_check.check(q, k, v, do, {"o": o, "lse": lse, "dq": dq,
                                              "dk": dk, "dv": dv},
                                scale, causal)
        out[name] = {"shape": [b, s, s, h, d], "causal": causal,
                     "dtype": "bfloat16", "max_abs_err": rep["max_abs_err"],
                     "tolerance": str(rep["tolerance"]),
                     **_flash_train_times(q, k, v, do, o, lse, delta, scale,
                                          causal, flush)}
        del q, k, v, do, o, lse, delta, dq, dk, dv
    torch.cuda.empty_cache()
    return out


def phase_cp_moe(dev, train, ranks=None):
    """Phases 30 (``cp_train``) and 31 (``moe_train``), one job of the
    world of 4 ranks (see the module docstring). ``train`` is phase 7's
    result (its losses), ``ranks`` the world's results of this job by
    rank (:func:`phase_train_world`; None: run alone)."""
    from paddle_tpu_torch.testing import cp_ranks
    from paddle_tpu_torch.tools import gpt_1b_cp_train as C
    from paddle_tpu_torch.tools import moe_train as M

    t0 = time.perf_counter()

    kern = _ring_chunk_kernels(dev)
    path = cp_ranks.ring_path_check(dev, CP_CHUNK)
    checks_s = time.perf_counter() - t0
    ranks = _job_ranks(ranks, C.run, parts=("a", "b", "moe"))
    job_s = max(r["seconds"] for r in ranks)
    names = [c[0] for c in C.CASES]
    cases = {}
    for name in names:
        per_rank = [r["cases"][name] for r in ranks]
        cases[name] = {
            "losses": per_rank[0]["losses"],
            "losses_ok": all(c["losses_ok"] for c in per_rank),
            "params_per_rank": [
                {k: v for k, v in c["params"].items() if k != "per_param"}
                for c in per_rank],
            "per_param": _per_param([c["params"] for c in per_rank]),
            "step_s_per_rank": [c["step_s"] for c in per_rank],
            "slot_bytes_per_rank": [c["slot_bytes"] for c in per_rank],
            "max_memory_allocated_per_rank": [
                c["max_memory_allocated"] for c in per_rank]}
    full = [r["full"] for r in ranks]
    layers = train["layers"]
    want = [C.reckoned_launches(f["sp_index"], layers, C.TIMED_STEPS)
            for f in full]
    ref = train["losses"][:1 + C.TIMED_STEPS]
    cp = {"phase": "cp_train", "world": C.WORLD,
          "placement": "all ranks on cuda:0 through the testing hook "
                       "paddle_tpu_torch.testing.tp_hooks."
                       "ranks_share_one_device (gloo through the host)",
          "seconds": checks_s + job_s, "kernel_checks_s": checks_s,
          "job_s": job_s, "f32_layers": C.F32_LAYERS,
          "reference_losses_f32": ranks[0]["reference_losses"],
          "f32_cases": cases,
          "bf16_full": {
              "model": "gpt_1b (bench.py bench_gpt_1b), 16 layers, "
                       "context_parallel",
              "mesh": "dp 2 x sp 2", "sharding_stage": 1,
              "losses": full[0]["losses"], "phase7_losses": ref,
              "max_loss_diff_nats": max(abs(a - b_) for a, b_ in zip(
                  full[0]["losses"], ref)),
              "step_ms_per_rank": [f["step_ms"] for f in full],
              "step_ms_p50": max(f["step_ms_p50"] for f in full),
              "p2p_host_ms_per_step": [f["p2p_host_ms_per_step"]
                                       for f in full],
              "p2p_calls_per_step": [f["p2p_calls_per_step"] for f in full],
              "p2p_bytes_per_step": [f["p2p_bytes_per_step"] for f in full],
              "collective_host_ms_per_step": [
                  f["collective_host_ms_per_step"] for f in full],
              "collective_calls_per_step": [
                  f["collective_calls_per_step"] for f in full],
              "collective_bytes_per_step": [
                  f["collective_bytes_per_step"] for f in full],
              "max_memory_allocated_per_rank": [
                  f["max_memory_allocated"] for f in full],
              "local_params_per_rank": [f["local_params"] for f in full],
              "slot_bytes_per_rank": [f["slot_bytes"] for f in full],
              "setup_s": max(f["setup_s"] for f in full),
              "sp_index_per_rank": [f["sp_index"] for f in full],
              "kernel_launches_per_rank": [f["kernel_launches"]
                                           for f in full],
              "reckoned_launches_per_rank": want},
          "k2_k4_ring_chunks": kern, "ring_path": path,
          "masked": {
              "case": "cp_dp2_sp2_masked", "layers": C.MASKED_LAYERS,
              "dtype": "float32", "lens": ranks[0]["masked"]["lens"],
              "bound_rel": C.MASKED_REL,
              "max_rel_err_per_rank": [r["masked"]["max_rel_err"]
                                       for r in ranks],
              "worst_per_rank": [r["masked"]["worst"] for r in ranks],
              "logits_rel_err_per_rank": [r["masked"]["logits_rel_err"]
                                          for r in ranks],
              "seconds_per_rank": [r["masked"]["seconds"] for r in ranks],
              "max_memory_allocated_per_rank": [
                  r["masked"]["max_memory_allocated"] for r in ranks]},
          "note": "four ranks share one card over gloo through the host: "
                  "no parallel speed is measured"}
    emit(cp)
    moe = [r["moe"] for r in ranks]
    m0 = moe[0]
    mo = {"phase": "moe_train", "world": C.WORLD, "sizes": m0["sizes"],
          "model": "tests/test_moe.py MoEModel at the 1B Llama's widths "
                   "(d 2048, 8 experts of 2048 -> 5632 -> 2048, gshard)",
          "reference_f32": m0["reference_f32"],
          "f32": {name: {
              "losses": m0["f32"][name]["losses"],
              "losses_ok": all(m["f32"][name]["losses_ok"] for m in moe),
              "params_per_rank": [
                  {k: v for k, v in m["f32"][name]["params"].items()
                   if k != "per_param"} for m in moe],
              "dropped_per_rank": [m["f32"][name]["dropped"] for m in moe],
              "aux": m0["f32"][name]["aux"],
              "step_ms_per_rank": [m["f32"][name]["step_ms"] for m in moe],
              "collective_bytes_per_step": [
                  m["f32"][name]["collective_bytes_per_step"] for m in moe],
              "collective_host_ms_per_step": [
                  m["f32"][name]["collective_host_ms_per_step"]
                  for m in moe],
              "local_params_per_rank": [m["f32"][name]["local_params"]
                                        for m in moe],
              "max_memory_allocated_per_rank": [
                  m["f32"][name]["max_memory_allocated"] for m in moe]}
              for name in m0["f32"]},
          "bf16_ep4_sharded": {
              "losses": m0["bf16"]["losses"],
              "reference_losses": m0["bf16"]["reference_losses"],
              "max_loss_diff": max(m["bf16"]["max_loss_diff"] for m in moe),
              "aux": m0["bf16"]["aux"],
              "dropped_per_rank": [m["bf16"]["dropped"] for m in moe],
              "step_ms_per_rank": [m["bf16"]["step_ms"] for m in moe],
              "step_ms_p50": max(m["bf16"]["step_ms_p50"] for m in moe),
              "all_to_all_and_collective_bytes_per_step": [
                  m["bf16"]["collective_bytes_per_step"] for m in moe],
              "collective_host_ms_per_step": [
                  m["bf16"]["collective_host_ms_per_step"] for m in moe],
              "max_memory_allocated_per_rank": [
                  m["bf16"]["max_memory_allocated"] for m in moe]},
          "seconds": max(m["seconds"] for m in moe),
          "note": "the same job of the world as phase 30 (its job_s "
                  "holds both)"}
    emit(mo)
    # the checks, after the numbers are out
    for name in names:
        for c in [r["cases"][name] for r in ranks]:
            assert c["losses_ok"] and c["params"]["within_adam_bound"], (
                name, c["losses"], {k: v for k, v in c["params"].items()
                                    if k != "per_param"})
            assert c["slot_bytes"] == c["reckoned_slot_bytes"], (name, c)
    for r in ranks:
        assert r["masked"]["within"], r["masked"]
    for f, w in zip(full, want):
        assert f["losses"] == full[0]["losses"], [x["losses"] for x in full]
        diffs = [abs(a - b_) for a, b_ in zip(f["losses"], ref)]
        assert max(diffs) <= CP_NATS, (f["losses"], ref)
        assert f["losses"][-1] < f["losses"][0], f["losses"]
        assert f["kernel_launches"] == w, (f["kernel_launches"], w)
    for m in moe:
        for name, c in m["f32"].items():
            assert c["losses_ok"] and c["params"]["within_adam_bound"], (
                name, c["losses"], m["reference_f32"]["losses"],
                {k: v for k, v in c["params"].items() if k != "per_param"})
        assert m["bf16"]["max_loss_diff"] <= M.BF16_LOSS_ATOL, m["bf16"]
        assert all(np.isfinite(m["bf16"]["losses"])), m["bf16"]
    return cp, mo


GANG_TIMEOUT_S = 20.0  # phase 32's PADDLE_STEP_TIMEOUT: a step is 1.4-3 s
# phase 32's PADDLE_ABORT_POLL: the library's default. The abort bound
# is two polls plus the linger (a poll and two monitor periods); the
# ranks' exits, as the launcher sees them, also hold the card's context
# teardown (about 0.1 s a rank, one after another on a shared card)
GANG_POLL_S = 1.0
GANG_HANG = (1, 3)     # phase 32 (b): rank 1 hangs in step 3
GANG_STEPS = 4
_EXIT_RE = re.compile(r"\[launch\] rank (\d+) exited rc=(-?\d+) at ([\d.]+)")


def _gang_run(tag, root, ckpt, base_env, extra_env=(), launch_args=(),
              on_start=None):
    """One launch of the gang tool on four ranks sharing the card (the
    launcher's environment ``base_env`` and ``extra_env``): the
    launcher's exit code, seconds and stderr, and the ranks' result
    files by attempt and rank."""
    here = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(root, tag)
    os.makedirs(out)
    env = dict(base_env, PADDLE_TORCH_RANKS_SHARE_DEVICE="1",
               PYTHONPATH=here + os.pathsep + base_env.get("PYTHONPATH",
                                                           ""))
    env.update(dict(extra_env))
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", "4", "--log_dir", os.path.join(out, "logs"),
           *launch_args,
           os.path.join(here, "paddle_tpu_torch/tools/gpt_1b_gang_train.py"),
           "--ckpt", ckpt, "--out", out, "--steps", str(GANG_STEPS)]
    t0, t0_epoch = time.perf_counter(), time.time()
    with open(os.path.join(out, "launcher.err"), "w") as err:
        p = subprocess.Popen(cmd, env=env, cwd=here,
                             stdout=subprocess.DEVNULL, stderr=err)
        try:
            if on_start is not None:
                on_start(p, out)
            rc = p.wait(timeout=600)
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds, end_epoch = time.perf_counter() - t0, time.time()
    with open(os.path.join(out, "launcher.err")) as f:
        stderr = f.read()
    results = {}
    for name in os.listdir(out):
        m = re.match(r"result\.attempt(\d+)\.rank(\d+)\.json$", name)
        if m:
            with open(os.path.join(out, name)) as f:
                results[(int(m.group(1)), int(m.group(2)))] = json.load(f)
    logs = {}
    for r in range(4):
        with open(os.path.join(out, "logs", f"workerlog.{r}")) as f:
            logs[r] = f.read()
    return {"rc": rc, "seconds": seconds, "stderr": stderr,
            "results": results, "logs": logs, "t0": t0_epoch,
            "end": end_epoch}


def _gang_overhead(run, attempt):
    """Seconds of a launch outside its last attempt's ranks: from the
    launcher's start to that attempt's first rank process (the launcher's
    own start-up, for attempt 0), and from the last rank's hashes to the
    launcher's exit (the ranks' teardown and the launcher's)."""
    ranks = _gang_ranks(run, attempt)
    return {"to_first_rank_s": min(r["started_at"] for r in ranks)
            - run["t0"],
            "after_last_rank_s": run["end"] - max(
                r["started_at"] + r["marks_s"]["hashed"] for r in ranks)}


def _gang_ranks(run, attempt):
    return [run["results"][(attempt, r)] for r in range(4)]


def _gang_summary(ranks):
    return {
        "resumed_from": [r["resumed_from"] for r in ranks],
        "final_step": [r["final_step"] for r in ranks],
        "losses": ranks[0]["losses"],
        "startup_s_per_rank": [r["startup_s"] for r in ranks],
        "startup_marks_s_per_rank": [r["marks_s"] for r in ranks],
        "restore_s_per_rank": [r["restore_s"] for r in ranks],
        "step_s_per_rank": [r["step_s"] for r in ranks],
        "write_wait_ms_per_rank": [r["wait_ms"] for r in ranks],
        "snapshot_ms_per_rank": [r["snapshot_ms"] for r in ranks],
        "write_s_per_rank": [[s["write_s"] for s in r["saves"]]
                             for r in ranks],
        "bytes_saved_per_rank": [r["bytes_saved_last"] for r in ranks],
        "slot_bytes_per_rank": [r["slot_bytes"] for r in ranks],
        "kernel_launches_per_rank": [r["kernel_launches"] for r in ranks],
        "max_memory_allocated_per_rank": [r["max_memory_allocated"]
                                          for r in ranks],
        "device": sorted({r["device"] for r in ranks}),
        "backend": sorted({r["backend"] for r in ranks})}


def _preempt_once_restored(p, out):
    """Phase 32 (c)'s notice: SIGTERM to the launcher once every rank of
    the gang's attempt 1 has restored (its progress file says so), which
    is after step 2 was committed and before step 3 ends."""
    import signal

    files = [os.path.join(out, f"progress.rank{r}.json") for r in range(4)]

    def attempt(path):
        try:
            with open(path) as f:
                return json.load(f)["attempt"]
        except (OSError, ValueError, KeyError):
            return None

    deadline = time.time() + 300
    while not all(attempt(f) == 1 for f in files):
        assert p.poll() is None and time.time() < deadline, \
            "phase 32 (c): attempt 1 never restored"
        time.sleep(0.05)
    p.send_signal(signal.SIGTERM)


def gang_launches(base_env):
    """Phase 32's three launches, one gang at a time (the launcher's
    environment ``base_env``): each launch's results and their seconds.
    It starts no work on the card in this process, so ``chip_smoke.py``
    runs it beside phases 26 (c)-(d) and 27 (a), which time no kernel."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="gang-")
    hang_env = {"GANG_HANG": "%d:%d" % GANG_HANG,
                "PADDLE_STEP_TIMEOUT": str(GANG_TIMEOUT_S),
                "PADDLE_ABORT_POLL": str(GANG_POLL_S)}
    ckpt = os.path.join(root, "ckpt_bc")
    try:
        # one gang at a time: (a) unbroken; (b) rank 1 hangs in step 3,
        # the gang restarts once and attempt 1, SIGTERMed once it has
        # restored, takes its final save at step 3 ((c)'s preemption);
        # (c) a new launch resumes there and finishes
        a = _gang_run("a", root, os.path.join(root, "ckpt_a"), base_env)
        b = _gang_run("b", root, ckpt, base_env, hang_env,
                      ("--max_restart", "2", "--restart_interval", "0.2"),
                      on_start=_preempt_once_restored)
        c = _gang_run("c", root, ckpt, base_env)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return a, b, c, time.perf_counter() - t0


def phase_gang(launches=None):
    """Phase 32 (see the module docstring): ``launches`` are
    :func:`gang_launches`' results (None: run them now)."""
    from paddle_tpu_torch.tools import gpt_1b_gang_train as G

    a, b, c, seconds = launches or gang_launches(dict(os.environ))

    ra = _gang_ranks(a, 0)
    # attempt 0's exits: the launcher's lines before its restart
    exits = [(int(r), int(x), float(t)) for r, x, t in
             _EXIT_RE.findall(b["stderr"].split("restarting")[0])]
    hang_line = re.search(r"GANG_HANG rank=\d+ armed=([\d.]+) "
                          r"deadline=([\d.]+)", b["logs"][GANG_HANG[0]])
    armed, deadline = (float(hang_line.group(1)),
                       float(hang_line.group(2))) if hang_line else (None,
                                                                     None)
    rb, rc = _gang_ranks(b, 1), _gang_ranks(c, 0)
    last_exit = max((t for _, _, t in exits), default=None)
    latency = (last_exit - deadline if last_exit and deadline else None)
    # the watchdog's own bound: a peer reads the record within a poll,
    # and every rank leaves a poll and two monitor periods after it was
    # posted (watchdog.StepWatchdog._leave); allowed: two polls + that
    period = min(0.2, max(0.01, GANG_TIMEOUT_S / 10))
    latency_limit = 2 * GANG_POLL_S + (GANG_POLL_S + 2 * period)
    res = {"phase": "gang", "world": 4, "steps": GANG_STEPS,
           "model": "gpt_1b (bench.py bench_gpt_1b) widths, %d of 16 layers, "
                    "bf16 with f32 master weights" % G.LAYERS,
           "mesh": "dp 2 x mp 2", "sharding_stage": 1,
           "sequence_parallel": True,
           "placement": "python -m paddle_tpu_torch.distributed.launch "
                        "--nproc_per_node 4 with "
                        "PADDLE_TORCH_RANKS_SHARE_DEVICE=1 (gloo through "
                        "the host), one gang at a time",
           "seconds": seconds,
           "launch_s": {"a": a["seconds"], "b_hang_then_preempted":
                        b["seconds"], "c_resumed": c["seconds"]},
           "launch_overhead_s": {"a": _gang_overhead(a, 0),
                                 "b_attempt1": _gang_overhead(b, 1),
                                 "c_resumed": _gang_overhead(c, 0)},
           "a_unbroken": _gang_summary(ra),
           "b_hang": {"rc": b["rc"], "exits_attempt0": exits,
                      "hang_armed": armed, "hang_deadline": deadline,
                      "step_timeout_s": GANG_TIMEOUT_S,
                      "abort_poll_s": GANG_POLL_S,
                      "abort_latency_s": latency,
                      "abort_latency_limit_s": latency_limit,
                      "restarts": b["stderr"].count("restarting"),
                      "attempt1": _gang_summary(rb)},
           "c_preempt": {"rc": b["rc"],
                         "preempted_at": [r["preempted_at"] for r in rb],
                         "resumed": _gang_summary(rc)},
           "note": "four ranks share one card over gloo through the host: "
                   "no parallel speed is measured"}
    emit(res)
    # the checks, after the numbers are out
    assert a["rc"] == 0, a["stderr"][-4000:]
    for r in ra + rb + rc:
        assert r["device"] == "cuda:0" and r["backend"] == "gloo", r
    losses = ra[0]["losses"]
    assert sorted(losses) == [str(i) for i in range(1, GANG_STEPS + 1)]
    assert all(np.isfinite(list(losses.values())))
    for r in ra:
        assert r["losses"] == losses, [x["losses"] for x in ra]
        want = G.LAYERS * GANG_STEPS
        assert all(n == want for n in r["kernel_launches"].values()), (
            r["kernel_launches"], want)
    # (b): the hung rank exits 6 naming its collective, its peers 7
    # naming it, the last within the watchdog's bound after the hang's
    # deadline; one relaunch, whose attempt restores the agreed step 2
    # and runs step 3 bit-identically to (a)
    hung, step = GANG_HANG
    tag = "all_reduce@ranks[0, 1, 2, 3]"
    assert b["rc"] == 0 and b["stderr"].count("restarting") == 1, \
        b["stderr"][-4000:]
    codes = {r: x for r, x, _ in exits}
    assert len(exits) == 4 and \
        codes == {r: 6 if r == hung else 7 for r in range(4)}, exits
    assert f"[watchdog] rank {hung}: step(s) [{tag}]" in b["logs"][hung]
    for r in range(4):
        if r != hung:
            assert f"[watchdog] rank {hung} aborted on [{tag}]" in \
                b["logs"][r], b["logs"][r][-2000:]
    assert latency is not None and latency <= latency_limit, (
        latency, latency_limit, exits, deadline)
    # (c): SIGTERM reached attempt 1 after its restore: every rank's
    # final save at one step before the last, exit 0 with no further
    # relaunch; the new launch resumes there, bit-identical to (a)
    at = {r["preempted_at"] for r in rb}
    assert len(at) == 1 and None not in at, (at, b["stderr"][-4000:])
    p = at.pop()
    assert step <= p < GANG_STEPS, p
    for r, x in zip(rb, ra):
        assert r["resumed_from"] == step - 1, r["resumed_from"]
        assert r["losses"] == {k: v for k, v in x["losses"].items()
                               if step <= int(k) <= p}, (r["losses"],
                                                         x["losses"])
    assert c["rc"] == 0, c["stderr"][-4000:]
    for r, x in zip(rc, ra):
        assert r["resumed_from"] == p and r["final_step"] == GANG_STEPS
        assert r["losses"] == {k: v for k, v in x["losses"].items()
                               if int(k) > p}, (r["losses"], x["losses"])
        assert r["sha256"] == x["sha256"], r["rank"]
    return res


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False)")
    import paddle_tpu_torch  # noqa: F401  (fails outside a checkout)
    from paddle_tpu_torch.tools import llama3_8b_serve, llama3_8b_spec_serve

    smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    k, kv, kg = phase_kernel(dev)
    s = phase_serve(dev)
    phase_parity(dev)
    draft_shape = llama3_8b_spec_serve.draft_shape(s["prompt_lens"])
    fl = phase_flash(dev, draft_shape)
    tr = phase_train(dev)
    phase_train_parity(dev)
    sp = phase_spec(dev, s, draft_shape)
    serve_rows = s.pop("rows")            # phase 25 compares with them
    phase_spec_parity(dev)
    # phases 11-13: one Llama-3-8B for all three, freed after them
    model = llama3_8b_serve.target_model(dev)
    sw = phase_swap(dev, model)
    dn = phase_drain(dev, model)
    bk = phase_bucketed(dev, model)
    gone = _freed(model)
    del model
    assert not any(r() for r in gone), "the 8B model outlived its refs"
    torch.cuda.empty_cache()
    phase_resilience_parity(dev)
    et = phase_eager_train(dev, tr)
    phase_resume(dev)
    phase_eager_parity(dev)
    fe = phase_fed_train(dev, tr)
    ta = phase_tensor_api(dev)
    la = phase_layer_api(dev)
    lt = phase_layer_trainstep(dev, fe)
    ti = phase_tiers(dev)
    lg = phase_long_tail(dev)
    bt = phase_bert(dev)
    tpr = phase_tp(dev, s, serve_rows)
    # phase 32's launches (subprocesses only) run beside phases 26 (c)-(d)
    # and 27 (a), which time no kernel; its line comes at its turn
    gang = _Beside(gang_launches, dict(os.environ))
    try:
        flt = phase_fleet(dev, s, beside=gang.start)
        tpf = phase_tp_features(dev, s, serve_rows, flt, sp,
                                after_f32=gang.result)
    finally:
        if gang.is_alive():     # a phase failed beside it: let it end
            gang.join()
    del serve_rows
    world = phase_train_world()
    hyb = phase_hybrid_train(dev, tr, world["hybrid"],
                             world["outside_jobs_s"])
    ppl = phase_pipeline_train(dev, tr, world["pipeline"])
    cp, _ = phase_cp_moe(dev, tr, world["cp"])
    del world
    gang = phase_gang(gang.result())
    errs = fl["cases"]["train_shapes"]["max_abs_err"]
    derr = fl["cases"]["draft_shapes"]["max_abs_err"]["o"]
    dr = fl["fwd_only"]["draft_shapes"]
    # per path: the main paths' launches (each counted from 0 over its
    # own run) and, for the spec path's shapes, the kernel's numbers
    by_path = {
        "ragged_paged_attention": {
            "serve": s["kernel_launches"],
            "spec": sp["kernel_launches"]["ragged_paged_attention"],
            "swap": sw["host"]["kernel_launches"],
            "swap_recompute": sw["recompute"]["kernel_launches"],
            "drain": dn["drain"]["kernel_launches"],
            "watchdog": dn["watchdog"]["kernel_launches"],
            "generate_cached": bk["generate"]["kernel_launches"][
                "ragged_paged_attention"],
            "tiers": ti["kernel_launches"],
            "tp": sum(tpr["kernel_launches"].values()),
            "bert": bt["kernel_launches"]["ragged_paged_attention"],
            "fleet": flt["kernel_launches"],
            "tp_worker": sum(flt["tp_worker"]["k1_launches_per_rank"]),
            **{f"tp_{name}": _launch_sum(counts, "k1")
               for name, counts in tpf["kernel_launches"].items()}},
        "flash_attention_fwd": {
            "train": tr["kernel_launches"]["flash_attention_fwd"],
            "spec": sp["kernel_launches"]["flash_attention_fwd"],
            "tp_spec": _launch_sum(tpf["kernel_launches"]["spec"], "k2"),
            "generate_naive": bk["generate"]["kernel_launches"][
                "flash_attention_fwd"]},
        "flash_attention_bwd_dq": {
            "train": tr["kernel_launches"]["flash_attention_bwd_dq"]},
        "flash_attention_bwd_dkv": {
            "train": tr["kernel_launches"]["flash_attention_bwd_dkv"]}}
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        by_path[name]["eager_train"] = et["kernel_launches"][name]
        by_path[name]["trainstep_scaler"] = \
            et["trainstep_scaler"]["kernel_launches"][name]
        by_path[name]["fed_train"] = fe["executed_launches"][name]
        by_path[name]["tensor_api"] = \
            ta["bf16_full_depth"]["kernel_launches"][name]
        by_path[name]["layer_api"] = \
            la["bf16_full_depth"]["kernel_launches"][name]
        by_path[name]["layer_trainstep"] = lt["kernel_launches"][name]
        by_path[name]["long_tail"] = lg["kernel_launches"][name]
        by_path[name]["bert"] = bt["kernel_launches"][name]
        by_path[name]["hybrid_train"] = sum(
            n[name] for n in hyb["bf16_full"]["kernel_launches_per_rank"])
        by_path[name]["pipeline_train"] = sum(
            n[name] for n in ppl["bf16_full"]["kernel_launches_per_rank"])
        by_path[name]["pipeline_train_cp"] = sum(
            n[name] for n in ppl["f32_cases"]["pp2_sp2_cp"][
                "kernel_launches_per_rank"])
        by_path[name]["cp_train"] = sum(
            n[name] for n in cp["bf16_full"]["kernel_launches_per_rank"])
        by_path[name]["gang_train"] = sum(
            n[name] for n in gang["a_unbroken"]["kernel_launches_per_rank"])
    spec_shapes = {
        "ragged_paged_attention": {
            "max_abs_err": kv["max_abs_err"], "ms": kv["ms"],
            "plain_ms": kv["plain_ms"], "bound_ms": kv["bound_ms"],
            "bound_by": kv["bound_by"], "library_ms": None},
        "flash_attention_fwd": {
            "shape": fl["cases"]["draft_shapes"]["shape"],
            "max_abs_err": derr, "ms": dr["ms"]["fwd"],
            "plain_ms": dr["ms"]["plain_fwd"],
            "bound_ms": dr["bound"]["bound_ms"],
            "bound_by": dr["bound"]["bound_by"],
            "library_ms": dr["ms"]["sdpa_fwd"]}}
    # the kernels at the shapes of phase 13's generate: K1 at the cached
    # engine's prefill and decode steps, K2 at naive widths
    gen_shapes = {
        "ragged_paged_attention": {
            step: {"rows": c["rows"], "contexts": c["contexts"],
                   **{key: c[key] for key in (
                       "max_abs_err", "ms", "plain_ms", "bound_ms",
                       "bound_by")}, "library_ms": None}
            for step, c in kg.items()},
        "flash_attention_fwd": {
            name: {"shape": fl["cases"][name]["shape"],
                   "max_abs_err": fl["cases"][name]["max_abs_err"]["o"],
                   "ms": f["ms"]["fwd"], "plain_ms": f["ms"]["plain_fwd"],
                   "bound_ms": f["bound"]["bound_ms"],
                   "bound_by": f["bound"]["bound_by"],
                   "library_ms": f["ms"]["sdpa_fwd"]}
            for name, f in fl["fwd_only"].items()
            if name.startswith("generate_")}}
    src = "paddle_tpu_torch/csrc/flash_attention.cu"
    ref = "paddle_tpu/ops/pallas/flash_attention.py"
    flash_rows = [
        ("flash_attention_fwd", f"{ref}:61", "fwd", errs["o"],
         fl["ms"]["plain_fwd"], fl["ms"]["sdpa_fwd"]),
        ("flash_attention_bwd_dq", f"{ref}:154", "dq", errs["dq"],
         fl["ms"]["plain_bwd"], fl["ms"]["sdpa_bwd"]),
        ("flash_attention_bwd_dkv", f"{ref}:198", "dkv",
         max(errs["dk"], errs["dv"]), fl["ms"]["plain_bwd"],
         fl["ms"]["sdpa_bwd"])]
    rows = [{
        "name": "ragged_paged_attention", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
        "replaces": "paddle_tpu/ops/pallas/ragged_paged_attention.py:146",
        "max_abs_err": k["max_abs_err"], "ms": k["ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": None}] + [{
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "max_abs_err": err, "ms": fl["ms"][key], "plain_ms": plain,
            "bound_ms": fl["bounds"][key]["bound_ms"],
            "bound_by": fl["bounds"][key]["bound_by"], "library_ms": lib}
        for name, rep, key, err, plain, lib in flash_rows]
    for row in rows:
        paths = by_path[row["name"]]
        row["launches"] = sum(paths.values())
        row["launches_by_path"] = paths
        if row["name"] in spec_shapes:
            row["spec_shapes"] = spec_shapes[row["name"]]
            row["generate_shapes"] = gen_shapes[row["name"]]
    # K1 at phase 23's first step that read the host tier's mirror
    rows[0]["tiers_shapes"] = ti["over_pool"]["k1_mirror_step"]
    # K1 at a TP rank's heads (phase 25: 16 query, 4 kv), mixed batch
    k1tp = tpr["k1_per_rank_shape"]
    rows[0]["tp_shapes"] = {
        "heads": k1tp["heads"], "launches_by_rank": tpr["kernel_launches"],
        **{key: k1tp[key] for key in ("max_abs_err", "ms", "plain_ms",
                                      "bound_ms", "bound_by")},
        "library_ms": None}
    # K2-K4 at a hybrid-parallel rank's heads (phase 28: B 2, H 8)
    hk = hyb["k2_k4_rank_shape"]
    for row, key, err in ((rows[1], "fwd", hk["max_abs_err"]["o"]),
                          (rows[2], "dq", hk["max_abs_err"]["dq"]),
                          (rows[3], "dkv", max(hk["max_abs_err"]["dk"],
                                               hk["max_abs_err"]["dv"]))):
        row["hybrid_rank_shapes"] = {
            "shape": hk["shape"], "max_abs_err": err, "ms": hk["ms"][key],
            "plain_ms": hk["ms"]["plain_fwd" if key == "fwd"
                                 else "plain_bwd"],
            "bound_ms": hk["bounds"][key]["bound_ms"],
            "bound_by": hk["bounds"][key]["bound_by"],
            "library_ms": hk["ms"]["sdpa_fwd" if key == "fwd"
                                   else "sdpa_bwd"],
            "launches_by_rank": [
                n[row["name"]] for n in
                hyb["bf16_full"]["kernel_launches_per_rank"]]}
    # K2-K4 at a pipeline rank's microbatch (phase 29: B 1, H 16)
    pk = ppl["k2_k4_rank_shape"]
    for row, key, err in ((rows[1], "fwd", pk["max_abs_err"]["o"]),
                          (rows[2], "dq", pk["max_abs_err"]["dq"]),
                          (rows[3], "dkv", max(pk["max_abs_err"]["dk"],
                                               pk["max_abs_err"]["dv"]))):
        row["pipeline_rank_shapes"] = {
            "shape": pk["shape"], "max_abs_err": err, "ms": pk["ms"][key],
            "plain_ms": pk["ms"]["plain_fwd" if key == "fwd"
                                 else "plain_bwd"],
            "bound_ms": pk["bounds"][key]["bound_ms"],
            "bound_by": pk["bounds"][key]["bound_by"],
            "library_ms": pk["ms"]["sdpa_fwd" if key == "fwd"
                                   else "sdpa_bwd"],
            "launches_by_rank": [
                n[row["name"]] for n in
                ppl["bf16_full"]["kernel_launches_per_rank"]]}
    # K2-K4 at a ring chunk of phase 30 (b) (B 2, 1024 x 1024, H 16):
    # the diagonal (causal) and an earlier (whole) chunk
    for row, key, errk in ((rows[1], "fwd", ("o",)), (rows[2], "dq", ("dq",)),
                           (rows[3], "dkv", ("dk", "dv"))):
        row["cp_ring_chunk_shapes"] = {
            chunk: {"shape": c["shape"], "causal": c["causal"],
                    "max_abs_err": max(c["max_abs_err"][e] for e in errk),
                    "ms": c["ms"][key],
                    "plain_ms": c["ms"]["plain_fwd" if key == "fwd"
                                       else "plain_bwd"],
                    "bound_ms": c["bounds"][key]["bound_ms"],
                    "bound_by": c["bounds"][key]["bound_by"],
                    "library_ms": c["ms"]["sdpa_fwd" if key == "fwd"
                                          else "sdpa_bwd"]}
            for chunk, c in cp["k2_k4_ring_chunks"].items()}
        row["cp_ring_chunk_shapes"]["launches_by_rank"] = [
            n[row["name"]] for n in
            cp["bf16_full"]["kernel_launches_per_rank"]]
    # K2-K4 on phase 32 (a)'s ranks: a gang rank's shape is a hybrid
    # rank's (B 2, H 8), held above
    for row in rows[1:]:
        row["gang_rank_shapes"] = {
            "shape": hk["shape"], "same_as": "hybrid_rank_shapes",
            "launches_by_rank": [
                n[row["name"]] for n in
                gang["a_unbroken"]["kernel_launches_per_rank"]]}
    # K1 at phase 26's decode replica's first step after an import
    rows[0]["fleet_shapes"] = flt["disagg_bf16"]["k1_first_after_import"]
    # K1 at a TP rank's heads (phase 27: 16 query, 4 kv) with the host
    # tier's mirror as its second pool, and at the spec verify rows;
    # each path's launches by rank
    rows[0]["tp_tiers_shapes"] = {
        **tpf["tiers_bf16"]["k1_mirror_step"],
        "launches_by_rank": tpf["kernel_launches"]["tiers"]}
    rows[0]["tp_spec_shapes"] = {
        **tpf["spec_bf16"]["k1_verify_step"],
        "launches_by_rank": tpf["kernel_launches"]["spec"]}
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
