#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mxnet_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It serves and trains the full-width flash-attention TransformerLM,
trains ResNet-50 v1 through the port's own entry points (Gluon, and the
symbolic path of ``Module.fit``) and the DCGAN example's two nets, runs
the core op surface and ``MultiHeadAttention``, checkpoints, resumes and
hot-reloads the LM, feeds ``Module.fit`` from a record file, mirrors the
backward, serves an exported decode cell, trains Faster R-CNN at VGG16's
width and the SSD example through ``Module``, and holds every kernel
against its plain version:

1. setup: the card's name and power limit; build every kernel from
   ``mxnet_tpu_torch/csrc`` (one nvcc per source, in parallel); launch the
   toolchain probe ``add_one`` and time it beside ``x + 1``;
2. the flash-attention kernels against their plain version on the card:
   the bf16 tensor-core kernel (``sm90``) at the scoring shape (B=4, H=16,
   T=1024, D=64), the decode shape (B=1), phase 9's training and gradient
   check batches (B=8, B=2), D=128 at T=128 and a ragged T=100, the
   float32 kernel (``f32``, 3xTF32 on the tensor cores) at the same shapes
   in float32 and at D 16 and 32 in bfloat16 (gates ``TOL_*`` below:
   float32 absolute, bfloat16 absolute and over the largest output); both
   kernels causal at the short sequences the serving buckets send them
   (B=4, T 1, 2, 16 and 64), the sm90 kernel timed there; each kernel's
   row log-sum-exp (written for the backward) within ``TOL_LSE`` of the
   plain version's, and its O bitwise equal with and without it; then
   their times at the scoring and decode shapes (the f32 kernel also at
   B=8, ``MultiHeadAttention``'s shape, causal and not) beside the plain
   version's, the bound (the f32 kernel's at 3xTF32's 165 TFLOP/s, with the
   FMA rate's beside it) and ``scaled_dot_product_attention``'s (the
   yardstick; the port never calls it), with the sm90 kernel also timed
   writing lse and the f32 kernel timed on the same bf16 inputs as well;
3. scoring in float32: ``net(tokens)`` at B=4, T=1024 launches the kernel
   once per layer, and its logits agree with the same net's with dense
   attention;
4. serving in float32: four greedy ``generate`` requests (prompts of 16, 100,
   300 and 700 tokens, 8 new tokens each); every step is one forward through
   the kernel, and the tokens equal the dense net's except at a printed
   near-tie;
5. the main path, in bfloat16 (the configuration's dtype): every kernel
   count set to 0, then one scoring batch and the four requests, timed;
   the counts read after it;
6. one bfloat16 decode step under torch.profiler: host time through the
   step's ``CachedOp`` and eagerly, device time, the flash kernel's share
   and the kernels that take it (without a device trace: the CUDA-event
   stream time of the step's 12 flash launches);
7. the KV-cache decode path (``generate(kv_cache=True)``, ``beam_search``,
   ``save_params``/``load_params``) on a fresh float32 net with the same
   weights: the four greedy requests give phase 4's static-shape tokens
   (a difference only at a printed near-tie), one sampled request gives
   the static path's tokens under the same seeded RandomState, a beam of
   width 1 gives the greedy tokens and one of width 4 returns log-probs
   within ``TOL_BEAM`` of a teacher-forced rescoring, and a net loaded
   from a saved checkpoint decodes the same tokens; then in bfloat16 the
   four requests, timed per request and per decode step beside phase 5's
   static-shape times, and the cost of the out-of-place cache write.  The
   KV path runs no flash kernel: its attention is plain torch, as in the
   JAX package;
8. serving through the Symbol graph on a fresh float32 net with the same
   weights: the net traced to a Symbol, its JSON written and loaded back,
   its parameters saved with ``nd.save``; a ``BucketedPredictor`` on
   ``gpu(0)`` from the JSON and the file, warmed over its 33 buckets (3
   batch x 11 sequence, 12 flash launches each), the four prompts served
   against eager ``net(tokens)`` with no bucket built; then the main
   serving path in bfloat16 (re-traced after ``cast``): every kernel count
   set to 0, 32 requests from 4 client threads through a ``MicroBatcher``,
   the counts read after it (12 sm90 launches per batch, none on f32);
   each coalesced result bitwise against its row of the same batch
   dispatched again, and against the same request served alone (bitwise
   where both ran one bucket, else within ``TOL_COALESCED_BF16``); the
   dispatch and host-copy time per bucket; and a ``ResilientServer`` that
   sheds a burst with ``Overloaded`` and fails a request past its deadline
   with ``DeadlineExceeded``;
9. training: the flash backward K1b, two kernels routed as the forward:
   ``sm90`` (``csrc/flash_attention_bwd_sm90.cu``, bf16 at D 64/128, the
   tensor cores, the forward's lse) at the training and gradient check
   batches (B=8 and B=2, H=16, T=1024, D 64 and 128, causal and not),
   T=128, a ragged T=100, T=2 and T=7, against its plain version and
   against the f32 kernel on the same bf16 inputs, and bitwise equal when
   run twice; the 3xTF32 kernel ``f32`` (``csrc/flash_attention_bwd.cu``,
   the forward's lse) in float32 at the training shape, T=64 (D 16, 32)
   and T=100, and in bf16 at D 16 and 32, bitwise equal when run twice;
   all gated at ``TOL_BWD_*`` of each output's largest magnitude; both
   kernels' times beside the plain version's, the bound and the backward
   of ``scaled_dot_product_attention`` (the yardstick; the f32 kernel also
   non-causal), the sm90 kernel gated at ``BWD_SDPA_RATIO`` times the
   latter; a float32
   gradient check of a 2-layer full-width flash net against the same net
   with attention's gradient taken by autograd of the dense formula
   (``TOL_GRAD_F32``); then the training main path: the bf16 ``TrainStep``
   of ``experiments/lm_mfu_probe.py`` with ``Trainer("sgd", momentum 0.9,
   multi_precision)``, every kernel count set to 0, 6 steps on one batch
   of B=8, T=1024 (finite, falling loss; the first step's float32 master of
   one weight moved by -lr * rescale_grad * grad, within ``TOL_MASTER``;
   12 sm90 K1 and 12 sm90 K1b launches and no f32 one per step; the
   gradient check's 2 K1b launches all on f32), its step time,
   tokens/s and peak memory, then one step under torch.profiler;
10. the vision path, which runs none of the kernels above (PyTorch's
   cuDNN convolutions and pooling, its batch-norm kernels): the seven
   model-zoo goldens of ``tests/golden`` in float32 within ``TOL_GOLDEN``;
   then the main path, ``bench.py``'s ResNet-50 configuration:
   ``get_model("resnet50_v1")``, Xavier gaussian 'in' magnitude 2 from seed
   0, bf16 with float32 masters (``Trainer("sgd", lr 0.05, momentum 0.9,
   wd 1e-4, multi_precision)``), hybridized, ``VISION_STEPS`` steps on one
   resident class-correlated batch of B=256 at 224x224 (finite loss, the
   last below the first; no kernel launch counted); the first BatchNorm's
   moving mean after step 1 within ``TOL_BN_MEAN`` of 0.1 x the batch mean
   of its input, and every moving variance moved off 1; the first step,
   the median of the others, images/s and peak memory; an eval-mode
   forward at B=256 (an image's logits the same in two batches, within
   ``TOL_EVAL_ROW``) and its images/s; one step's kernels by group
   (``KERNEL_GROUPS``) and its host gaps; a ``DataLoader`` feeding two
   batches to the card, scored with ``metric.Accuracy``; and one float32
   step of ``resnet18_v1`` (B=2, 64x64) against the same step on the CPU
   (``TOL_GRAD_CPU``, ``TOL_AUX_CPU``);
11. the symbolic path, ``bench.py``'s own: the ResNet-50 v1 symbol under
   ``SoftmaxOutput``, ``Module(context=gpu(0))`` bound with bf16 data
   (bf16 weights, float32 BatchNorm parameters and statistics), Xavier
   gaussian 'in' magnitude 2 from seed 0, SGD lr 0.05, momentum 0.9, wd
   1e-4, f32 masters on the ``tpu_sync`` kvstore (the optimizer runs on
   its ``pushpull``), ``fit`` for 3 epochs over an ``NDArrayIter`` of 8
   batches of B=256 resident on the card, the NLL kept on the card and one
   synchronisation per epoch: ``bench.py:390-392``'s loss check, no
   kernel launch counted, the step and images/s over the last two epochs
   and peak memory beside phase 10's Gluon step, one step's host enqueue
   time, kernel time and host gaps; resnet18_v1 in float32 (B=2, 64x64),
   one Module step against one Gluon step from the same weights (each
   parameter within ``TOL_MODULE_GLUON`` of its largest change, the moving
   statistics within ``TOL_MODULE_AUX``); then the full-width
   TransformerLM's bf16 symbol under ``SoftmaxOutput(preserve_shape=True,
   normalization="valid")``, bound at phase 9's B=8, T=1024, every kernel
   count set to 0, 3 steps of ``forward_backward`` + ``update`` (12 sm90
   K1 and 12 sm90 K1b launches per step through ``Executor.backward``,
   none on f32; finite NLL that falls), its step beside phase 9's;
12. the core op and ``nd`` surface, ``MultiHeadAttention`` and DCGAN:
   every deterministic op of the core surface (``core_op_cases``: the
   comparisons, ``mod``, ``clip``, ``dot``, the slice family, ``Pad``,
   ``gather_nd``/``scatter_nd``, ``linalg_*``, ``norm``, ``argmin``, the
   creation and loss ops) on small seeded inputs on the card against the
   same op on the CPU, float32 (``TOL_OPS_*``, which a float id or a 0/1
   result off by one fails; integers exact), with the gradients of the differentiable ones; the random ops on the
   card: mean and variance of 10^6 draws of every distribution within
   ``RANDOM_SE`` standard errors, ``shuffle`` a permutation, ``randint`` in
   range, ``mx.random.seed`` repeating draws bitwise while consecutive
   draws differ, and the draws taken from the CUDA generator (the CPU
   generators untouched); ``MultiHeadAttention`` at the LM's width (units
   1024, 16 heads of 64, B=8, T=1024, bf16, hybridized, weights from seed
   0), non-causal (its default) and causal, each with every kernel count
   set to 0 before one forward and backward under ``record()`` and read
   after (exactly 1 sm90 K1 and 1 sm90 K1b, none on f32), the output and
   the input's gradient within ``TOL_MHA`` of the plain formula in float32
   on the same weights; then the same two runs in float32, MXNet's
   default dtype (no ``cast``: exactly 1 f32 K1 and 1 f32 K1b, none on
   sm90; within ``TOL_MHA_F32`` of the formula in float64); each block's
   forward plus backward timed beside K1, K1b, SDPA's forward and backward
   on the same q/k/v and the ``.contiguous()`` copies of its strided q/k/v
   views; and the JAX package's DCGAN example (``example/gluon/dcgan.py``)
   at upstream MXNet's widths (``DCGAN``): 20 alternating D and G Adam
   steps on a resident synthetic set, z drawn with ``nd.random.normal``
   on the card each step, ``errD.backward()`` and ``errG.backward()`` on
   the (64,) loss vectors (finite losses, G's output in [-1, 1]), the
   step time and peak memory;
13. training state: every optimizer (the 13 of the JAX package and
   RMSProp centered) takes ``OPT_STEPS`` float32 steps through
   ``FusedUpdater.update_all`` on one LM layer's shapes
   (``LAYER_SHAPES``) on the card and on the CPU, every parameter and
   state within ``TOL_OPT_CARD`` of its largest; SGLD instead repeats
   bitwise under one seed and draws from the card's generator; the
   FusedUpdater equals the per-key Updater bitwise on the card for the
   nine fused ones, in float32 and in bf16 with float32 masters.  Then the
   full-width LM at phase 9's batch (bf16, float32 masters,
   ``Trainer("adam")``, the parameters named ``lm_*``): run A takes
   ``RESUME_SAVE_AT`` steps, ``checkpoint.save_trainer`` writes it once
   synchronously and once through an async ``CheckpointManager`` into a
   temporary directory under ``build/``, and it takes ``RESUME_STEPS`` more
   while the write runs; run B takes the same steps uninterrupted; run C,
   a fresh net and trainer, ``restore_or_initialize``s and takes the last
   ``RESUME_STEPS``; the three runs use PyTorch's deterministic algorithms
   (the embedding's backward sums without atomics): B's and C's losses and
   parameters equal A's bitwise; 12 sm90 K1 and 12
   sm90 K1b and one ``update_all`` per step; the checkpoint's size,
   ``sync_save_s``, ``async_block_s``, ``async_total_s``,
   ``block_ratio`` and ``restore_s``.  A bf16 ``BucketedPredictor`` over
   the LM's symbol, built with B's weights, ``hot_reload``s the
   directory: ``loaded_step`` is the saved step, ``SERVE_COMPILES`` stays
   flat and the served logits are within ``TOL_RELOAD`` of the restored
   net's eager ones.  Last, ``resnet18_v1`` in float32 (B=2, 64x64)
   through ``Module.fit(checkpoint_dir=...)``, with no store and on the
   ``tpu_sync`` store, under deterministic algorithms (with cuDNN's
   default ones two identical fits differ in the last bits), stopped
   after epoch 1 and resumed by a fresh Module, against an uninterrupted
   fit (``TOL_MODULE_GLUON``, ``TOL_MODULE_AUX``), and
   ``save_optimizer_states``/``load_optimizer_states`` bitwise.  Phases 9,
   11 and 13 check one ``update_all`` per step and no per-key updater
   call, and phases 9 and 11 print one optimizer step's kernel launches
   beside the per-key loop's;
14. the record-file input path, in a temporary directory under
   ``build/``: (a) 2,048 synthetic ImageNet-shaped images (uint8 256x256x3,
   ``.npy`` payloads, labels 0-999, seed 0) written to a ``.rec`` and its
   ``.idx``, timed; (b) ``ImageRecordIter`` (B=256, 224x224, shuffled,
   random crop and mirror, ImageNet's mean and std, ``device_augment`` to
   bf16, ``min(16, cpu_count)`` threads, 4 batches read ahead) alone: every
   batch a bf16 (256, 3, 224, 224) tensor on the card, an epoch's labels a
   permutation, images/s over a warm epoch; ``device_augment`` in float32
   against the host path under the same seed (no mirror, whose flips the
   two paths draw from different streams; one thread) within
   ``TOL_REC_F32``, labels equal; (c) phase 11's ResNet-50 ``Module.fit``
   (3 epochs of 8 batches) fed by that iterator: finite NLL, no kernel of
   the repo launched, step, images/s and peak memory beside phase 11's
   resident step; then one more epoch, from a fresh iterator, under
   torch.profiler: its device time per step (uploads, augment and the
   step's kernels) and the fed step less it; (g) ``ImageRecordDataset`` over (a)'s file
   through a ``DataLoader``, one batch on the card equal to the images
   written; (d) the native runtime built from ``src/runtime`` with g++,
   2,048 raw uint8 3x224x224 records through ``TensorRecordIter`` (B=256,
   shuffled) to the card: an epoch's labels a permutation of those
   written, a sampled record's bytes equal, images/s; (e)
   ``MXNET_BACKWARD_DO_MIRROR``: one resnet18_v1 float32 Module step
   (B=2, 64x64, deterministic algorithms) mirrored against unmirrored,
   gradients and moving statistics bitwise (else within ``TOL_MIRROR`` of
   each one's largest, with the reason); phase 11's ResNet-50 Module on a
   resident batch, mirrored and not, ``MIRROR_STEPS`` steps each: step
   time and peak memory, each step's NLL within ``TOL_MIRROR_LOSS``
   (relative) of the unmirrored run's; then ``MIRROR_DET_STEPS`` steps
   each under deterministic algorithms, parameters and moving statistics
   after them bitwise (else within ``TOL_MIRROR``); phase 11's LM
   ``Module`` leg mirrored, every kernel count set to 0 before it and read
   after: 24 sm90 K1 and 12 sm90 K1b launches a step, none on f32, finite
   falling NLL within ``TOL_MIRROR_LOSS`` of phase 11's for the same
   weights, batch and steps, its step and peak beside phase 11's; (f) ``export_decode_step`` of phase 3's float32
   net, loaded by ``predictor.Predictor`` on the card, 8 greedy tokens
   from a 16-token prompt with the cache outputs fed back as inputs,
   equal to ``generate(kv_cache=True)``'s;
15. the one-program training step, each run a captured CUDA graph after
   one eager step (``gluon.wholestep.StepGraph``): (a) phase 9's LM (bf16
   weights, float32 masters, SGD momentum 0.9, lr 0.01) for 6 steps
   through ``WholeStepCompiler(net, SoftmaxCrossEntropyLoss(), trainer)``
   with ``MXNET_WHOLE_STEP=1`` against the fused path (the same compiler
   without it) from the same weights and batches, under deterministic
   algorithms: losses, weights and optimizer states bitwise (else within
   ``TOL_CAPTURED``), one capture, 12 sm90 K1 + 12 sm90 K1b counted at
   the eager step and at the capture and none at a replay, 12 of each
   flash kernel by name in a profiled replay; the median of steps 2-6
   beside the fused path and phase 9, the replay call's host time, peak
   memory; dropout 0.5 under replay (an MLP at lr 0: each replay a new
   mask), then a new batch size captured again with its reason; (b)
   ``MXNET_AMP=bf16`` on the LM in float32 with Adam against the f32
   policy (losses within ``TOL_AMP_BF16``, weights and states float32, the
   f32 kernels); (c) ``MXNET_AMP=fp16`` on phase 12's
   ``MultiHeadAttention`` (Adam, ``L2Loss``; scale 1024, window 3): the
   scale doubles after the window and halves on an inf batch, whose step
   holds weights, Adam states and the applied-step counter bitwise; (d)
   2-bit compression on (a)'s configuration against the fused compressed
   path: weights and residuals bitwise, the buckets; (f)
   ``SuperStepCompiler`` K=4: 8 steps as 2 supersteps against 8 whole
   steps bitwise, a replayed superstep's time per step and peak; (e)
   ``Module`` with ``MXNET_FUSED_STEP=1``: phase 11's ResNet-50 ``fit``
   (``bench.py``'s loss check, step and images/s beside phase 11's),
   resnet18_v1 3 fused steps against 3 standard ones bitwise, phase 11's
   LM leg (12 + 12 sm90 launches at the eager step and the capture,
   finite falling NLL);
16. observability and training resilience, with the flight recorder, the
   memory ledger, goodput and the run journal on (files in a temporary
   directory under ``build/``): (a) phase 9's LM (bf16, float32 masters,
   SGD momentum 0.9, ``WholeStepCompiler``) for ``SUP_STEPS`` steps through
   ``gluon.TrainingSupervisor`` (snapshots every ``SUP_SNAPSHOT_STEPS``
   into pinned host buffers) with a ``trainer.step`` raise at step
   ``SUP_FAULT_AT``, against as many uninterrupted steps, under
   deterministic algorithms: losses, weights and optimizer states
   bitwise, the restore in place, one capture in the run, 12 + 12 sm90
   launches at the eager step and the capture; (b) what the instruments
   cost a replayed step (per-step paired interleave, ``COST_PAIRS``
   pairs): the supervisor, a snapshot and its share amortized over 50
   steps, the flight recorder, the ledger and goodput each on against
   off; (c) on a float32 MLP, divergence (``raise``: ``DivergenceError``
   with a post-mortem; ``rewind``: the snapshot restored bitwise) and a
   ``trainer.step`` delay of ``STALL_DELAY_X`` x the step's EWMA raising
   ``TrainingStalledError`` at its ``STALL_FACTOR`` x deadline; (d) the
   ledger's live bytes by tag over the LM beside
   ``torch.cuda.memory_allocated()`` (at least ``ATTRIBUTION_FLOOR`` %
   tagged), a real CUDA out-of-memory error inside ``oom_guard`` re-raised
   as ``DeviceMemoryError`` with a post-mortem and the next LM step
   running, ``MXNET_HBM_BUDGET_MB`` below the tracked bytes raising
   ``HBMBudgetError``, and a headroom refusal demoting a superstep of 4 to
   4 whole steps with the same losses; (e) a replayed whole step inside
   ``analysis.no_sync()`` syncing nothing; (f) ``profiler.dump_profile()``
   and ``flight.dump()`` over 2 replayed steps as Chrome traces, 12 of each
   flash kernel per replay inside ``whole_step`` spans (up to
   ``PROFILE_TRIES`` profiler sessions), (a)'s goodput account
   (``retry_replay``, ``recompile`` equal to the capture time,
   unattributed) and ``report`` reading the journal back; (g) phase 11's
   LM ``Module`` leg through ``fit(supervise=True)`` with one injected
   transient against ``fit()``, bitwise; (h) ``prefetch_to_device`` over
   phase 14's record file read on the host: images/s to the card, an
   ``OSError`` respawning the worker with no batch lost, corrupt records
   skipped within the budget and one more raising
   ``DataSkipBudgetError``;
17. the program introspector, the tuner, decode and the registry: (a)
   phase 9's LM whole step (bf16, ``INTRO_STEPS`` steps): its counted
   matrix-product and attention flops exactly the probe formula's
   (``experiments/lm_mfu_probe.py:123-127``), MFU over the card's step
   time (the CUDA event pairs around each replay) against the H100 table's
   peak, strictly inside (0, 1) and within ``TOL_MFU`` of probe flops over
   the synchronized host median of steps 2-6 over the peak, the per-layer
   rows and at least ``ATTRIBUTION_FLOOR`` % attributed, the
   introspector's cost per replayed step (``INTRO_PAIRS`` interleaved
   pairs); ResNet-50's ``Module`` step (phase 11's configuration) counted
   and its MFU; (b) the perf sentinel: a baseline of the LM step written,
   re-armed at half its time, firing exactly once in ``SENTINEL_STEPS``
   steps, a ``ResilientServer``'s readyz failing ``perf_regression`` and
   passing after ``refresh_baseline``; (c) ``autotune.tune()`` on the LM
   (K in ``TUNE_KS``, ``TUNE_PAIRS`` pairs, buckets ``TUNE_BUCKETS_MB``,
   the serving lattice from phase 8's recorded traffic and the hold window
   from its dispatch EWMA), its decision and evidence, a second
   ``tune()`` with no measured run, a fresh ``BucketedPredictor`` and
   ``MicroBatcher`` reading the persisted lattice and wait; (d)
   ``DecodeEngine`` serving ``ToyLM`` at the LM's widths (``DECODE``; 64
   slots, pages of 16 tokens, 64 pages; the recurrence's matrices scaled
   by 4/sqrt(dim) so that it contracts as at the JAX package's width),
   ``warmup()`` capturing the whole lattice, ``DECODE_SEQS`` sequences
   joining and leaving: replays equal steps, no capture after warmup,
   every 8th sequence's tokens equal to its solo run and the 4 shortest to
   the same engine on the CPU (exact, but for a printed near-tie: the
   float64 top-2 logits within ``NEAR_TIE``), tokens/s, a step's host
   clock and the most used key's replay in device time; an EDF shed at
   admission, a mid-flight expiry and a KV eviction, each typed; (e)
   ``ModelRegistry``: ``REG_MODELS`` full-width bf16 LMs (seeds 0-3,
   batch buckets ``REG_BATCH``, sequence buckets ``REG_SEQ``), the reclaim
   order (a decode engine's KV pages first, then buckets, then weights),
   a readmitted model's logits bitwise its logits before the eviction
   (both timed), then every kernel count set to 0, ``REG_REQUESTS``
   requests from 4 tenant threads under a budget for two models, typed
   failures only, 12 sm90 K1 launches per dispatch and bucket build,
   counted;
18. RNN and sequences, which run none of the kernels above (the
   recurrence is a loop over time of cuBLAS products and PyTorch's
   pointwise kernels, as the JAX package leaves it to XLA): (a)
   ``example/gluon/word_language_model.py``'s ``RNNModel`` at the upstream
   example's large setting (``RNN_LM``: embed and hidden 1500, 2 LSTM
   layers, dropout 0.65, untied, PTB's vocabulary of 10,000), hybridized,
   float32, SGD lr 1.0 with ``clip_global_norm`` at 0.25 x bptt x batch,
   B=32, bptt 35, ``RNN_STEPS`` steps over the example's synthetic Markov
   corpus widened to 10,000 ids, with every kernel count set to 0 before
   and read after (all 0): ms a step, tokens/s, one step's launches and
   device-idle share under torch.profiler, a falling loss; then
   ``RNN_GEN`` greedy tokens at B=1 carrying the state; (b) the ``RNN`` op
   (lstm and gru, T=35, B=4, 2 x 1500) and ``_contrib_ctc_loss`` (T=64,
   N=32, C=1500, with lengths, one row impossible) on the card against the
   port's own CPU run in float64, outputs and gradients within
   ``TOL_RECURRENT``; (c) ``example/rnn/lstm_bucketing.py`` at its defaults
   through ``BucketingModule.fit`` (one epoch of its synthetic corpus):
   the buckets bound, ms a batch per bucket, validation perplexity before
   and after; then the same stack as a ``FusedRNNCell`` over one bucket
   for ``FUSED_BATCHES`` batches against its ``unfuse()`` stack
   (``TOL_UNFUSE``); (d) ``DecodeEngine`` over ``CellModel`` of two
   ``LSTMCell(1500)`` (``CELL_DECODE``), 8 staggered requests of 32 tokens,
   each equal to its solo run, tokens/s and a step's host clock;
19. detection, the slice of the rest of the op registry, whose two
   hand-written kernels are N (greedy NMS, ``csrc/nms.cu``) and R (ROI
   pooling forward and backward, ``csrc/roi_pooling.cu``), with every
   kernel count set to 0 before (a) and before (b) and read after each:
   (a) ``example/rcnn/train_end2end.py``'s Faster R-CNN loop at VGG16's
   width (``RCNN``: ``vgg16``'s features to conv5_3 + ReLU, a 512-wide RPN,
   fc 4096-4096, 21 classes, 600x1000, B=1, ``Proposal`` at its defaults,
   128 ROIs to ``ROIPooling`` 7x7, SGD momentum 0.9 wd 5e-4, float32,
   ``RCNN["steps"]`` steps on one synthetic batch): ms a step, one profiled
   step's device-idle share, peak memory, the four losses (finite, the
   total falling), exactly 1 N, 1 R forward and 1 R backward a step; (b)
   ``example/ssd/train_ssd.py``'s ``build_ssd`` through ``Module`` at its
   own configuration (``SSD``), one step against the CPU (outputs and
   gradients within ``TOL_SSD_CPU``), then ``SSD["batches"]`` batches with
   1 N launch a forward; (c) the SSD ops at SSD-300's shapes
   (``SSD300``: 8,732 anchors, B=32, 21 classes) on the card against the
   CPU (anchors, masks, class targets, class ids and scores exact, loc
   targets and boxes within ``TOL_BOX_CPU``), their kernels' time; (d) N at
   (a)'s and (c)'s shapes and R at (a)'s against their plain versions,
   bitwise and repeatable, with device, call and plain times beside the
   bound; (e) the slice's ops on the card against the CPU
   (``TOL_CONTRIB``), ``Custom`` on CUDA tensors and refused inside
   ``MXNET_FUSED_STEP``'s capture; then a ``detection`` JSON line;
20. a ``kernels`` JSON line (the forward kernels' ``launches`` are phase
   8's, with phase 9's as ``training_launches``, phase 11's LM leg's as
   ``module_launches``, phase 12's bf16 ``MultiHeadAttention`` runs' as
   ``mha_launches``, its float32 runs' as ``mha_f32_launches`` and phase
   13's LM training steps' as ``resume_launches`` and phase 14's mirrored
   LM leg's as ``mirror_launches`` and phase 15's captured steps' as
   ``onestep_launches`` and phase 17's registry flood's as
   ``registry_launches``; the two K1b kernels'
   are phase 9's main path, with phase 11's as ``module_launches``, phase
   12's as ``mha_launches`` and ``mha_f32_launches``, phase 13's as
   ``resume_launches``, phase 14's as ``mirror_launches`` and phase 15's
   as ``onestep_launches``, the f32 one's 0 on the main path; the f32
   kernels' ``bound_ms`` at 3xTF32's rate, ``fma_bound_ms`` at the CUDA
   cores' float32 FMA rate; every entry's ``recurrent_launches`` is phase
   18 (a)'s count and ``detection_launches`` phase 19 (a) and (b)'s; ``nms``
   has (a)'s launches as ``launches`` and (b)'s as ``ssd_launches``, its
   times at (a)'s shape and (c)'s under ``multibox``; ``roi_pooling`` has
   (a)'s forward and backward launches and times), after the
   ``recurrent`` and ``detection`` JSON lines, then the last line
   ``{"ok": true, "device": {...}}``.

The language model is ``experiments/lm_mfu_probe.py``'s default width
(vocab 32768, dim 1024, 16 heads, ffn 4096, 12 layers, max_len 1024;
about 219 M parameters) with random weights from seed 0.  Nothing is cut
but the number of training steps (6, where the probe times 20) and the
gradient check's depth (2 layers).  ResNet-50 v1 runs at full width and
depth (about 25.6 M parameters); phase 10 cuts only the steps (8, where
``bench.py`` times 16 after 8 to warm up); phase 11 runs ``bench.py``'s 3
epochs of 8 batches, on data drawn on the card (the same recipe, torch's
generator in place of numpy's).  Phase 11's LM leg cuts the steps to 3.
Phase 12's DCGAN runs 20 steps of upstream MXNet's example at its default
widths (the JAX package's copy of the example defaults to narrower nets).
Phase 13's LM runs cut the steps to 5 (3 before the checkpoint, 2 after).
Phase 14's record set is 2,048 images (one epoch of ``bench.py``'s 8
batches; ImageNet's is 1.28 M), its mirrored runs take 5 ResNet-50 steps
and 3 LM steps.  Phase 15's LM runs take 6 steps (4 compressed, 8 and 4
more as supersteps), its fp16 block 7, its LM ``Module`` leg 4.  Phase
16's LM runs take 8 steps, its ``Module`` leg 3.  Phase 17's LM step takes
7 steps and 12 interleaved, its ResNet-50 ``Module`` 3, the tuner's sweep 6
pairs per K; its decode traffic is 128 sequences, its registry flood 64
requests.  Phase 19's R-CNN takes 8 steps on one batch of synthetic
boxes (no VOC images or pretrained VGG16 in the repository), the SSD
example 20 batches.  The host has no image
decoder (no cv2, no PIL), so the records carry ``.npy`` and raw
payloads.

Times: ``device`` is the CUDA-event time of 20 back-to-back calls queued
behind a spin kernel, per call (L2 warm): the kernels and the gaps between
them, without the host's enqueue.  ``call`` is the median of 25 CUDA-event
pairs around single calls, which on an idle card includes the host's
enqueue.  Both are printed; the ``kernels`` line's ``ms``, ``plain_ms`` and
``library_ms`` are device times.  torch.profiler serves only phase 6's
breakdown: it needs CUPTI's tracing, which a machine may deny or drop.

Float32 comparisons run with TF32 off for matrix products and cuDNN
(``torch.backends.cuda.matmul.allow_tf32 = False``,
``torch.backends.cudnn.allow_tf32 = False``), so float32 means IEEE float32.

Any failed check ends the script with a non-zero exit and no result line.
Without a CUDA device, or outside a checkout, it exits non-zero at once.
"""
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = dict(vocab=32768, dim=1024, num_layers=12, num_heads=16,
              ffn_dim=4096, max_len=1024)
PROMPTS = (16, 100, 300, 700)
SHORT_T = (1, 2, 16, 64)   # phase 2's short sequences (serving buckets)
MAX_NEW = 8
SCORE_BATCH = 4
TOL_F32 = 1e-4      # kernel vs plain, float32 (the reference's flash pin)
TOL_BF16 = 3e-2     # kernel vs plain, bfloat16 (the reference's bf16 pin)
# bfloat16 kernel vs plain, max |out - ref| over max |ref|.  The absolute pin
# was set for outputs of order 1; at T=1024 the non-causal outputs are
# about 0.05.  Two roundings to bf16 of the same value differ by at most
# one ulp, 2^-7 of it, so this allows two ulps of the largest output.
TOL_BF16_REL = 2.0 ** -6
# flash vs dense logits through all 12 layers: the reference's logit pin
TOL_LOGITS_F32 = 1e-4
# a coalesced bf16 request against the same request served alone at
# another bucket, max |diff| over its valid logits.  The batch's other
# shape changes the GEMMs' accumulation order in all 12 layers, and the
# logits (up to about 7.8 here) are rounded to bf16, whose ulp is 2^-5 in
# [4, 8): the H100 read up to 3 ulps (9.4e-2, PERF.md), this allows 4.
# Another request's rows or padding leaking in move logits by their scale.
TOL_COALESCED_BF16 = 0.125
NEAR_TIE = 1e-4     # top-2 dense logits closer than this may flip argmax
TOL_BEAM = 1e-3     # beam log-prob vs a teacher-forced rescoring, float32
BEAM_PROMPT = 100   # the prompt of the sampled, beam and checkpoint checks
TRAIN_BATCH = 8     # phase 9's main path: B=8, T=1024, as lm_mfu_probe's
TRAIN_STEPS = 6
GRAD_LAYERS = 2     # phase 9's float32 gradient check: 2 layers, B=2
GRAD_BATCH = 2
# K1b vs plain, max |grad - ref| over max |ref| of each of dq, dk, dv:
# float32 at the flash forward's pin, bfloat16 at the reference's bf16 pin
TOL_BWD_F32 = 1e-4
TOL_BWD_BF16 = 3e-2
# the sm90 forward's row log-sum-exp against the plain version's
# (torch.logsumexp of the float32 scores), absolute: the kernel's m + log l
# sums the same exponentials in another order
TOL_LSE = 1e-3
# the sm90 K1b's device time against the backward of SDPA in the same run
BWD_SDPA_RATIO = 3.0
# K1b's parameter gradients through 2 full-width layers against the same
# net with a dense-formula attention gradient, float32, max |diff| over the
# gradient's largest magnitude
TOL_GRAD_F32 = 1e-3
# the first training step's float32 master of one weight against the start
# plus -lr * rescale_grad * grad (momentum is 0 before it, wd is 0), max
# |diff| over max |step|: the same float32 sum in another order differs by
# an ulp of the weight, a few 1e-3 of the step
TOL_MASTER = 1e-2
H100_BF16_FLOPS = 989e12
H100_F32_FLOPS = 67e12   # float32 FMAs on the CUDA cores
# TF32 on the tensor cores; a float32 product to float32 accuracy takes three
# (3xTF32), so the f32 kernels' operations run at a third of it
H100_TF32_FLOPS = 495e12
H100_3XTF32_FLOPS = H100_TF32_FLOPS / 3
H100_BYTES = 3.35e12


class CheckFailed(Exception):
    pass


def check(ok, what):
    if not ok:
        raise CheckFailed(what)


def time_ms(fn, iters=25, warmup=3):
    """Call time: median of ``iters`` CUDA-event pairs around single calls
    of ``fn`` (L2 warm).  On an idle card the pair also brackets the host's
    enqueue, so a short kernel reads as its launch cost."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in ev:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def device_ms(fn, iters=20):
    """Device time: a CUDA-event pair around ``iters`` back-to-back calls of
    ``fn`` (after a warm-up call; L2 warm), per call.  The calls are
    enqueued while the stream is held by a spin kernel, so the pair
    brackets the kernels and the gaps between them, not the host's
    enqueue; the spin grows until it outlasts the enqueue."""
    import torch
    fn()
    torch.cuda.synchronize()
    cycles = 20_000_000            # about 10 ms at the H100's 1.98 GHz
    for _ in range(4):             # up to about 0.65 s
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        covered = not start.query()    # the spin still ran: nothing waited
        torch.cuda.synchronize()
        if covered:
            break
        cycles *= 4
    check(covered, "the host's enqueue outlasted a 0.65 s spin")
    return start.elapsed_time(end) / iters


def attention_bound_ms(B, H, T, D, causal, itemsize, flops_rate,
                       ops_per_pair=4, tensors=4):
    """Least time for the work this input needs: the larger of its bytes
    (``tensors`` (B, H, T, D) tensors, each read or written once: q, k, v
    and o for the forward) over the memory rate and its operations
    (``ops_per_pair`` * D per unmasked (q, k) pair: 4 for the forward's two
    products) over the peak rate."""
    pairs = T * (T + 1) // 2 if causal else T * T
    flops = float(ops_per_pair) * B * H * D * pairs
    nbytes = float(tensors) * B * H * T * D * itemsize
    t_ops, t_bytes = flops / flops_rate * 1e3, nbytes / H100_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--id=0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip()


def phase_setup(mx):
    """Card, build, and the toolchain probe K0 against ``x + 1``."""
    import torch
    from mxnet_tpu_torch.kernels import _build, add_one
    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    log = _build.build(force=True)
    print(f"build: {time.perf_counter() - t0:.2f} s for {sorted(log)} "
          f"(nvcc in parallel)")
    for name, entry in sorted(log.items()):
        usage = [ln.strip() for ln in entry["log"].splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"  {name}: {entry['seconds']:.2f} s; " + " | ".join(
            sorted(set(usage))))
    x = torch.arange(8 * 128, dtype=torch.float32, device="cuda").reshape(8, 128)
    out = add_one.add_one(x)
    torch.cuda.synchronize()
    check(torch.equal(out, x + 1), "add_one probe disagrees with x + 1")
    k0 = {"call": time_ms(lambda: add_one.add_one(x)),
          "plain_call": time_ms(lambda: x + 1),
          "ms": device_ms(lambda: add_one.add_one(x)),
          "plain_ms": device_ms(lambda: x + 1),
          "library_ms": device_ms(lambda: torch.add(x, 1.0)),
          "bound_ms": 2 * x.numel() * 4 / H100_BYTES * 1e3}
    print(f"K0 add_one probe: built, launched, exact; (8, 128) f32: call "
          f"{k0['call']:.4f} ms vs x + 1 {k0['plain_call']:.4f} ms; device "
          f"{k0['ms']:.4f} ms vs x + 1 {k0['plain_ms']:.4f} ms, torch.add "
          f"{k0['library_ms']:.4f} ms; bound {k0['bound_ms']:.2e} ms (bytes)")
    return k0


def phase_kernel(mx):
    """Each flash kernel against the plain version, then their times."""
    import torch
    from mxnet_tpu_torch.kernels import flash_attention as kfa
    gen = torch.Generator(device="cpu").manual_seed(0)

    def qkv(B, H, T, D, dtype):
        return [torch.randn(B, H, T, D, generator=gen).to("cuda", dtype)
                for _ in range(3)]

    errs = {}      # (variant, dtype, B, T, D, causal) -> (abs, rel) err
    lse_errs = {}  # (variant, B, T, D, causal) -> lse abs err
    short_times = {}   # T -> ({name: device ms}, bound) at B=4, bf16
    cases = [(4, 16, 1024, 64, None), (1, 16, 1024, 64, None),
             (TRAIN_BATCH, 16, 1024, 64, None),     # phase 9's main path
             (GRAD_BATCH, 16, 1024, 64, None),      # and its gradient check
             (2, 3, 128, 16, 32), (2, 3, 128, 32, 32), (2, 3, 128, 128, 32),
             (1, 2, 100, 64, None)]
    for B, H, T, D, blk in cases:
        for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
            variant = kfa._variant(dtype, D)
            for causal in (False, True):
                q, k, v = qkv(B, H, T, D, dtype)
                before = kfa.VARIANT_LAUNCHES[variant]
                if blk is None:
                    out = kfa.flash_attention_fwd(q, k, v, D ** -0.5, causal)
                else:   # through the op, whose block only sets divisibility
                    out = mx.nd.flash_attention(q, k, v, causal=causal,
                                                block_q=blk, block_k=blk)
                ref = kfa.dense_reference(q, k, v, D ** -0.5, causal)
                torch.cuda.synchronize()
                check(kfa.VARIANT_LAUNCHES[variant] == before + 1,
                      f"flash at D={D} {dtype} did not launch {variant}")
                err = (out.float() - ref.float()).abs().max().item()
                rel = err / ref.float().abs().max().item()
                check(out.shape == ref.shape and out.dtype == dtype
                      and bool(torch.isfinite(out).all()),
                      f"flash output malformed at {(B, H, T, D)} {dtype}")
                what = (f"flash {variant} vs plain at B={B} H={H} T={T} D={D} "
                        f"{dtype} causal={causal}")
                check(err <= tol, f"{what}: max err {err:.3e} > {tol}")
                check(dtype != torch.bfloat16 or rel <= TOL_BF16_REL,
                      f"{what}: max err / max |ref| {rel:.3e} > "
                      f"{TOL_BF16_REL:.3e}")
                errs[(variant, dtype, B, T, D, causal)] = (err, rel)
                line = (f"  flash {variant:4s} B={B} H={H} T={T} D={D} "
                        f"{str(dtype)[6:]} causal={causal}: max err "
                        f"{err:.3e}, over max |ref| {rel:.3e}")
                # the row log-sum-exp the backward reads, and O unchanged
                # by writing it
                o_lse, lse = kfa.flash_attention_fwd(
                    q, k, v, D ** -0.5, causal, return_lse=True)
                _, lse_ref = kfa.dense_reference(
                    q, k, v, D ** -0.5, causal, return_lse=True)
                torch.cuda.synchronize()
                check(torch.equal(o_lse, out), f"{what}: O with lse "
                      "differs from O without")
                lse_err = (lse - lse_ref).abs().max().item()
                check(lse_err <= TOL_LSE, f"{what}: lse max err "
                      f"{lse_err:.3e} > {TOL_LSE}")
                lse_errs[(variant, B, T, D, causal)] = lse_err
                line += f"; lse max err {lse_err:.3e}, O bitwise equal"
                print(line)
    # the short sequences the serving buckets send through the kernels
    # (phase 8), causal: T below both kernels' q and k tiles (and the sm90
    # kernel's TMA boxes)
    for T in SHORT_T:
        for dtype, tol in ((torch.bfloat16, TOL_BF16), (torch.float32, TOL_F32)):
            variant = kfa._variant(dtype, 64)
            q, k, v = qkv(4, 16, T, 64, dtype)
            before = kfa.VARIANT_LAUNCHES[variant]
            out = kfa.flash_attention_fwd(q, k, v, 0.125, True)
            ref = kfa.dense_reference(q, k, v, 0.125, True)
            torch.cuda.synchronize()
            check(kfa.VARIANT_LAUNCHES[variant] == before + 1,
                  f"flash at T={T} {dtype} did not launch {variant}")
            check(out.shape == ref.shape and out.dtype == dtype
                  and bool(torch.isfinite(out).all()),
                  f"flash output malformed at T={T} {dtype}")
            err = (out.float() - ref.float()).abs().max().item()
            rel = err / ref.float().abs().max().item()
            what = f"flash {variant} vs plain at B=4 H=16 T={T} D=64 {dtype}"
            check(err <= tol, f"{what}: max err {err:.3e} > {tol}")
            check(dtype != torch.bfloat16 or rel <= TOL_BF16_REL,
                  f"{what}: max err / max |ref| {rel:.3e} > "
                  f"{TOL_BF16_REL:.3e}")
            errs[(variant, dtype, 4, T, 64, True)] = (err, rel)
            line = (f"  flash {variant:4s} B=4 H=16 T={T} D=64 "
                    f"{str(dtype)[6:]} causal=True: max err {err:.3e}, over "
                    f"max |ref| {rel:.3e}")
            if dtype == torch.bfloat16:
                t = {name: device_ms(fn) for name, fn in (
                    ("sm90", lambda: kfa.flash_attention_fwd(q, k, v, 0.125,
                                                             True)),
                    ("plain", lambda: kfa.dense_reference(q, k, v, 0.125,
                                                          True)),
                    ("sdpa", lambda: torch.nn.functional.
                     scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  scale=0.125)))}
                bound = attention_bound_ms(4, 16, T, 64, True, 2,
                                           H100_BF16_FLOPS)
                short_times[T] = (t, bound)
                line += ("; device ms: " + ", ".join(
                    f"{n} {ms:.4f}" for n, ms in t.items())
                    + f"; bound {bound[0]:.5f} ({bound[1]})")
            print(line)
    timings = {}
    # B=8 float32: MultiHeadAttention's default shape (phase 12's f32 leg)
    for dtype, B in ((torch.bfloat16, 4), (torch.bfloat16, 1),
                     (torch.float32, 4), (torch.float32, TRAIN_BATCH)):
        for causal in (True, False):
            q, k, v = qkv(B, 16, 1024, 64, dtype)
            variant = kfa._variant(dtype, 64)
            fns = {variant: lambda: kfa.flash_attention_fwd(q, k, v, 0.125,
                                                            causal)}
            if variant != "f32":   # with lse; the f32 kernel on the same
                fns["sm90_lse"] = lambda: kfa._launch(    # bf16 inputs
                    "sm90", q, k, v, 0.125, causal, return_lse=True)
                fns["f32"] = lambda: kfa._launch("f32", q, k, v, 0.125,
                                                 causal)
            fns["plain"] = lambda: kfa.dense_reference(q, k, v, 0.125, causal)
            fns["sdpa"] = lambda: torch.nn.functional.\
                scaled_dot_product_attention(q, k, v, is_causal=causal,
                                             scale=0.125)
            row = {name: (device_ms(fn), time_ms(fn))
                   for name, fn in fns.items()}
            rate = H100_BF16_FLOPS if dtype == torch.bfloat16 \
                else H100_3XTF32_FLOPS
            row["bound"] = attention_bound_ms(B, 16, 1024, 64, causal,
                                              q.element_size(), rate)
            line = (f"  time B={B} H=16 T=1024 D=64 {str(dtype)[6:]} "
                    f"causal={causal}, device (call) ms: " + ", ".join(
                        f"{name} {d:.4f} ({c:.4f})"
                        for name, (d, c) in row.items() if name != "bound")
                    + f"; bound {row['bound'][0]:.4f} ({row['bound'][1]})")
            if dtype == torch.float32:   # and the FMA kernels' ceiling
                row["fma_bound"] = attention_bound_ms(
                    B, 16, 1024, 64, causal, 4, H100_F32_FLOPS)
                line += f", at FMA rate {row['fma_bound'][0]:.4f}"
            timings[(dtype, B, causal)] = row
            print(line)
    return errs, lse_errs, timings, short_times


def build_nets(mx):
    """The flash net, seeded and initialized on gpu(0), and a dense-attention
    net that shares its parameters."""
    import numpy as np
    from mxnet_tpu_torch.gluon.model_zoo.transformer import TransformerLM
    mx.random.seed(0)
    t0 = time.perf_counter()
    flash = TransformerLM(**CONFIG, attn_type="flash")
    flash.initialize(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                    magnitude=2), ctx=mx.gpu(0))
    # the first forward resolves the deferred shapes (draws in forward order)
    flash(mx.nd.array(np.zeros((1, 8), np.float32), ctx=mx.gpu(0)))
    dense = TransformerLM(**CONFIG, attn_type="dense",
                          params=flash.collect_params())
    n = sum(p.data().numel() for p in flash.collect_params().values())
    print(f"model: {n} parameters, built in {time.perf_counter() - t0:.1f} s")
    return flash, dense


def forward_counted(net, L, *args, fn=None):
    """Run one forward (or ``fn``) and check it launched the kernel L times."""
    from mxnet_tpu_torch.kernels import flash_attention as kfa
    before = kfa.LAUNCHES
    out = (fn or net)(*args)
    check(kfa.LAUNCHES - before == L,
          f"{kfa.LAUNCHES - before} flash launches in one forward, want {L}")
    return out


def phase_score_f32(mx, flash, dense, tokens, L):
    import torch
    logits = forward_counted(flash, L, tokens)
    ref = forward_counted(dense, 0, tokens)
    torch.cuda.synchronize()
    check(logits.shape == (SCORE_BATCH, CONFIG["max_len"], CONFIG["vocab"])
          and bool(torch.isfinite(logits).all()), "scoring logits malformed")
    err = (logits - ref).abs().max().item()
    scale = ref.abs().max().item()
    print(f"scoring f32: logits max |flash - dense| {err:.3e} "
          f"(max |logit| {scale:.3f})")
    check(err <= TOL_LOGITS_F32, f"flash vs dense logits differ by {err:.3e}")


def serve(mx, net, prompts, L):
    """Greedy requests through ``generate``; each step is one forward."""
    import torch
    outs, times = [], []
    for p in prompts:
        prompt = mx.nd.array(p[None, :], ctx=mx.gpu(0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = forward_counted(net, L * MAX_NEW, prompt, MAX_NEW,
                              fn=net.generate)
        outs.append(mx.nd.asnumpy(out)[0])
        times.append(time.perf_counter() - t0)
    return outs, times


def check_tokens(mx, dense, what, got, want, t0):
    """``got`` equals ``want`` (the dense net's static-path tokens), or
    first differs after the prompt where the dense net's top-2 logits are
    within NEAR_TIE of each other, which is printed."""
    import numpy as np
    check(got.shape == (t0 + MAX_NEW,), "generated tokens malformed")
    diff = np.nonzero(got != want)[0]
    if diff.size == 0:
        print(f"  request T0={t0}: {what} tokens equal the dense net's")
        return
    i = int(diff[0])
    check(i >= t0, "generate changed the prompt")
    buf = np.zeros((1, CONFIG["max_len"]), np.float32)
    buf[0, :i] = want[:i]
    last = mx.nd.asnumpy(dense._decode_steps()["logits"](
        mx.nd.array(buf, ctx=mx.gpu(0)),
        mx.nd.array([i - 1.0], ctx=mx.gpu(0))))[0]
    top2 = np.sort(last)[-2:]
    gap = float(top2[1] - top2[0])
    print(f"  request T0={t0}: token {i} differs ({what} {got[i]:.0f}, "
          f"dense {want[i]:.0f}); dense top-2 logit gap {gap:.3e}")
    check(gap <= NEAR_TIE, f"tokens differ at {i} without a near-tie")
    print(f"  near-tie accepted at request T0={t0} position {i}")


def phase_serve_f32(mx, flash, dense, prompts, L):
    got, _ = serve(mx, flash, prompts, L)
    want, _ = serve(mx, dense, prompts, 0)
    for p, g, w in zip(prompts, got, want):
        check_tokens(mx, dense, "flash", g, w, len(p))
    print("serving f32: greedy tokens agree with the dense net")
    return want


def reset_counts():
    """Every kernel launch count set to 0."""
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch.kernels import flash_attention as kfa
    from mxnet_tpu_torch.kernels import roi_pooling as kroi
    for mod in kernels.ALL:
        mod.LAUNCHES = 0
    kroi.FWD_LAUNCHES = kroi.BWD_LAUNCHES = 0
    for variant in kfa.VARIANT_LAUNCHES:
        kfa.VARIANT_LAUNCHES[variant] = 0
    for variant in kfa.BWD_VARIANT_LAUNCHES:
        kfa.BWD_VARIANT_LAUNCHES[variant] = 0
    kfa.BWD_LAUNCHES = 0


def read_counts():
    """{kernel module: launches}, with the flash forward also by variant,
    the flash backward (K1b) on its own, in all and by variant, and ROI
    pooling's forward and backward."""
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch.kernels import flash_attention as kfa
    from mxnet_tpu_torch.kernels import roi_pooling as kroi
    counts = {mod.__name__.rsplit(".", 1)[1]: mod.LAUNCHES
              for mod in kernels.ALL}
    counts.update({f"flash_attention.{v}": n
                   for v, n in kfa.VARIANT_LAUNCHES.items()})
    counts["flash_attention.bwd"] = kfa.BWD_LAUNCHES
    counts["roi_pooling.fwd"] = kroi.FWD_LAUNCHES
    counts["roi_pooling.bwd"] = kroi.BWD_LAUNCHES
    counts.update({f"flash_attention.bwd.{v}": n
                   for v, n in kfa.BWD_VARIANT_LAUNCHES.items()})
    return counts


def phase_main(mx, flash, tokens, prompts, L):
    """The main path in bfloat16, with every kernel count set to 0 first."""
    import torch
    flash.cast("bfloat16")
    forward_counted(flash, L, tokens)          # warm-up, outside the count
    serve(mx, flash, prompts[:1], L)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    logits = flash(tokens)
    torch.cuda.synchronize()
    t_score = time.perf_counter() - t0
    check(logits.dtype == torch.bfloat16 and logits.shape ==
          (SCORE_BATCH, CONFIG["max_len"], CONFIG["vocab"])
          and bool(torch.isfinite(logits).all()), "bf16 logits malformed")
    outs, times = serve(mx, flash, prompts, L)
    counts = read_counts()
    print(f"main path bf16: scoring B={SCORE_BATCH} T={CONFIG['max_len']} "
          f"{t_score * 1e3:.1f} ms ({SCORE_BATCH * CONFIG['max_len'] / t_score:.0f}"
          f" tokens/s)")
    for p, out, t in zip(prompts, outs, times):
        print(f"  request T0={len(p)}: {t * 1e3:.1f} ms for {MAX_NEW} tokens "
              f"({MAX_NEW / t:.1f} tokens/s); new tokens {out[len(p):].astype(int).tolist()}")
    print(f"  kernel launches on the main path: {counts}")
    want = L * (1 + len(prompts) * MAX_NEW)
    check(counts["flash_attention"] == want
          and counts["flash_attention.sm90"] == want
          and counts["flash_attention.f32"] == 0,
          f"flash launches on the main path: {counts}; want {want}, all of "
          f"them on the sm90 kernel")
    return counts, times


def host_clock_ms(fn):
    """Host clock of one call of ``fn``, synchronized on both sides: the
    median of 5 calls after a warm-up."""
    import torch
    walls = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls[1:])


def kernel_rows(fn):
    """(ms, launches, name) of each kernel torch.profiler sees in one call
    of ``fn``, largest first; empty when it sees no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # device-side events only: a CPU op's self device time repeats the
    # time of the kernels it launched, and so does the device span of a
    # range a graph's layer scope annotates
    rows, scopes = [], []
    for a in prof.key_averages():
        if a.device_type == torch.autograd.DeviceType.CPU \
                or a.self_device_time_total <= 0:
            continue
        row = (a.self_device_time_total / 1e3, a.count, a.key)
        (scopes if getattr(a, "is_user_annotation", False)
         else rows).append(row)
    if scopes:
        print(f"      (torch.profiler: {sum(r[1] for r in scopes)} "
              f"annotated ranges, {sum(r[0] for r in scopes):.3f} ms of "
              f"device span, left out of the kernels)")
    return sorted(rows, reverse=True)


def phase_profile(mx, flash, prompt):
    """Where one bf16 greedy decode step's time goes: the host clock around
    the step (median of 5, profiler off), the device time of the kernels
    torch.profiler sees in one step, and the kernels that take most of it;
    where the profiler sees no device time, ``device_ms`` of the step's
    flash launches instead."""
    import numpy as np
    import torch
    step = flash._decode_steps()["greedy"]
    buf = np.zeros((1, CONFIG["max_len"]), np.float32)
    buf[0, :len(prompt)] = prompt
    buf = mx.nd.array(buf, ctx=mx.gpu(0))
    pos = mx.nd.array([len(prompt) - 1.0], ctx=mx.gpu(0))
    wall_ms = host_clock_ms(lambda: step(buf, pos))
    step._active = False           # the same step run eagerly, op by op
    eager_ms = host_clock_ms(lambda: step(buf, pos))
    step._active = True
    rows = kernel_rows(lambda: step(buf, pos))
    print(f"decode step bf16, T0={len(prompt)}: host clock {wall_ms:.3f} ms "
          f"through its CachedOp, {eager_ms:.3f} ms eager (medians of 5, "
          f"profiler off)")
    if rows:
        busy_ms = sum(r[0] for r in rows)
        flash = [r for r in rows if "flash_attention" in r[2]]
        flash_ms = sum(r[0] for r in flash)
        print(f"  kernel time (torch.profiler) {busy_ms:.3f} ms "
              f"({100 * busy_ms / wall_ms:.1f}% of the step)")
        print(f"  flash: {flash_ms:.3f} ms in {sum(r[1] for r in flash)} "
              f"launches ({100 * flash_ms / busy_ms:.1f}% of kernel time)")
    else:
        # No device trace.  The step waits for the stream somewhere inside
        # (queued behind a spin, its enqueue never finishes first), so only
        # its flash launches are timed, on inputs of the step's shape.
        from mxnet_tpu_torch.kernels import flash_attention as kfa
        L, H = CONFIG["num_layers"], CONFIG["num_heads"]
        q, k, v = (torch.randn(1, H, CONFIG["max_len"], CONFIG["dim"] // H,
                               device="cuda", dtype=torch.bfloat16)
                   for _ in range(3))
        scale = (CONFIG["dim"] // H) ** -0.5
        flash_ms = device_ms(lambda: [kfa.flash_attention_fwd(
            q, k, v, scale, True) for _ in range(L)], iters=3)
        print("  kernel time not measured: torch.profiler saw no device time")
        print(f"  flash: {flash_ms:.3f} ms of stream time in {L} launches "
              f"({100 * flash_ms / wall_ms:.1f}% of the host clock)")
    for ms, count, key in rows[:8]:
        print(f"  {ms:8.3f} ms  x{count:<4d} {key[:90]}")


def teacher_forced_logp(mx, net, seq, t0):
    """The log-probability ``net`` gives seq[t0:] after seq[:t0], from one
    forward over the whole sequence (float64 sums of float32 log-probs)."""
    import torch
    logits = net(mx.nd.array(seq[None, :], ctx=mx.gpu(0)))[0]
    logp = torch.log_softmax(logits.double(), dim=-1)
    ids = torch.as_tensor(seq[t0:], device=logp.device).long()
    return float(logp[torch.arange(t0 - 1, len(seq) - 1), ids].sum())


def kv_step(mx, net, prompt):
    """One greedy KV decode step at position len(prompt), on zero caches."""
    cell = net._kv_step()["greedy"]
    caches = net._init_caches(1, ctx=mx.gpu(0), dtype=net.head.weight.dtype)
    cur = mx.nd.array(prompt[None, :1], ctx=mx.gpu(0))
    pos = mx.nd.array([float(len(prompt))], ctx=mx.gpu(0))
    return lambda: cell(cur, pos, *caches)


def kv_step_bound_ms(mx, net):
    """Least time of one B=1 KV step on the card: the bytes it must move
    (every weight read once, but one row of each embedding table; the
    caches read once and the new caches written once) over the memory
    rate.  Its operations, about two per weight, take far less."""
    weights = 0
    for p in net.collect_params().values():
        t = p.data()
        rows = 1 if p.name.endswith(("tok_weight", "pos_weight")) \
            else t.shape[0]
        weights += rows * t[0].numel() * t.element_size()
    caches = sum(c.numel() * c.element_size()
                 for c in net._init_caches(1, ctx=mx.gpu(0),
                                           dtype=net.head.weight.dtype))
    return (weights + 2 * caches) / H100_BYTES * 1e3


def cache_write_ms(dtype):
    """Device time of one step's cache writes (2 per layer at B=1) made as
    ``mha_decode_step`` makes them, out of place, beside the same writes in
    place, and their bound (the out-of-place write reads and writes every
    cache once)."""
    import torch
    L, H = CONFIG["num_layers"], CONFIG["num_heads"]
    dh, tmax = CONFIG["dim"] // H, CONFIG["max_len"]
    caches = [torch.randn(1, H, tmax, dh, device="cuda").to(dtype)
              for _ in range(2 * L)]
    row = torch.randn(1, H, 1, dh, device="cuda").to(dtype)
    col = torch.tensor([tmax // 2], device="cuda")
    out_of_place = device_ms(lambda: [c.index_copy(2, col, row)
                                      for c in caches], iters=5)
    in_place = device_ms(lambda: [c.index_copy_(2, col, row)
                                  for c in caches], iters=5)
    nbytes = 2 * sum(c.numel() * c.element_size() for c in caches)
    return out_of_place, in_place, nbytes / H100_BYTES * 1e3


def phase_kv(mx, prompts, static_tokens, static_times):
    """KV-cache decode, beam search and a checkpoint round trip on a fresh
    float32 net with phase 3's weights, then the KV requests in bfloat16
    timed beside phase 5's static-shape ones."""
    import tempfile
    import numpy as np
    import torch
    from mxnet_tpu_torch.gluon.model_zoo.transformer import TransformerLM
    from mxnet_tpu_torch.kernels import flash_attention as kfa
    flash, dense = build_nets(mx)
    launches = kfa.LAUNCHES            # build_nets' forward launched flash
    kv = {}
    for p, want in zip(prompts, static_tokens):
        prompt = mx.nd.array(p[None, :], ctx=mx.gpu(0))
        kv[len(p)] = mx.nd.asnumpy(flash.generate(prompt, MAX_NEW,
                                                  kv_cache=True))[0]
        check_tokens(mx, dense, "KV", kv[len(p)], want, len(p))
    print("KV decode f32: greedy tokens agree with the static path")
    p = next(p for p in prompts if len(p) == BEAM_PROMPT)
    prompt = mx.nd.array(p[None, :], ctx=mx.gpu(0))
    sampled = [mx.nd.asnumpy(net.generate(
        prompt, MAX_NEW, temperature=0.8, rng=np.random.RandomState(11),
        **kw))[0] for net, kw in ((flash, {"kv_cache": True}), (dense, {}))]
    print(f"  sampled request T0={BEAM_PROMPT}, temperature 0.8: KV "
          f"{sampled[0][BEAM_PROMPT:].astype(int).tolist()}, static "
          f"{sampled[1][BEAM_PROMPT:].astype(int).tolist()}")
    check(np.array_equal(*sampled), "sampled KV tokens differ from static")
    seq1, lp1 = flash.beam_search(prompt, MAX_NEW, beam=1)
    check(np.array_equal(mx.nd.asnumpy(seq1)[0], kv[BEAM_PROMPT]),
          "beam width 1 differs from KV greedy")
    seq4, lp4 = flash.beam_search(prompt, MAX_NEW, beam=4)
    seq4 = mx.nd.asnumpy(seq4)[0]
    lp4 = float(mx.nd.asnumpy(lp4)[0])
    resc = teacher_forced_logp(mx, dense, seq4, BEAM_PROMPT)
    print(f"  beam 1 = greedy; beam 4: log-prob {lp4:.6f}, teacher-forced "
          f"{resc:.6f} (|diff| {abs(lp4 - resc):.3e}); greedy "
          f"{float(mx.nd.asnumpy(lp1)[0]):.6f}; tokens "
          f"{seq4[BEAM_PROMPT:].astype(int).tolist()}")
    check(abs(lp4 - resc) <= TOL_BEAM, "beam log-prob differs from rescoring")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        path = os.path.join(d, "lm.params")
        t0 = time.perf_counter()
        flash.save_params(path)
        t_save = time.perf_counter() - t0
        fresh = TransformerLM(**CONFIG, attn_type="flash")
        t0 = time.perf_counter()
        fresh.load_params(path, ctx=mx.gpu(0))
        t_load = time.perf_counter() - t0
        size = os.path.getsize(path)
    got = mx.nd.asnumpy(fresh.generate(prompt, MAX_NEW, kv_cache=True))[0]
    print(f"  checkpoint: save_params {t_save:.2f} s, load_params into a "
          f"fresh net on gpu(0) {t_load:.2f} s ({size / 1e6:.0f} MB); KV "
          f"tokens {'identical' if np.array_equal(got, kv[BEAM_PROMPT]) else 'DIFFER'}")
    check(np.array_equal(got, kv[BEAM_PROMPT]), "loaded net decodes otherwise")
    del fresh
    writes = {dt: cache_write_ms(dt)
              for dt in (torch.float32, torch.bfloat16)}
    flash.cast("bfloat16")
    flash.generate(mx.nd.array(prompts[0][None, :], ctx=mx.gpu(0)), MAX_NEW,
                   kv_cache=True)                  # warm-up
    print("KV decode bf16 (host clock; static = phase 5's request times):")
    for p, t_static in zip(prompts, static_times):
        prompt = mx.nd.array(p[None, :], ctx=mx.gpu(0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = mx.nd.asnumpy(flash.generate(prompt, MAX_NEW, kv_cache=True))[0]
        t_req = time.perf_counter() - t0
        check(out.shape == (len(p) + MAX_NEW,) and np.array_equal(
            out[:len(p)], p), "bf16 KV tokens malformed")
        steps = len(p) + MAX_NEW - 1
        print(f"  request T0={len(p)}: KV {t_req * 1e3:.1f} ms for {steps} "
              f"steps ({t_req / steps * 1e3:.3f} ms/step), static "
              f"{t_static * 1e3:.1f} ms for {MAX_NEW} forwards; one KV step "
              f"{host_clock_ms(kv_step(mx, flash, p)):.3f} ms (median of 5); "
              f"new tokens {out[len(p):].astype(int).tolist()}")
    rows = kernel_rows(kv_step(mx, flash, prompts[-1]))
    print(f"  one KV step's bound: {kv_step_bound_ms(mx, flash):.4f} ms "
          "(bytes)")
    if rows:
        busy_ms = sum(r[0] for r in rows)
        print(f"  one KV step under torch.profiler: {busy_ms:.3f} ms of "
              f"kernel time in {sum(r[1] for r in rows)} launches")
        for ms, count, key in rows[:6]:
            print(f"  {ms:8.3f} ms  x{count:<4d} {key[:90]}")
    else:
        print("  KV step kernel time not measured: torch.profiler saw no "
              "device time")
    for dt, (oop, inp, bound) in writes.items():
        print(f"  cache writes per step, {str(dt)[6:]} ({2 * CONFIG['num_layers']}"
              f" caches of B=1): out of place {oop:.4f} ms, in place "
              f"{inp:.4f} ms, out-of-place bound {bound:.4f} ms (bytes)")
    delta = kfa.LAUNCHES - launches
    print(f"  flash launches while decoding with the KV cache: {delta}")
    check(delta == 0, "the KV path launched the flash kernel")


def percentile(xs, q):
    """The q-th percentile of ``xs`` (nearest rank)."""
    xs = sorted(xs)
    return xs[min(len(xs) - 1, max(0, int(round(q / 100 * len(xs))) - 1))]


def serve_breakdown(mx, pred, keys):
    """Host clock of one dispatch (graph run, synchronized) and of the
    host copy of its outputs, per bucket key: medians of 5 after a
    warm-up."""
    import numpy as np
    import torch
    out = {}
    for key in keys:
        shapes = pred.spec.bucket_input_shapes(key)
        padded = {n: np.zeros(s, np.float32) for n, s in shapes.items()}
        disp, copy = [], []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = pred._dispatch(key, padded)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            host = [mx.nd.asnumpy(o) for o in outs]
            t2 = time.perf_counter()
            disp.append((t1 - t0) * 1e3)
            copy.append((t2 - t1) * 1e3)
        nbytes = sum(h.nbytes for h in host)
        out[key] = (statistics.median(disp[1:]), statistics.median(copy[1:]),
                    nbytes)
        print(f"  bucket {key}: dispatch {out[key][0]:.3f} ms, host copy "
              f"{out[key][1]:.3f} ms of {nbytes / 2 ** 20:.0f} MiB "
              f"({nbytes / out[key][1] / 1e6:.2f} GB/s)")
    return out


def phase_serving(mx, prompts, L):
    """Serving through the Symbol graph on a fresh net with phase 7's
    weights: graph round trip, float32 bucketed predictor against eager
    scoring, then the bfloat16 main serving path through a MicroBatcher
    (counted) and the ResilientServer's typed rejections."""
    import tempfile
    import threading
    import numpy as np
    import torch
    from mxnet_tpu_torch.kernels import flash_attention as kfa
    from mxnet_tpu_torch.observability import metrics as M
    from mxnet_tpu_torch.serving import (BucketedPredictor, DeadlineExceeded,
                                         MicroBatcher, Overloaded,
                                         ResilientServer, pow2_buckets)
    flash, dense = build_nets(mx)
    del dense
    t0 = time.perf_counter()
    js = flash(mx.sym.var("data")).tojson()
    check(mx.sym.load_json(js).tojson() == js, "graph JSON round trip")
    t_trace = time.perf_counter() - t0
    max_shape = {"data": (SCORE_BATCH, CONFIG["max_len"])}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        path = os.path.join(d, "lm.params")
        mx.nd.save(path, {n: p.data()
                          for n, p in flash.collect_params().items()})
        t0 = time.perf_counter()
        pred = BucketedPredictor(js, path, max_shape, seq_axes={"data": 1})
        t_load = time.perf_counter() - t0
    keys = pred.spec.all_keys()
    n_keys = len(pow2_buckets(SCORE_BATCH)) * len(
        pow2_buckets(CONFIG["max_len"]))          # 3 x 11 at full width
    print(f"graph: {len(json.loads(js)['nodes'])} nodes, traced and "
          f"round-tripped through JSON in {t_trace:.2f} s; predictor on "
          f"gpu(0) from the JSON and the params file in {t_load:.2f} s; "
          f"{len(keys)} buckets")
    check(len(keys) == n_keys, f"bucket lattice has {len(keys)} keys, "
          f"want {n_keys}")
    compiles, launches = M.SERVE_COMPILES.value, dict(kfa.VARIANT_LAUNCHES)
    t0 = time.perf_counter()
    pred.warmup()
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    built = M.SERVE_COMPILES.value - compiles
    warm = {v: kfa.VARIANT_LAUNCHES[v] - launches[v] for v in launches}
    print(f"serving f32: warmup built {built:.0f} buckets in {t_warm:.2f} s, "
          f"flash launches {warm}")
    check(built == n_keys and warm["f32"] == L * n_keys
          and warm["sm90"] == 0,
          f"warmup: {built} buckets, flash launches {warm}; want {n_keys} "
          f"and {L * n_keys} on f32")
    compiles = M.SERVE_COMPILES.value
    for p in prompts:
        got = pred.predict(data=p[None, :])[0]
        want = mx.nd.asnumpy(flash(mx.nd.array(p[None, :], ctx=mx.gpu(0))))
        bucket = pred.spec.route({"data": (1, len(p))})
        check(got.shape == (1, bucket[1], CONFIG["vocab"])
              and np.isfinite(got).all(), f"served logits malformed: "
              f"{got.shape} at T0={len(p)}")
        err = float(np.abs(got[:, :len(p)] - want).max())
        print(f"  request T0={len(p)} -> bucket {bucket}: valid logits max "
              f"|served - net(tokens)| {err:.3e}")
        check(err <= TOL_LOGITS_F32, f"served logits differ by {err:.3e}")
    check(M.SERVE_COMPILES.value == compiles, "requests built buckets")
    pred.close()
    del pred

    # the main serving path: bfloat16
    flash.cast("bfloat16")
    pred = BucketedPredictor(flash(mx.sym.var("data")), {n: p.data() for n, p in
                                   flash.collect_params().items()},
                             max_shape, seq_axes={"data": 1})
    t0 = time.perf_counter()
    pred.warmup()
    torch.cuda.synchronize()
    print(f"serving bf16: warmup built {pred.num_compiled} buckets in "
          f"{time.perf_counter() - t0:.2f} s")
    rs = np.random.RandomState(7)
    reqs = [rs.randint(0, CONFIG["vocab"], (1, PROMPTS[i % len(PROMPTS)]))
            .astype(np.float32) for i in range(32)]
    solo = [pred.predict(data=r)[0] for r in reqs]
    compiles = M.SERVE_COMPILES.value
    batches, served = M.SERVE_BATCHES.value, M.SERVE_REQUESTS.value
    groups = []                    # (start, end, inputs) of each dispatch
    routed = pred._predict_routed

    def timed_routed(inputs):
        start = time.perf_counter()
        outs = routed(inputs)
        groups.append((start, time.perf_counter(), inputs))
        return outs

    pred._predict_routed = timed_routed
    results, lat = [None] * len(reqs), [None] * len(reqs)
    batcher = MicroBatcher(pred)

    def client(idx):
        for i in idx:
            t = time.perf_counter()
            results[i] = batcher.submit(data=reqs[i]).result()[0]
            lat[i] = (t, time.perf_counter())

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(range(c, 32, 4),))
               for c in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    counts = read_counts()
    batcher.close()
    pred._predict_routed = routed
    dispatches = M.SERVE_BATCHES.value - batches
    ms = [(b - a) * 1e3 for a, b in lat]
    tokens = sum(r.shape[1] for r in reqs)
    print(f"  MicroBatcher, 4 client threads, 32 requests: {dispatches:.0f} "
          f"batches, {M.SERVE_REQUESTS.value - served:.0f} requests, "
          f"{32 / len(groups):.2f} rows per batch (last batch "
          f"{M.SERVE_COALESCED_ROWS.get():.0f} rows); latency p50 "
          f"{percentile(ms, 50):.2f} ms, p99 {percentile(ms, 99):.2f} ms; "
          f"{32 / wall:.1f} requests/s, {tokens / wall:.0f} prompt tokens/s "
          f"in {wall:.2f} s")
    # each request's batch and row there: its ids open exactly one row
    where = {}
    for g, (_, _, inputs) in enumerate(groups):
        for row, ids in enumerate(inputs["data"]):
            hits = [i for i, r in enumerate(reqs)
                    if np.array_equal(ids[:r.shape[1]], r[0])]
            check(len(hits) == 1 and hits[0] not in where,
                  f"batch {g} row {row} matches requests {hits}")
            where[hits[0]] = (g, row)
    check(sorted(where) == list(range(len(reqs))),
          f"requests missing from the batches: {sorted(where)}")
    # queueing: from a request's submit to its batch's dispatch
    queue_ms = [(groups[where[i][0]][0] - lat[i][0]) * 1e3
                for i in range(len(reqs))]
    service = [(b - a) * 1e3 for a, b, _ in groups]
    print(f"  queueing p50 {percentile(queue_ms, 50):.2f} ms, p99 "
          f"{percentile(queue_ms, 99):.2f} ms; dispatch + host copy per "
          f"batch p50 {percentile(service, 50):.2f} ms, p99 "
          f"{percentile(service, 99):.2f} ms")
    print(f"  kernel launches on the serving path: {counts}")
    check(counts["flash_attention"] == L * dispatches
          and counts["flash_attention.sm90"] == L * dispatches
          and counts["flash_attention.f32"] == 0,
          f"flash launches while serving: {counts}; want {L} x "
          f"{dispatches:.0f} dispatches, all on the sm90 kernel")
    check(M.SERVE_COMPILES.value == compiles, "traffic built buckets")
    # the same batches dispatched again: a coalesced result is its row
    for g, (_, _, inputs) in enumerate(groups):
        again = routed(inputs)[0]
        for i, (g_i, row) in where.items():
            check(g_i != g or np.array_equal(results[i], again[row:row + 1]),
                  f"request {i}: coalesced result differs from row {row} "
                  f"of its batch dispatched again")
    worst, same, same_bucket = 0.0, 0, 0
    for i, (r, got, want) in enumerate(zip(reqs, results, solo)):
        check(got.shape[0] == 1 and got.shape[2] == CONFIG["vocab"]
              and np.isfinite(got.astype(np.float32)).all(),
              "coalesced result malformed")
        a = got[:, :r.shape[1]].astype(np.float32)    # the valid region
        b = want[:, :r.shape[1]].astype(np.float32)
        same += bool(np.array_equal(a, b))
        key = pred.spec.route({"data": groups[where[i][0]][2]["data"].shape})
        if key == pred.spec.route({"data": r.shape}):
            same_bucket += 1
            check(np.array_equal(a, b), f"request {i} ran at its solo "
                  f"bucket {key} and differs from its solo result")
        else:
            worst = max(worst, float(np.abs(a - b).max()))
    print(f"  coalesced vs solo: 32 results equal to their rows of the same "
          f"batches dispatched again; {same_bucket} of 32 ran at their solo "
          f"bucket (bitwise equal); {same} of 32 valid regions identical; "
          f"max |diff| at another bucket {worst:.3e} (limit "
          f"{TOL_COALESCED_BF16})")
    check(worst <= TOL_COALESCED_BF16, f"coalesced results differ from "
          f"solo by {worst:.3e} at another bucket")
    serve_breakdown(mx, pred, [(1, 16), (1, 128), (1, 512), (1, 1024),
                               (4, 1024)])

    server = ResilientServer(pred, max_queue=2)
    server.warmup()
    ready = server.readyz()
    check(server.healthz()["ok"] and ready["ready"],
          f"server not ready: {ready}")
    burst, shed = [], 0
    for r in reqs[3::4] * 2:                 # 16 requests at T0=700
        try:
            burst.append(server.submit(data=r))
        except Overloaded as e:
            check(e.retry_after_s >= 0, "Overloaded without retry-after")
            shed += 1
    for f in burst:
        f.result()
    late = server.submit(data=reqs[0], deadline_ms=0.0)
    try:
        late.result()
        check(False, "a request past its deadline was served")
    except DeadlineExceeded:
        pass
    stats = server.stats()
    print(f"  ResilientServer max_queue=2: burst of 16, {len(burst)} "
          f"admitted and served, {shed} shed with Overloaded; a request "
          f"past its deadline failed with DeadlineExceeded; readyz "
          f"{server.readyz()['ready']}, expired dispatches "
          f"{stats['expired_dispatches']}")
    check(shed >= 1 and stats["expired_dispatches"] == 0
          and server.readyz()["ready"], f"server stats {stats}")
    server.close()
    pred.close()
    return counts


def train_step_block(mx, net):
    """``experiments/lm_mfu_probe.py``'s TrainStep: the net and a float32
    next-token cross-entropy as one hybridized block."""
    class TrainStep(mx.gluon.HybridBlock):
        def __init__(self, net, vocab, **kw):
            super().__init__(**kw)
            self._v = vocab
            with self.name_scope():
                self.net = net

        def hybrid_forward(self, F, tokens, labels):
            logits = self.net(tokens)                       # (B, T, V)
            logits = F.cast(F.reshape(logits, (-1, self._v)), "float32")
            lp = F.log_softmax(logits, axis=-1)
            nll = -F.pick(lp, F.reshape(labels, (-1,)), axis=-1)
            return F.mean(nll)

    step = TrainStep(net, CONFIG["vocab"])
    step.hybridize()
    return step


def phase_train_kernel(mx):
    """K1b against its plain version, then the times.

    The sm90 kernel (bf16 at D 64 and 128, with the forward's lse) at the
    training and gradient check batches (B=8 and B=2, H=16, T=1024, D 64
    and 128, causal and not), T=128 and a ragged T=100 at D=64, and T=2
    and T=7: against the plain version, against the f32 kernel on the
    same bf16 inputs, and run twice for a bitwise-equal result.  The f32
    (3xTF32) kernel at the shapes it serves: float32 at the training shape,
    T=64 (D 16, 32) and T=100, and bf16 at D 16 and 32, also run twice for
    a bitwise-equal result.  Then the times at the training shape of both
    kernels beside the plain version's, the bound and the backward of
    ``scaled_dot_product_attention`` (the yardstick), the sm90 kernel gated
    at BWD_SDPA_RATIO times the latter; the f32 kernel also non-causal
    (``MultiHeadAttention``'s default)."""
    import torch
    from mxnet_tpu_torch.kernels import flash_attention as kfa
    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device="cpu").manual_seed(1)

    def inputs(B, H, T, D, dtype, causal):
        q, k, v, do = (torch.randn(B, H, T, D, generator=gen).to(
            "cuda", dtype) for _ in range(4))
        o, lse = kfa.flash_attention_fwd(q, k, v, D ** -0.5, causal,
                                         return_lse=True)
        return q, k, v, o, do, lse

    def worst(got, want, dtype, tol, what):
        """The largest of dq's, dk's and dv's max |got - want| over max
        |want|, gated at tol; returns (abs, rel) of that output."""
        rows = []
        for g, w, name in zip(got, want, ("dq", "dk", "dv")):
            check(g.shape == w.shape and g.dtype == dtype
                  and bool(torch.isfinite(g).all()),
                  f"K1b {name} malformed {what}")
            err = (g.float() - w.float()).abs().max().item()
            rel = err / w.float().abs().max().item()
            check(rel <= tol, f"K1b {name} {what}: max err {err:.3e}, over "
                  f"max |ref| {rel:.3e} > {tol}")
            rows.append((rel, err))
        rel, err = max(rows)
        return err, rel

    errs = {}      # (variant, dtype, B, T, D, causal) -> (abs, rel) vs plain
    f32_errs = {}  # (B, T, D, causal) -> (abs, rel) sm90 vs the f32 kernel
    sm90_cases = [(B, 16, 1024, D, causal) for B in (TRAIN_BATCH, GRAD_BATCH)
                  for D in (64, 128) for causal in (True, False)]
    sm90_cases += [(1, 2, T, 64, causal) for T in (128, 100)
                   for causal in (True, False)]
    # sequences shorter than a tile, whose statistics rows once made the
    # kernel's 1-D TMA map too small to load
    sm90_cases += [(1, 2, 2, 64, True), (2, 3, 7, 128, True)]
    for B, H, T, D, causal in sm90_cases:
        q, k, v, o, do, lse = inputs(B, H, T, D, bf16, causal)
        before = kfa.BWD_VARIANT_LAUNCHES["sm90"]
        got = kfa.flash_attention_bwd(q, k, v, o, do, D ** -0.5, causal, lse)
        again = kfa.flash_attention_bwd(q, k, v, o, do, D ** -0.5, causal,
                                        lse)
        on_f32 = kfa._bwd_launch("f32", q, k, v, o, do, D ** -0.5, causal,
                                 lse)
        want = kfa.bwd_reference(q, k, v, o, do, D ** -0.5, causal)
        torch.cuda.synchronize()
        what = f"at B={B} H={H} T={T} D={D} bf16 causal={causal}"
        check(kfa.BWD_VARIANT_LAUNCHES["sm90"] == before + 2,
              f"K1b did not launch sm90 {what}")
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"K1b sm90 is not bitwise repeatable {what}")
        errs[("sm90", bf16, B, T, D, causal)] = worst(
            got, want, bf16, TOL_BWD_BF16, f"sm90 vs plain {what}")
        f32_errs[(B, T, D, causal)] = worst(
            got, on_f32, bf16, TOL_BWD_BF16, f"sm90 vs the f32 kernel {what}")
        err, rel = errs[("sm90", bf16, B, T, D, causal)]
        print(f"  K1b sm90 B={B} H={H} T={T} D={D} bf16 causal={causal}: "
              f"max err {err:.3e}, over max |ref| {rel:.3e}; vs the f32 "
              f"kernel {f32_errs[(B, T, D, causal)][1]:.3e}; bitwise "
              "repeatable (worst of dq, dk, dv)")
    f32_cases = [(TRAIN_BATCH, 16, 1024, 64, True, f32),
                 (TRAIN_BATCH, 16, 1024, 64, False, f32),
                 (1, 2, 100, 64, True, f32)]
    f32_cases += [(1, 2, 64, D, True, dtype) for D in (16, 32)
                  for dtype in (f32, bf16)]
    for B, H, T, D, causal, dtype in f32_cases:
        q, k, v, o, do, lse = inputs(B, H, T, D, dtype, causal)
        before = kfa.BWD_VARIANT_LAUNCHES["f32"]
        got = kfa.flash_attention_bwd(q, k, v, o, do, D ** -0.5, causal, lse)
        again = kfa.flash_attention_bwd(q, k, v, o, do, D ** -0.5, causal,
                                        lse)
        want = kfa.bwd_reference(q, k, v, o, do, D ** -0.5, causal)
        torch.cuda.synchronize()
        what = f"at B={B} H={H} T={T} D={D} {dtype} causal={causal}"
        check(kfa.BWD_VARIANT_LAUNCHES["f32"] == before + 2,
              f"K1b did not launch f32 {what}")
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"K1b f32 is not bitwise repeatable {what}")
        tol = TOL_BWD_F32 if dtype == f32 else TOL_BWD_BF16
        err, rel = errs[("f32", dtype, B, T, D, causal)] = worst(
            got, want, dtype, tol, f"f32 vs plain {what}")
        print(f"  K1b f32  B={B} H={H} T={T} D={D} {str(dtype)[6:]} "
              f"causal={causal}: max err {err:.3e}, over max |ref| "
              f"{rel:.3e} (worst of dq, dk, dv); bitwise repeatable")
    times = {}
    for dtype, causal in ((bf16, True), (f32, True), (f32, False)):
        q, k, v, o, do, lse = inputs(TRAIN_BATCH, 16, 1024, 64, dtype,
                                     causal)
        qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
        out = torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, is_causal=causal, scale=0.125)
        row = {}
        if dtype == bf16:
            row["sm90"] = device_ms(lambda: kfa.flash_attention_bwd(
                q, k, v, o, do, 0.125, causal, lse))
        row["f32"] = device_ms(lambda: kfa._bwd_launch(
            "f32", q, k, v, o, do, 0.125, causal, lse))
        row["plain"] = device_ms(lambda: kfa.bwd_reference(
            q, k, v, o, do, 0.125, causal))
        row["sdpa_bwd"] = device_ms(lambda: torch.autograd.grad(
            out, (qs, ks, vs), do, retain_graph=True))
        rate = H100_BF16_FLOPS if dtype == bf16 else H100_3XTF32_FLOPS
        # the backward's five products (S, dO V^T, dV, dQ, dK) and its
        # eight tensors (q, k, v, o, dO in; dq, dk, dv out); the designs'
        # own floor: S and dO V^T twice, 14 D per pair
        row["bound"] = attention_bound_ms(
            TRAIN_BATCH, 16, 1024, 64, causal, q.element_size(), rate,
            ops_per_pair=10, tensors=8)
        row["floor"] = attention_bound_ms(
            TRAIN_BATCH, 16, 1024, 64, causal, q.element_size(), rate,
            ops_per_pair=14, tensors=8)
        line = (f"  time K1b B={TRAIN_BATCH} H=16 T=1024 D=64 "
                f"{str(dtype)[6:]} causal={causal}, device ms: " + ", ".join(
                    f"{n} {t:.4f}" for n, t in row.items()
                    if n not in ("bound", "floor"))
                + f"; bound {row['bound'][0]:.4f} ({row['bound'][1]}), the "
                f"design's 14 D floor {row['floor'][0]:.4f}")
        if dtype == f32:   # and the FMA kernels' ceiling
            row["fma_bound"] = attention_bound_ms(
                TRAIN_BATCH, 16, 1024, 64, causal, 4, H100_F32_FLOPS,
                ops_per_pair=10, tensors=8)
            line += f", at FMA rate {row['fma_bound'][0]:.4f}"
        times[dtype if causal else "f32_noncausal"] = row
        print(line)
    ratio = times[bf16]["sm90"] / times[bf16]["sdpa_bwd"]
    print(f"  K1b sm90 / SDPA backward: {ratio:.2f} (limit {BWD_SDPA_RATIO})")
    check(ratio <= BWD_SDPA_RATIO, f"K1b sm90 takes {ratio:.2f}x the "
          f"backward of SDPA, over {BWD_SDPA_RATIO}")
    return errs, f32_errs, times


def phase_grad_check(mx):
    """Float32 parameter gradients of a 2-layer full-width flash net
    through the TrainStep at B=2, T=1024, against a twin: the same net and
    forward (K1 included) with attention's gradient taken by torch's
    autograd of the dense formula instead of K1b.  Sharing the forward
    isolates K1b: a dense-attention net's own forward differs from K1's by
    float rounding, which flips the few ReLUs that sit that close to 0, and
    a flipped unit moves the gradient of its FFN weights by far more than
    K1b's error."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.gluon.model_zoo.transformer import TransformerLM
    from mxnet_tpu_torch.kernels import flash_attention as kfa
    from mxnet_tpu_torch.ops.flash_attention import FlashAttentionFn
    cfg = dict(CONFIG, num_layers=GRAD_LAYERS)
    mx.random.seed(0)
    flash = TransformerLM(**cfg, attn_type="flash")
    flash.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    flash(mx.nd.array(np.zeros((1, 8), np.float32), ctx=mx.gpu(0)))
    toks = np.random.RandomState(1).randint(
        0, cfg["vocab"], (GRAD_BATCH, cfg["max_len"] + 1)).astype(np.float32)
    x = mx.nd.array(toks[:, :-1], ctx=mx.gpu(0))
    y = mx.nd.array(toks[:, 1:], ctx=mx.gpu(0))
    params = flash.collect_params()

    def dense_formula_backward(ctx, do):
        q, k, v = ctx.saved_tensors[:3]
        with torch.enable_grad():
            qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
            o = kfa.dense_reference(qs, ks, vs, ctx.scale, ctx.causal)
            return (*torch.autograd.grad(o, (qs, ks, vs), do), None, None)

    step = train_step_block(mx, flash)

    def grads(want_bwd):
        before = kfa.BWD_LAUNCHES
        before_f32 = kfa.BWD_VARIANT_LAUNCHES["f32"]
        with mx.autograd.record():
            loss = step(x, y)
        loss.backward()
        torch.cuda.synchronize()
        check(kfa.BWD_LAUNCHES - before == want_bwd and
              kfa.BWD_VARIANT_LAUNCHES["f32"] - before_f32 == want_bwd,
              f"K1b launched {kfa.BWD_LAUNCHES - before} times, "
              f"{kfa.BWD_VARIANT_LAUNCHES['f32'] - before_f32} on f32, "
              f"want {want_bwd} on f32")
        return loss.item(), {n: p.grad().clone() for n, p in params.items()}

    f32_before = kfa.VARIANT_LAUNCHES["f32"]
    loss_f, g_flash = grads(GRAD_LAYERS)
    check(kfa.VARIANT_LAUNCHES["f32"] - f32_before == GRAD_LAYERS,
          "the f32 gradient check did not run the f32 K1 in every layer")
    k1b = FlashAttentionFn.backward
    FlashAttentionFn.backward = staticmethod(dense_formula_backward)
    try:
        loss_t, g_twin = grads(0)
    finally:
        FlashAttentionFn.backward = k1b
    rows = []
    for n, g in g_twin.items():
        check(bool(torch.isfinite(g_flash[n]).all()),
              f"flash gradient {n} not finite")
        scale = g.abs().max().item()
        check(scale > 0, f"twin gradient {n} is zero")
        rows.append(((g_flash[n] - g).abs().max().item() / scale, n))
    vs_twin = sorted(rows, reverse=True)
    print(f"gradient check f32, {GRAD_LAYERS} layers, B={GRAD_BATCH} "
          f"T={cfg['max_len']}, {len(params)} parameter gradients; K1b "
          f"launches {GRAD_LAYERS}; losses: flash {loss_f:.6f}, twin "
          f"{loss_t:.6f}")
    print(f"  vs the twin (same forward, dense-formula attention gradient): "
          f"worst max |diff| over max |twin| {vs_twin[0][0]:.3e} "
          f"({vs_twin[0][1]}; limit {TOL_GRAD_F32})")
    check(vs_twin[0][0] <= TOL_GRAD_F32, f"K1b's gradient of "
          f"{vs_twin[0][1]} differs from the twin's by {vs_twin[0][0]:.3e} "
          "of its largest magnitude")


def phase_train(mx):
    """The training main path in bfloat16, with every kernel count set to
    0 first: the probe's hybridized TrainStep, SGD with momentum 0.9 and
    float32 master weights, TRAIN_STEPS steps on one fixed batch."""
    import gc
    import numpy as np
    import torch
    from mxnet_tpu_torch.gluon.model_zoo.transformer import TransformerLM
    L = CONFIG["num_layers"]
    gc.collect()
    torch.cuda.empty_cache()
    mx.random.seed(0)
    t0 = time.perf_counter()
    net = TransformerLM(**CONFIG, attn_type="flash")
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    net(mx.nd.array(np.zeros((1, 8), np.float32), ctx=mx.gpu(0)))
    step = train_step_block(mx, net)
    step.cast("bfloat16")
    lr = 0.01
    trainer = mx.gluon.Trainer(step.collect_params(), "sgd",
                               {"learning_rate": lr, "momentum": 0.9,
                                "multi_precision": True})
    # the weight whose float32 master the first step is held to
    probe = next(i for i, p in enumerate(trainer._params)
                 if p.name.endswith(f"l{L - 1}_ffn2_weight"))
    toks = np.random.RandomState(0).randint(
        0, CONFIG["vocab"], (TRAIN_BATCH, CONFIG["max_len"] + 1)).astype(
            np.float32)
    x = mx.nd.array(toks[:, :-1], ctx=mx.gpu(0))
    y = mx.nd.array(toks[:, 1:], ctx=mx.gpu(0))
    print(f"train net: bf16 with f32 masters, built in "
          f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, walls, per_step = [], [], []
    for i in range(TRAIN_STEPS):
        before, calls = read_counts(), dict(UPDATE_CALLS)
        t0 = time.perf_counter()
        with mx.autograd.record():
            loss = step(x, y)
        loss.backward()
        if i == 0:
            weight = trainer._params[probe]
            start, grad = weight.data().float(), weight.grad().float()
        trainer.step(TRAIN_BATCH)
        torch.cuda.synchronize()
        u = {k: UPDATE_CALLS[k] - calls[k] for k in calls}
        check(u == {"update_all": 1, "per_key": 0}, f"training step {i}: "
              f"updater calls {u}; want one update_all, no per-key call")
        walls.append(time.perf_counter() - t0)
        if i == 0:
            master = trainer._updater.states[probe][1]
            moved = -lr * (grad * (1.0 / TRAIN_BATCH))
            scale = moved.abs().max().item()
            master_err = (master - (start + moved)).abs().max().item() / scale
            check(scale > 0 and master_err <= TOL_MASTER, f"the first step "
                  f"moved {weight.name}'s float32 master by other than "
                  f"-lr * rescale_grad * grad: max |diff| over max |step| "
                  f"{master_err:.3e}")
            check(torch.equal(weight.data(), master.to(torch.bfloat16)),
                  f"{weight.name} is not its float32 master rounded")
            del start, grad, moved      # out of the later steps' peak
        losses.append(loss.item())
        after = read_counts()
        per_step.append({k: after[k] - before[k] for k in after})
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    steady = statistics.median(walls[1:])
    print(f"main path training bf16, B={TRAIN_BATCH} T={CONFIG['max_len']}:"
          f" losses {[round(v, 4) for v in losses]}")
    print(f"  step times (host clock, synchronized) "
          f"{[round(w * 1e3, 1) for w in walls]} ms; after the first: median "
          f"{steady * 1e3:.1f} ms, {TRAIN_BATCH * CONFIG['max_len'] / steady:.0f}"
          f" tokens/s; peak memory {peak / 2 ** 30:.2f} GiB "
          f"(max_memory_allocated)")
    print(f"  first step, {weight.name}: float32 master against the start "
          f"plus -lr * rescale_grad * grad, max |diff| over max |step| "
          f"{master_err:.3e} (limit {TOL_MASTER}; largest step {scale:.3e})")
    print(f"  kernel launches on the training path: {counts}")
    check(all(np.isfinite(losses)), f"training losses not finite: {losses}")
    check(losses[-1] < losses[0], f"training loss did not fall: {losses}")
    for i, c in enumerate(per_step):
        check(c["flash_attention.sm90"] == L and c["flash_attention.f32"] == 0
              and c["flash_attention.bwd"] == L
              and c["flash_attention.bwd.sm90"] == L
              and c["flash_attention.bwd.f32"] == 0,
              f"step {i}: launches {c}; want {L} sm90, 0 f32, {L} K1b, all "
              "on sm90")

    def one_step():
        with mx.autograd.record():
            loss = step(x, y)
        loss.backward()
        trainer.step(TRAIN_BATCH)

    # where a step's time goes, outside the counted run
    rows = kernel_rows(one_step)
    if rows:
        groups = {"K1b": ("dq_kernel", "dkdv_kernel", "delta_kernel"),
                  "K1": ("flash_attention_fwd",),
                  "GEMM": ("nvjet", "gemm", "xmma", "cutlass")}
        busy = sum(r[0] for r in rows)
        shares = {g: sum(r[0] for r in rows
                         if any(k in r[2] for k in keys))
                  for g, keys in groups.items()}
        print(f"  one step under torch.profiler: {busy:.3f} ms of kernel "
              f"time in {sum(r[1] for r in rows)} launches, "
              f"{100 * busy / (steady * 1e3):.1f}% of the median step; "
              + ", ".join(f"{g} {ms:.3f} ms" for g, ms in shares.items())
              + f", other {busy - sum(shares.values()):.3f} ms")
        for ms, count, key in rows[:10]:
            print(f"  {ms:8.3f} ms  x{count:<4d} {key[:90]}")
    else:
        print("  step kernel time not measured: torch.profiler saw no "
              "device time")
    lo, hi = PER_KEY_STEP_MS["phase 9 LM"]
    print(f"  one update_all per step, no per-key updater call; the median "
          f"step {steady * 1e3:.1f} ms beside {lo}-{hi} ms with the per-key "
          "updater")
    live = list(enumerate(trainer._params))
    print_optimizer_launches(
        f"the optimizer step over {len(live)} parameters (SGD momentum, "
        "float32 masters)", optimizer_launches(
            trainer._updater, [i for i, _ in live],
            [p.grad() for _, p in live], [p.data() for _, p in live]))
    return counts, {"step_ms": steady * 1e3, "peak_gib": peak / 2 ** 30,
                    "losses": losses}


# --------------------------------------------------------------------------
# phase 10: the vision path
# --------------------------------------------------------------------------
GOLDEN_SHAPES = {"alexnet": (2, 3, 224, 224), "densenet121": (1, 3, 224, 224),
                 "inception_v3": (1, 3, 299, 299),
                 "mobilenet0_25": (2, 3, 64, 64),
                 "resnet18_v1": (2, 3, 64, 64), "resnet18_v2": (2, 3, 64, 64),
                 "squeezenet1_0": (2, 3, 64, 64)}
TOL_GOLDEN = 1e-4   # the fixtures' own pin (tests/test_golden_forward.py)
VISION_MODEL = "resnet50_v1"
VISION_BATCH = 256  # bench.py's ResNet-50 configuration: B=256, 224x224,
VISION_IMG = 224    # SGD momentum 0.9, wd 1e-4, lr 0.05, multi_precision
VISION_STEPS = 8
VISION_LR = 0.05
# the first BatchNorm's moving mean after one step against 0.1 x the batch
# mean of its input, max |diff| over the largest: the reference's bf16 pin
TOL_BN_MEAN = 3e-2
# resnet18_v1 at B=2, 64x64, float32, one step on the card against the
# same step on the CPU: each gradient within this share of its largest
# magnitude, the updated moving statistics within TOL_AUX_CPU absolute
TOL_GRAD_CPU = 1e-3
TOL_AUX_CPU = 1e-4
GRAD_VISION_SHAPE = (2, 3, 64, 64)
# the eval-mode forward: the same image in two batches, max |diff| of its
# logits over their largest magnitude (bf16)
TOL_EVAL_ROW = 3e-2
# kernel-name groups of a vision step's breakdown, first match wins:
# cuDNN's layout transposes around its NHWC bf16 kernels; implicit-GEMM
# convolutions forward (fprop, precomputed_convolve) and backward (dgrad,
# wgrad); PyTorch's native batch-norm kernels; cuBLAS/CUTLASS GEMMs (the
# Dense layer and the convolutions cuDNN runs as plain GEMMs); the rest of
# cuDNN's helpers; PyTorch's elementwise, reduction, fill and copy kernels
KERNEL_GROUPS = (
    ("layout transposes", ("nchwToNhwc", "nhwcToNchw")),
    ("conv forward", ("fprop", "convolve")),
    ("conv backward", ("dgrad", "wgrad")),
    ("batch norm", ("batch_norm",)),
    ("pooling", ("pool",)),
    ("GEMM", ("gemm", "nvjet")),
    ("other cuDNN", ("cudnn", "xmma", "cask")),
    ("elementwise and reductions", ("elementwise", "reduce", "Memset",
                                    "Memcpy", "softmax", "scatter_gather")),
)


def golden_net(mx, name, ctx):
    """The JAX package's golden case built with the port: seed 0, Xavier
    gaussian 'in' magnitude 2, input from RandomState(42)."""
    import numpy as np
    from mxnet_tpu_torch.gluon.model_zoo import vision
    mx.random.seed(0)
    net = getattr(vision, name)()
    net.initialize(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                  magnitude=2), ctx=ctx)
    rs = np.random.RandomState(42)
    x = mx.nd.array(rs.normal(0, 1, GOLDEN_SHAPES[name]).astype(np.float32),
                    ctx=ctx)
    return net, x


def phase_goldens(mx):
    """The seven vision goldens on the card in float32 (TF32 off)."""
    import numpy as np
    errs = {}
    for name in sorted(GOLDEN_SHAPES):
        net, x = golden_net(mx, name, mx.gpu(0))
        got = mx.nd.asnumpy(net(x))
        want = np.load(os.path.join(ROOT, "tests", "golden",
                                    f"{name}.npz"))["logits"]
        check(got.shape == want.shape, f"golden {name}: shape {got.shape}")
        err = float(np.abs(got - want).max())
        over = float((np.abs(got - want) - TOL_GOLDEN * np.abs(want)).max())
        errs[name] = err
        print(f"  golden {name} {GOLDEN_SHAPES[name]}: max |diff| {err:.3e} "
              f"(largest logit {np.abs(want).max():.3f})")
        check(over <= TOL_GOLDEN, f"golden {name} off by {err:.3e} "
              f"(limit {TOL_GOLDEN} + {TOL_GOLDEN} x |logit|)")
    return errs


def vision_batch(mx, n, seed=0):
    """``bench.py``'s synthetic batch: normal images whose first channel's
    top-left 4x4 corner is shifted by the class (labels / 500 - 1), so the
    classes are learnable; images bf16 and labels float32, on the card."""
    import numpy as np
    import torch
    rs = np.random.RandomState(seed)
    labels = rs.randint(0, 1000, n).astype(np.float32)
    data = torch.from_numpy(rs.normal(0, 1, (n, 3, VISION_IMG, VISION_IMG))
                            .astype(np.float32))
    data[:, 0, :4, :4] += torch.from_numpy(labels / 500.0 - 1.0)[:, None,
                                                                    None]
    return (data.to(mx.context.as_device(mx.gpu(0)), torch.bfloat16),
            mx.nd.array(labels, ctx=mx.gpu(0)))


def bn_params(net):
    return [p for n, p in net.collect_params().items()
            if n.endswith("running_var")]


def vision_step(mx, net, trainer, loss_fn, x, y):
    with mx.autograd.record():
        loss = loss_fn(mx.nd.Cast(net(x), dtype="float32"), y)
    mx.autograd.backward([loss])
    trainer.step(x.shape[0])
    return loss


def phase_vision_train(mx):
    """ResNet-50 v1 through Gluon in bfloat16 with float32 masters, as
    ``bench.py`` configures it: VISION_STEPS steps on one resident batch,
    the moving statistics after the first, then an eval-mode forward."""
    import gc
    import numpy as np
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mx.random.seed(0)
    net = mx.gluon.model_zoo.vision.get_model(VISION_MODEL)
    net.initialize(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                  magnitude=2), ctx=mx.gpu(0))
    x, y = vision_batch(mx, VISION_BATCH)
    net(x[:1].float())       # the first forward resolves deferred shapes
    net.cast("bfloat16")
    net.hybridize()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": VISION_LR, "momentum": 0.9,
                                "wd": 1e-4, "multi_precision": True})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    n_params = sum(p.data().numel() for p in net.collect_params().values())
    print(f"  {VISION_MODEL}: {n_params} parameters ({len(bn_params(net))} "
          f"BatchNorms), bf16 with f32 masters, built in "
          f"{time.perf_counter() - t0:.1f} s; batch B={VISION_BATCH} "
          f"{VISION_IMG}x{VISION_IMG} resident on the card")
    # the first BatchNorm's input at the first step: the stem conv's output
    stem, bn0 = net.features[0], net.features[1]
    with torch.no_grad():
        stem_mean = stem(x).float().mean(dim=(0, 2, 3))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, walls = [], []
    for i in range(VISION_STEPS):
        t0 = time.perf_counter()
        loss = vision_step(mx, net, trainer, loss_fn, x, y)
        losses.append(loss.mean().item())       # synchronizes
        walls.append(time.perf_counter() - t0)
        if i == 0:
            rm = bn0.running_mean.data().float()
            want = 0.1 * stem_mean
            bn_err = (rm - want).abs().max().item() / want.abs().max().item()
            still = [p.name for p in bn_params(net)
                     if torch.equal(p.data(), torch.ones_like(p.data()))]
    peak = torch.cuda.max_memory_allocated()
    counts = read_counts()
    steady = statistics.median(walls[1:])
    print(f"  losses {[round(v, 4) for v in losses]}")
    print(f"  step times (host clock, synchronized) "
          f"{[round(w * 1e3, 1) for w in walls]} ms; first {walls[0] * 1e3:.1f}"
          f" ms; after it: median {steady * 1e3:.1f} ms, "
          f"{VISION_BATCH / steady:.1f} images/s; peak memory "
          f"{peak / 2 ** 30:.2f} GiB (max_memory_allocated)")
    print(f"  first BatchNorm after step 1: running_mean against 0.1 x the "
          f"batch mean of its input, max |diff| over the largest {bn_err:.3e}"
          f" (limit {TOL_BN_MEAN}); running_var still all ones in "
          f"{len(still)} of {len(bn_params(net))} BatchNorms")
    check(all(np.isfinite(losses)), f"vision losses not finite: {losses}")
    check(losses[-1] < losses[0], f"vision loss did not fall: {losses}")
    check(bn_err <= TOL_BN_MEAN, f"moving mean off by {bn_err:.3e}")
    check(not still, f"running_var never moved: {still}")
    check(not any(counts.values()), f"the vision path launched a flash "
          f"kernel: {counts}")

    # inference: the moving statistics normalise, so an image's logits do
    # not depend on the rest of its batch
    other = torch.flip(x, dims=(3,))
    other[-1] = x[0]
    with mx.autograd.predict_mode():
        a, b = net(x), net(other)
    row_err = ((a[0].float() - b[-1].float()).abs().max()
               / a[0].float().abs().max()).item()
    infer_ms = host_clock_ms(lambda: net(x))
    print(f"  eval forward B={VISION_BATCH}: {infer_ms:.1f} ms (host clock, "
          f"median of 5), {VISION_BATCH / infer_ms * 1e3:.1f} images/s; the "
          f"same image in two batches: max |diff| over max |logit| "
          f"{row_err:.3e} (limit {TOL_EVAL_ROW})")
    check(row_err <= TOL_EVAL_ROW, "eval mode depends on the batch: "
          f"{row_err:.3e}")
    breakdown = phase_vision_profile(mx, net, trainer, loss_fn, x, y,
                                     steady * 1e3)
    return net, {"step_ms": steady * 1e3, "first_ms": walls[0] * 1e3,
                 "images_s": VISION_BATCH / steady, "peak_gib": peak / 2 ** 30,
                 "infer_ms": infer_ms, "losses": losses,
                 "breakdown": breakdown}


def group_rows(rows):
    """{group: (ms, launches)} of profiler rows by KERNEL_GROUPS, first
    match wins; the rest under "other"."""
    out = {}
    for ms, count, key in rows:
        group = next((g for g, keys in KERNEL_GROUPS
                      if any(k in key for k in keys)), "other")
        t, c = out.get(group, (0.0, 0))
        out[group] = (t + ms, c + count)
    return out


def phase_vision_profile(mx, net, trainer, loss_fn, x, y, step_ms):
    """Where one training step's time goes: forward and backward under one
    torch.profiler session, the optimizer step under another (its
    gradients marked fresh again, as a backward would), each kernel put in
    a group; host gaps are the median step less both."""
    live = [p for p in net.collect_params().values() if p.grad_req != "null"]

    def fwd_bwd():
        with mx.autograd.record():
            loss = loss_fn(mx.nd.Cast(net(x), dtype="float32"), y)
        mx.autograd.backward([loss])

    def opt_step():
        for p in live:
            p.fresh_grad = True
        trainer.step(VISION_BATCH)

    fb_wall = host_clock_ms(fwd_bwd)
    opt_wall = host_clock_ms(opt_step)
    fb_rows = kernel_rows(fwd_bwd)
    opt_rows = kernel_rows(opt_step)
    print(f"  one step by part (host clock, medians of 5): forward+backward "
          f"{fb_wall:.1f} ms, optimizer step {opt_wall:.1f} ms")
    if not fb_rows or not opt_rows:
        print("  kernel time not measured: torch.profiler saw no device time")
        return {"fwd_bwd_ms": fb_wall, "optimizer_ms": opt_wall}
    groups = group_rows(fb_rows)
    fb_busy = sum(r[0] for r in fb_rows)
    opt_busy = sum(r[0] for r in opt_rows)
    groups["optimizer (per-tensor ops)"] = (opt_busy,
                                            sum(r[1] for r in opt_rows))
    gaps = step_ms - fb_busy - opt_busy
    print(f"  kernel time: forward+backward {fb_busy:.3f} ms in "
          f"{sum(r[1] for r in fb_rows)} launches, optimizer {opt_busy:.3f} ms"
          f"; host gaps (median step less both) {gaps:.3f} ms")
    for g, (ms, count) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"    {g}: {ms:.3f} ms, {count} launches, "
              f"{100 * ms / step_ms:.1f}% of the step")
    for ms, count, key in fb_rows[:12]:
        print(f"    {ms:8.3f} ms  x{count:<4d} {key[:100]}")
    out = {g: ms for g, (ms, _) in groups.items()}
    out["host gaps"] = gaps
    return out


def phase_vision_grad(mx):
    """One float32 step of resnet18_v1 (B=2, 64x64, hybridized, SGD with
    momentum) on the card and on the CPU from the same seed: every
    gradient within TOL_GRAD_CPU of its largest magnitude, the moving
    statistics within TOL_AUX_CPU."""
    import numpy as np
    rs = np.random.RandomState(3)
    xs = rs.normal(size=GRAD_VISION_SHAPE).astype(np.float32)
    ys = rs.randint(0, 1000, GRAD_VISION_SHAPE[0]).astype(np.float32)
    res = []
    for ctx in (mx.cpu(), mx.gpu(0)):
        mx.random.seed(0)
        net = mx.gluon.model_zoo.vision.resnet18_v1()
        net.initialize(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                      magnitude=2), ctx=ctx)
        net.hybridize()
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.1, "momentum": 0.9})
        x, y = mx.nd.array(xs, ctx=ctx), mx.nd.array(ys, ctx=ctx)
        with mx.autograd.record():
            loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()(net(x), y)
        mx.autograd.backward([loss])
        params = net.collect_params()
        res.append((
            mx.nd.asnumpy(loss),
            {n[len(net.prefix):]: mx.nd.asnumpy(p.grad())
             for n, p in params.items() if p.grad_req != "null"},
            {n[len(net.prefix):]: mx.nd.asnumpy(p.data())
             for n, p in params.items() if "running" in n}))
        trainer.step(GRAD_VISION_SHAPE[0])
    (lc, gc_, ac), (lg, gg, ag) = res
    grad_err = max(np.abs(gg[n] - g).max() / max(np.abs(g).max(), 1e-30)
                   for n, g in gc_.items())
    aux_err = max(np.abs(ag[n] - a).max() for n, a in ac.items())
    print(f"  resnet18_v1 f32 B={GRAD_VISION_SHAPE[0]} "
          f"{GRAD_VISION_SHAPE[2]}x{GRAD_VISION_SHAPE[3]}, card against CPU:"
          f" loss {lg.mean():.6f} / {lc.mean():.6f}; {len(gc_)} gradients, "
          f"max |diff| over each's largest {grad_err:.3e} (limit "
          f"{TOL_GRAD_CPU}); {len(ac)} moving statistics, max |diff| "
          f"{aux_err:.3e} (limit {TOL_AUX_CPU})")
    check(grad_err <= TOL_GRAD_CPU, f"card gradients off: {grad_err:.3e}")
    check(aux_err <= TOL_AUX_CPU, f"card moving statistics off: {aux_err:.3e}")
    return grad_err, aux_err


def phase_vision_data(mx, net):
    """A DataLoader over an ArrayDataset feeds two small batches to the
    card; the trained net scores them in eval mode and ``metric``
    counts them."""
    import numpy as np
    import torch
    rs = np.random.RandomState(9)
    images = rs.normal(size=(8, 3, VISION_IMG, VISION_IMG)).astype(np.float32)
    labels = rs.randint(0, 1000, 8).astype(np.float32)
    loader = mx.gluon.data.DataLoader(
        mx.gluon.data.ArrayDataset(images, labels), batch_size=4,
        shuffle=True, num_workers=2)
    acc = mx.metric.Accuracy()
    seen = []
    dev = mx.context.as_device(mx.gpu(0))
    with mx.gpu(0):
        for i, (xb, yb) in enumerate(loader):
            check(xb.device == dev and yb.device == dev,
                  f"batch {i} not on the card: {xb.device}")
            seen += mx.nd.asnumpy(yb).tolist()
            with mx.autograd.predict_mode():
                out = net(xb.to(torch.bfloat16))
            acc.update([yb], [out])
            if i == 1:
                break
    check(sorted(seen) == sorted(labels.tolist()), "the loader lost samples")
    print(f"  DataLoader: 2 batches of 4 on {xb.device}, shuffled, 2 workers;"
          f" scored by the trained net, {acc.get()}")


# --------------------------------------------------------------------------
# phase 11: the symbolic path (Symbol -> Module.fit -> Executor -> KVStore)
# --------------------------------------------------------------------------
MODULE_EPOCHS = 3   # bench.py's EPOCHS and BATCHES_PER_EPOCH: epoch 0 warms
MODULE_BATCHES = 8  # up, epochs 1-2 are timed
# resnet18_v1 f32 (B=2, 64x64): one Module step against one Gluon step from
# the same weights, max |diff| of each parameter over its largest change,
# and of the moving statistics absolute
TOL_MODULE_GLUON = 1e-3
TOL_MODULE_AUX = 1e-4
LM_MODULE_STEPS = 3
LM_MODULE_LR = 0.1  # SGD momentum 0.9 on the token-normalized gradient


class DeviceNLL:
    """``bench.py``'s LossMetric: each batch's NLL of the label under the
    predicted probabilities kept on the card, no host copy per batch; all
    of them read once at the end (``materialize``)."""

    def __init__(self, mx):
        import torch
        self._torch = torch

        class _Metric(mx.metric.EvalMetric):
            def __init__(self):
                super().__init__("nll")
                self.vals = []

            def update(self, labels, preds):
                p = preds[0].float()
                lab = labels[0].long().unsqueeze(-1)
                self.vals.append(-torch.log(p.gather(-1, lab) + 1e-8).mean())
                self.num_inst += 1

            def get(self):
                return ("nll", float(torch.stack(self.vals).mean())
                        if self.vals else float("nan"))

        self.metric = _Metric()

    def materialize(self):
        return [float(v) for v in self._torch.stack(self.metric.vals)]


def resnet_symbol(mx, name):
    """``bench.py``'s symbol: the model zoo's ``name`` on a data variable,
    then ``SoftmaxOutput``."""
    from mxnet_tpu_torch.gluon.model_zoo import vision
    net = getattr(vision, name)()
    return mx.sym.SoftmaxOutput(net(mx.sym.Variable("data")), name="softmax")


def module_data(mx, n):
    """``bench.py``'s synthetic set (``vision_batch``'s recipe for ``n``
    images), drawn on the card from seed 0 so that 2048 images need no
    host round trip: bf16 images, float32 labels, resident."""
    import torch
    dev = mx.context.as_device(mx.gpu(0))
    g = torch.Generator(device=dev).manual_seed(0)
    labels = torch.randint(0, 1000, (n,), generator=g, device=dev).float()
    data = torch.randn((n, 3, VISION_IMG, VISION_IMG), generator=g,
                       device=dev)
    data[:, 0, :4, :4] += (labels / 500.0 - 1.0)[:, None, None]
    return data.to(torch.bfloat16), labels


def bind_resnet_module(mx, sym):
    """``bench.py``'s Module: ``sym`` bound on gpu(0) with bf16 data of
    B=256 at 224x224 and float32 labels, Xavier gaussian 'in' magnitude 2
    from seed 0, SGD lr 0.05, momentum 0.9, wd 1e-4 with float32 masters
    on the ``tpu_sync`` kvstore."""
    import numpy as np
    mod = mx.mod.Module(sym, context=mx.gpu(0))
    mod.bind(data_shapes=[mx.io.DataDesc(
                 "data", (VISION_BATCH, 3, VISION_IMG, VISION_IMG),
                 "bfloat16")],
             label_shapes=[mx.io.DataDesc("softmax_label", (VISION_BATCH,),
                                          np.float32)])
    mx.random.seed(0)
    mod.init_params(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                   magnitude=2))
    mod.init_optimizer(kvstore="tpu_sync", optimizer="sgd",
                       optimizer_params={"learning_rate": VISION_LR,
                                         "momentum": 0.9, "wd": 1e-4,
                                         "multi_precision": True})
    return mod


def phase_module_resnet(mx, gluon):
    """``bench.py``'s path through the port: ResNet-50 v1's symbol,
    ``Module`` on gpu(0) bound with bf16 data, Xavier, SGD with f32 masters
    on the ``tpu_sync`` kvstore (updates on its pushpull), ``fit`` for 3
    epochs of 8 resident batches with the NLL kept on the card and one
    synchronisation per epoch."""
    import gc
    import numpy as np
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sym = resnet_symbol(mx, VISION_MODEL)
    n = VISION_BATCH * MODULE_BATCHES
    data, labels = module_data(mx, n)
    it = mx.io.NDArrayIter(data, labels, batch_size=VISION_BATCH)
    mod = bind_resnet_module(mx, sym)
    ex = mod._exec
    dtypes = {str(t.dtype)[6:] for t in ex.arg_dict.values()}
    bn_f32 = all(t.dtype == torch.float32 for n_, t in
                 list(ex.arg_dict.items()) + list(ex.aux_dict.items())
                 if "batchnorm" in n_)
    w_bf16 = all(t.dtype == torch.bfloat16 for n_, t in ex.arg_dict.items()
                 if n_.endswith("_weight") and "batchnorm" not in n_)
    print(f"  {VISION_MODEL} symbol: {len(sym.list_arguments())} arguments, "
          f"{len(sym.list_auxiliary_states())} aux states; bound in "
          f"{time.perf_counter() - t0:.1f} s (dtypes {sorted(dtypes)}; "
          f"kvstore {mod._kvstore.type}, update on the store: "
          f"{mod._update_on_kvstore}); {n} images resident on the card")
    check(w_bf16 and bn_f32, "bf16 data did not give bf16 weights and "
          "float32 BatchNorm parameters and statistics")
    check(mod._kvstore is not None and mod._update_on_kvstore,
          "tpu_sync did not give a store that updates")
    metric = DeviceNLL(mx)
    marks = []

    def epoch_end(epoch, sym_, arg, aux):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    calls = dict(UPDATE_CALLS)
    marks.append(time.perf_counter())
    mod.fit(it, num_epoch=MODULE_EPOCHS, eval_metric=metric.metric,
            epoch_end_callback=epoch_end)
    counts = read_counts()
    u = {k: UPDATE_CALLS[k] - calls[k] for k in calls}
    check(u == {"update_all": MODULE_EPOCHS * MODULE_BATCHES, "per_key": 0},
          f"Module.fit updater calls {u}; want one update_all per step "
          "(the store's pushpull) and no per-key call")
    peak = torch.cuda.max_memory_allocated()
    losses = metric.materialize()
    epochs = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    steps = [e / MODULE_BATCHES for e in epochs[1:]]
    step = (marks[-1] - marks[1]) * 1e3 / (MODULE_BATCHES *
                                           (MODULE_EPOCHS - 1))
    final = float(np.mean(losses[-MODULE_BATCHES:]))
    print(f"  fit: epochs {[round(e, 1) for e in epochs]} ms (host clock, "
          f"one synchronisation each; the first warms up); per step over "
          f"the timed epochs {[round(v, 1) for v in steps]} ms, {step:.1f} ms"
          f" over both, {VISION_BATCH / step * 1e3:.1f} images/s; peak "
          f"memory {peak / 2 ** 30:.2f} GiB (max_memory_allocated)")
    print(f"  beside phase 10's Gluon step: {gluon['step_ms']:.1f} ms, "
          f"{gluon['images_s']:.1f} images/s, peak {gluon['peak_gib']:.2f} "
          f"GiB; Module over Gluon {step / gluon['step_ms']:.3f}x")
    print(f"  NLL per batch {[round(v, 4) for v in losses]}; last epoch "
          f"mean {final:.4f}")
    check(np.isfinite(losses).all(), f"Module losses not finite: {losses}")
    check(final < max(losses[0] * 1.2, np.log(1000.0) + 0.5),
          f"bench.py's loss check failed: final {final:.4f}, first "
          f"{losses[0]:.4f}")
    check(not any(counts.values()), f"the Module vision path launched a "
          f"kernel of the repo: {counts}")

    # one step by part: the host's enqueue time and the kernels
    batch = next(iter(it))
    it.reset()

    def one_step():
        mod.forward_backward(batch)
        mod.update()
        mod.update_metric(metric.metric, batch.label)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one_step()
    enqueue = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    rows = kernel_rows(one_step)
    out = {"step_ms": step, "images_s": VISION_BATCH / step * 1e3,
           "first_epoch_ms": epochs[0], "peak_gib": peak / 2 ** 30,
           "losses": losses, "enqueue_ms": enqueue}
    if rows:
        busy = sum(r[0] for r in rows)
        out["kernel_ms"], out["host_gaps_ms"] = busy, step - busy
        print(f"  one Module step: the call returns after {enqueue:.1f} ms "
              f"(its last kernel queued; a full launch queue holds it back);"
              f" kernel time {busy:.3f} ms"
              f" in {sum(r[1] for r in rows)} launches; host gaps (the "
              f"fit step less it) {step - busy:.3f} ms, beside phase 10's "
              f"Gluon step's {gluon['breakdown'].get('host gaps', float('nan')):.3f}"
              " ms")
        for g, (ms, count) in sorted(group_rows(rows).items(),
                                     key=lambda kv: -kv[1][0]):
            print(f"    {g}: {ms:.3f} ms, {count} launches (phase 10's "
                  f"Gluon step: {gluon['breakdown'].get(g, float('nan')):.3f}"
                  " ms)")
    else:
        print(f"  one Module step: the call returns after {enqueue:.1f} ms;"
              " kernel time not measured: torch.profiler saw no device "
              "time")
    lo, hi = PER_KEY_STEP_MS["phase 11 ResNet-50 Module"]
    print(f"  {u['update_all']} update_all calls in "
          f"{MODULE_EPOCHS * MODULE_BATCHES} steps (the store's pushpull), "
          f"no per-key updater call; the step {step:.1f} ms beside {lo}-{hi}"
          " ms with the per-key updater")
    kv = mod._kvstore
    names = [n for n in mod._param_names if n in ex.grad_dict]
    print_optimizer_launches(
        f"the store's optimizer step over {len(names)} parameters (SGD "
        "momentum, float32 masters)", optimizer_launches(
            kv._updater, names, [ex.grad_dict[n] for n in names],
            [kv._store[n] for n in names]))
    del mod, ex, it, data, labels, kv
    return out


def phase_module_vs_gluon(mx):
    """resnet18_v1 in float32 (TF32 off), B=2 at 64x64, from the same
    weights: one Module forward_backward + update with SoftmaxOutput
    against one Gluon record/backward/Trainer.step(2) with
    SoftmaxCrossEntropyLoss; both take (p - onehot) / batch."""
    import numpy as np
    import torch
    rs = np.random.RandomState(3)
    xs = rs.normal(size=GRAD_VISION_SHAPE).astype(np.float32)
    ys = rs.randint(0, 1000, GRAD_VISION_SHAPE[0]).astype(np.float32)
    ctx = mx.gpu(0)
    opt = {"learning_rate": 0.1, "momentum": 0.9}
    mx.random.seed(0)
    net = mx.gluon.model_zoo.vision.resnet18_v1()
    net.initialize(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                  magnitude=2), ctx=ctx)
    x, y = mx.nd.array(xs, ctx=ctx), mx.nd.array(ys, ctx=ctx)
    net(x)                                  # resolves the deferred shapes
    params = {p.name: p for p in net.collect_params().values()}
    start = {n: p.data().clone() for n, p in params.items()}
    sym = mx.sym.SoftmaxOutput(net(mx.sym.var("data")), name="softmax")
    aux_names = set(sym.list_auxiliary_states())
    mod = mx.mod.Module(sym, context=ctx)
    mod.bind([("data", GRAD_VISION_SHAPE)],
             [("softmax_label", (GRAD_VISION_SHAPE[0],))])
    mod.init_params(arg_params={n: t for n, t in start.items()
                                if n not in aux_names},
                    aux_params={n: t for n, t in start.items()
                                if n in aux_names})
    mod.init_optimizer(optimizer="sgd", optimizer_params=opt)
    mod.forward_backward(mx.io.DataBatch([x], [y]))
    mod.update()
    m_arg, m_aux = mod.get_params()

    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", dict(opt))
    with mx.autograd.record():
        loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()(net(x), y)
    mx.autograd.backward([loss])
    trainer.step(GRAD_VISION_SHAPE[0])
    param_err, aux_err = 0.0, 0.0
    for n, p in params.items():
        got = (m_aux if n in aux_names else m_arg)[n].float()
        want = p.data().float()
        if n in aux_names:
            aux_err = max(aux_err, (got - want).abs().max().item())
        else:
            moved = (want - start[n].float()).abs().max().item()
            err = (got - want).abs().max().item()
            param_err = max(param_err, err / moved if moved else err)
    n_args = len(params) - len(aux_names)
    print(f"  resnet18_v1 f32 B={GRAD_VISION_SHAPE[0]}, Module step "
          f"against Gluon step from the same weights: {n_args} parameters, "
          f"max |diff| over each one's largest change {param_err:.3e} (limit"
          f" {TOL_MODULE_GLUON}); {len(aux_names)} moving statistics, max "
          f"|diff| {aux_err:.3e} (limit {TOL_MODULE_AUX})")
    check(param_err <= TOL_MODULE_GLUON, f"Module and Gluon steps differ: "
          f"{param_err:.3e}")
    check(aux_err <= TOL_MODULE_AUX, f"Module and Gluon moving statistics "
          f"differ: {aux_err:.3e}")
    del mod, net, trainer
    torch.cuda.empty_cache()
    return param_err, aux_err


@contextlib.contextmanager
def mirrored(on=True):
    """``MXNET_BACKWARD_DO_MIRROR`` set while the executors are bound (the
    executor reads it when it is made)."""
    old = os.environ.get("MXNET_BACKWARD_DO_MIRROR")
    if on:
        os.environ["MXNET_BACKWARD_DO_MIRROR"] = "1"
    else:
        os.environ.pop("MXNET_BACKWARD_DO_MIRROR", None)
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("MXNET_BACKWARD_DO_MIRROR", None)
        else:
            os.environ["MXNET_BACKWARD_DO_MIRROR"] = old


def phase_module_lm(mx, gluon, mirror=False):
    """The full-width TransformerLM's symbol in bf16 under
    ``SoftmaxOutput(preserve_shape=True, normalization="valid")`` over the
    (8, 1024, 32768) logits, trained through ``Module`` at phase 9's batch:
    every kernel count set to 0, then LM_MODULE_STEPS steps of
    forward_backward + update, each launching K1 and K1b once per layer
    on the sm90 kernels through ``Executor.backward``.  With ``mirror``
    (phase 14) the executor runs in checkpointed segments and each step
    launches K1 twice per layer (the backward runs the forward again)."""
    import gc
    import numpy as np
    import torch
    from mxnet_tpu_torch.gluon.model_zoo.transformer import TransformerLM
    L, B, T = CONFIG["num_layers"], TRAIN_BATCH, CONFIG["max_len"]
    k1_per_step = 2 * L if mirror else L
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mx.random.seed(0)
    net = TransformerLM(**CONFIG, attn_type="flash")
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    net(mx.nd.array(np.zeros((1, 8), np.float32), ctx=mx.gpu(0)))
    net.cast("bfloat16")
    sym = mx.sym.SoftmaxOutput(net(mx.sym.var("data")), preserve_shape=True,
                               normalization="valid", name="softmax")
    weights = {p.name: p.data() for p in net.collect_params().values()}
    mod = mx.mod.Module(sym, context=mx.gpu(0))
    with mirrored(mirror):
        mod.bind([mx.io.DataDesc("data", (B, T), np.float32)],
                 [mx.io.DataDesc("softmax_label", (B, T), np.float32)])
    mod.init_params(arg_params=weights)
    del net, weights
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": LM_MODULE_LR, "momentum": 0.9,
        "multi_precision": True})
    wdt = {str(t.dtype)[6:] for n, t in mod._exec.arg_dict.items()
           if n not in ("data", "softmax_label")}
    print(f"  LM symbol bound: {len(sym.list_arguments())} arguments "
          f"({sorted(wdt)}), data and label float32, in "
          f"{time.perf_counter() - t0:.1f} s; {mod._exec._segments} "
          f"segment(s) of {len(mod._exec._plan.steps)} steps")
    check(mirror == (mod._exec._segments > 1), f"mirror {mirror} gave "
          f"{mod._exec._segments} segment(s)")
    check(wdt == {"bfloat16"}, f"LM weights bound as {wdt}, not bfloat16")
    toks = np.random.RandomState(0).randint(0, CONFIG["vocab"], (B, T + 1))
    batch = mx.io.DataBatch(
        [mx.nd.array(toks[:, :-1].astype(np.float32), ctx=mx.gpu(0))],
        [mx.nd.array(toks[:, 1:].astype(np.float32), ctx=mx.gpu(0))])
    metric = DeviceNLL(mx)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    walls, per_step = [], []
    for _ in range(LM_MODULE_STEPS):
        before, calls = read_counts(), dict(UPDATE_CALLS)
        t0 = time.perf_counter()
        mod.forward_backward(batch)
        mod.update()
        mod.update_metric(metric.metric, batch.label)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        u = {k: UPDATE_CALLS[k] - calls[k] for k in calls}
        check(u == {"update_all": 1, "per_key": 0}, f"Module LM step: "
              f"updater calls {u}; want one update_all, no per-key call")
        after = read_counts()
        per_step.append({k: after[k] - before[k] for k in after})
    counts = read_counts()
    mod.forward(batch, is_train=False)      # the loss after the last update
    mod.update_metric(metric.metric, batch.label)
    losses = metric.materialize()
    peak = torch.cuda.max_memory_allocated()
    step = statistics.median(walls[1:])
    print(f"  Module LM training bf16{', mirrored' if mirror else ''}, "
          f"B={B} T={T}: NLL {losses} (the last "
          f"after {LM_MODULE_STEPS} updates); step times (host clock, "
          f"synchronized) {[round(w, 1) for w in walls]} ms, after the "
          f"first {step:.1f} ms, {B * T / step * 1e3:.0f} tokens/s; peak "
          f"{peak / 2 ** 30:.2f} GiB; beside phase 9's Gluon step "
          f"{gluon['step_ms']:.1f} ms, peak {gluon['peak_gib']:.2f} GiB")
    print(f"  kernel launches: {counts}")
    check(np.isfinite(losses).all(), f"Module LM losses not finite: {losses}")
    check(losses[-1] < losses[0], f"Module LM loss did not fall: {losses}")
    for i, c in enumerate(per_step):
        check(c["flash_attention.sm90"] == k1_per_step
              and c["flash_attention.f32"] == 0
              and c["flash_attention.bwd.sm90"] == L
              and c["flash_attention.bwd.f32"] == 0,
              f"Module LM step {i}: launches {c}; want {k1_per_step} sm90 "
              f"K1 and {L} sm90 K1b, none on f32")
    if mirror:
        del mod, batch
        return counts, {"step_ms": step, "peak_gib": peak / 2 ** 30,
                        "losses": losses}

    def one_step():
        mod.forward_backward(batch)
        mod.update()

    rows = kernel_rows(one_step)    # outside the counted, checked steps
    if rows:
        groups = {"K1b": ("dq_kernel", "dkdv_kernel", "delta_kernel"),
                  "K1": ("flash_attention_fwd",),
                  "GEMM": ("nvjet", "gemm", "xmma", "cutlass")}
        busy = sum(r[0] for r in rows)
        shares = {g: sum(r[0] for r in rows if any(k in r[2] for k in keys))
                  for g, keys in groups.items()}
        print(f"  one Module LM step under torch.profiler: {busy:.3f} ms of "
              f"kernel time in {sum(r[1] for r in rows)} launches, host gaps "
              f"(the median step less it) {step - busy:.3f} ms; "
              + ", ".join(f"{g} {ms:.3f} ms" for g, ms in shares.items())
              + f", other {busy - sum(shares.values()):.3f} ms")
        for ms, count, key in rows[:8]:
            print(f"    {ms:8.3f} ms  x{count:<4d} {key[:90]}")
    else:
        print("  Module LM step kernel time not measured: torch.profiler saw "
              "no device time")
    del mod, batch
    return counts, {"step_ms": step, "peak_gib": peak / 2 ** 30,
                    "losses": losses}


# ---------------------------------------------------------------------------
# phase 12: the core op surface, MultiHeadAttention, DCGAN
# ---------------------------------------------------------------------------
# every op of the core surface on the card against the same op on the CPU,
# float32 with TF32 off: outputs at 1e-5 relative / 1e-6 absolute (the same
# math summed in another order; float ids and 0/1 results, off by 1 where
# they differ, fail it), integers exact, gradients of sum(out * w) within
# 1e-5 of each gradient's largest magnitude
TOL_OPS_REL = 1e-5
TOL_OPS_ABS = 1e-6
RANDOM_DRAWS = 1_000_000
RANDOM_SE = 5.0     # mean and variance within 5 standard errors
MHA_UNITS = 1024    # the TransformerLM's width: 16 heads of 64
MHA_HEADS = 16
MHA_BATCH = 8
TOL_MHA = 3e-2      # bf16 block against the plain formula in float32, over
                    # the largest magnitude (the reference's bf16 pin)
TOL_MHA_F32 = 1e-4  # the float32 block against the formula in float64, over
                    # the largest magnitude (the reference's f32 flash pin)
# upstream MXNet's example/gluon/dcgan.py defaults
DCGAN = dict(nz=100, ngf=64, ndf=64, batch=64, sigma=0.02, lr=2e-4,
             beta1=0.5, steps=20, resident_batches=4)


def core_op_cases(np):
    """(op, numpy inputs, kwargs, inputs to differentiate) for every
    deterministic op of the core surface: small seeded inputs; ``ctx`` is
    filled with the device the case runs on."""
    rs = np.random.RandomState(12)

    def f(*shape):
        return rs.normal(0, 1, shape).astype(np.float32)

    def r(*shape):                # small integers: ties and zeros
        return np.round(rs.normal(0, 1.2, shape)).astype(np.float32)
    m = rs.normal(0, 1, (2, 3, 3))
    spd = (m @ m.transpose(0, 2, 1) + 3 * np.eye(3)).astype(np.float32)
    chol = np.linalg.cholesky(spd.astype(np.float64)).astype(np.float32)
    pos = (0.5 + np.abs(f(2, 3))).astype(np.float32)
    nonzero = (np.sign(f(2, 3)) * (0.5 + np.abs(f(2, 3)))).astype(np.float32)
    ids = np.array([[0, 2, 0], [1, 3, 1]], np.float32)
    labels = np.array([0, 4, 2, 1], np.float32)
    cases = [("clip", [f(3, 4)], {"a_min": -0.5, "a_max": 0.5}, (0,)),
             ("_copy", [f(2, 3)], {}, (0,)),
             ("add_n", [f(2, 3), f(2, 3), f(2, 3)], {}, (0, 1, 2)),
             ("smooth_l1", [f(3, 4)], {"scalar": 1.5}, (0,)),
             ("broadcast_mod", [f(2, 3) * 3, np.array([[2.0, -2.0, 1.5]],
                                                      np.float32)], {}, (0, 1)),
             ("_mod_scalar", [f(2, 3) * 3], {"scalar": -1.5}, (0,)),
             ("_rmod_scalar", [nonzero], {"scalar": 5.0}, (0,)),
             ("broadcast_power", [pos, f(1, 3)], {}, (0, 1)),
             ("broadcast_hypot", [f(2, 3), f(1, 3)], {}, (0, 1)),
             ("cbrt", [nonzero], {}, (0,))]
    for op in ("broadcast_greater", "broadcast_greater_equal",
               "broadcast_lesser", "broadcast_lesser_equal",
               "broadcast_not_equal", "broadcast_logical_and",
               "broadcast_logical_or", "broadcast_logical_xor"):
        cases.append((op, [r(2, 3), r(1, 3)], {}, ()))
    for op in ("_greater_scalar", "_greater_equal_scalar", "_lesser_scalar",
               "_lesser_equal_scalar", "_not_equal_scalar"):
        cases.append((op, [r(2, 3)], {"scalar": 0.0}, ()))
    cases += [
        ("dot", [f(3, 4, 2), f(4, 5)], {"transpose_a": True}, (0, 1)),
        ("dot", [f(2, 3, 4), f(4, 5)], {}, (0, 1)),
        ("batch_dot", [f(2, 4, 3), f(2, 4, 5)], {"transpose_a": True}, (0, 1)),
        ("transpose", [f(2, 3, 4)], {"axes": (2, 0, 1)}, (0,)),
        ("SwapAxis", [f(2, 3, 4)], {"dim1": 0, "dim2": 2}, (0,)),
        ("squeeze", [f(2, 1, 3)], {"axis": (1,)}, (0,)),
        ("stack", [f(2, 3), f(2, 3)], {"axis": 2}, (0, 1)),
        ("SliceChannel", [f(2, 6, 3)], {"num_outputs": 3}, (0,)),
        ("slice", [f(4, 5, 6)], {"begin": (None, 4), "end": (None, 0),
                                 "step": (2, -2)}, (0,)),
        ("slice_like", [f(4, 5, 6), f(2, 3, 4)], {"axes": (0, 2)}, (0,)),
        ("broadcast_to", [f(1, 3, 1)], {"shape": (2, 0, 4)}, (0,)),
        ("broadcast_axis", [f(1, 3, 1)], {"axis": (0, 2), "size": (2, 5)},
         (0,)),
        ("reverse", [f(3, 4)], {"axis": (1,)}, (0,)),
        ("Pad", [f(2, 3, 4, 5)], {"mode": "reflect",
                                  "pad_width": (0, 0, 0, 0, 1, 2, 2, 1)}, (0,)),
        ("Pad", [f(2, 3, 4, 5)], {"mode": "constant", "constant_value": 1.5,
                                  "pad_width": (0, 0, 0, 0, 1, 2, 2, 1)}, (0,)),
        ("gather_nd", [f(3, 4), ids], {}, (0,)),
        ("scatter_nd", [f(3), ids], {"shape": (3, 4)}, (0,)),
        ("batch_take", [f(3, 4), np.array([0, 3, 1], np.float32)], {}, (0,)),
        ("zeros_like", [f(2, 3)], {}, ()),
        ("ones_like", [f(2, 3)], {}, ()),
        ("linalg_gemm", [f(2, 3, 4), f(2, 4, 5), f(2, 3, 5)],
         {"alpha": 0.5, "beta": 2.0}, (0, 1, 2)),
        ("linalg_gemm2", [f(2, 4, 3), f(2, 4, 5)], {"transpose_a": True},
         (0, 1)),
        ("linalg_potrf", [spd], {}, (0,)),
        ("linalg_potri", [chol], {}, (0,)),
        ("linalg_trsm", [chol, f(2, 4, 3)], {"rightside": True,
                                             "transpose": True}, (0, 1)),
        ("linalg_trmm", [spd, f(2, 4, 3)], {"rightside": True,
                                            "lower": False}, (0, 1)),
        ("linalg_sumlogdiag", [chol], {}, (0,)),
        ("linalg_syrk", [f(2, 3, 4)], {"transpose": True}, (0,)),
        ("norm", [f(2, 3, 4)], {"axis": (1, 2)}, (0,)),
        ("argmin", [f(3, 7)], {"axis": -1, "keepdims": True}, ()),
        ("argmin", [f(3, 7)], {}, ()),
        ("argmax_channel", [f(3, 7)], {}, ()),
        ("_full", [], {"shape": (2, 3), "value": 1.5, "ctx": None}, ()),
        ("_eye", [], {"N": 3, "M": 4, "k": 1, "ctx": None}, ()),
        ("softmax_cross_entropy", [f(4, 5), labels], {}, (0,)),
        ("SoftmaxActivation", [f(2, 3, 4)], {"mode": "channel"}, (0,)),
        ("L2Normalization", [f(2, 3, 4)], {}, (0,)),
        ("SVMOutput", [f(4, 5) * 2, labels], {"use_linear": True}, (0,))]
    return cases


def run_op(mx, op, arrays, kw, wrt, ctx):
    """The op's outputs and the gradients of sum(out * w) over its outputs,
    w a fixed seeded weight shaped like each output, with respect to the
    inputs at ``wrt``, on ``ctx``, as numpy arrays."""
    import numpy as np
    xs = [mx.nd.array(a, ctx=ctx) for a in arrays]
    for i in wrt:
        mx.nd.attach_grad(xs[i])
    if "ctx" in kw:
        kw = dict(kw, ctx=str(ctx))
    rs = np.random.RandomState(1)
    with mx.autograd.record():
        out = getattr(mx.nd, op)(*xs, **kw)
        outs = out if isinstance(out, list) else [out]
        loss = sum((o * mx.nd.array(rs.normal(size=o.shape).astype(
            np.float32), ctx=ctx)).sum()
                   for o in outs) if wrt else None
    if wrt:
        loss.backward()
    return ([mx.nd.asnumpy(o) for o in outs],
            [mx.nd.asnumpy(xs[i].grad) for i in wrt])


def phase_ops(mx):
    """Every deterministic op of the core surface on the card against the
    CPU: values, dtypes and gradients."""
    import numpy as np
    cases = core_op_cases(np)
    worst_out = worst_grad = 0.0
    for op, arrays, kw, wrt in cases:
        outs_g, grads_g = run_op(mx, op, arrays, kw, wrt, mx.gpu(0))
        outs_c, grads_c = run_op(mx, op, arrays, kw, wrt, mx.cpu())
        for g, c in zip(outs_g, outs_c):
            check(g.shape == c.shape and g.dtype == c.dtype,
                  f"{op}: card gives {g.shape} {g.dtype}, CPU {c.shape} "
                  f"{c.dtype}")
            if not np.issubdtype(c.dtype, np.floating):
                check(np.array_equal(g, c), f"{op}: card {g} != CPU {c}")
                continue
            err = np.abs(g.astype(np.float64) - c).max(initial=0.0)
            worst_out = max(worst_out, float(err / (TOL_OPS_ABS + TOL_OPS_REL
                                                    * np.abs(c).max())))
            check(np.allclose(g, c, rtol=TOL_OPS_REL, atol=TOL_OPS_ABS),
                  f"{op} {kw}: card against CPU off by {err:.3e}")
        for g, c in zip(grads_g, grads_c):
            rel = np.abs(g - c).max() / max(np.abs(c).max(), 1e-30)
            worst_grad = max(worst_grad, float(rel))
            check(rel <= TOL_OPS_REL, f"{op} {kw}: gradient on the card "
                  f"against the CPU off by {rel:.3e} of its largest")
    names = sorted({c[0] for c in cases})
    print(f"core ops: {len(names)} ops in {len(cases)} cases on the card "
          f"equal the CPU's: outputs within {worst_out:.3f} of the "
          f"{TOL_OPS_REL:g} / {TOL_OPS_ABS:g} bound at worst, gradients "
          f"within {worst_grad:.2e} of their largest (gate {TOL_OPS_REL:g})")
    return names


def _moment_check(name, x, mean, var):
    """x's mean and variance (on the card, float64) within RANDOM_SE
    standard errors of the distribution's."""
    import torch
    x = x.double().reshape(-1)
    m, v = x.mean(), x.var(unbiased=False)
    m4 = ((x - m) ** 4).mean()
    se_mean = (var / x.numel()) ** 0.5
    se_var = (max(float(m4 - v * v), 1e-30) / x.numel()) ** 0.5
    dm, dv = abs(float(m) - mean) / se_mean, abs(float(v) - var) / se_var
    check(dm < RANDOM_SE and dv < RANDOM_SE,
          f"{name}: mean {float(m):.5f} (want {mean:.5f}, {dm:.1f} SE), "
          f"variance {float(v):.5f} (want {var:.5f}, {dv:.1f} SE)")
    return max(dm, dv)


def phase_random(mx):
    """The random ops on the card: moments of 10^6 draws, repeatability
    under ``seed``, and the CUDA generator alone drawn from."""
    import torch
    import numpy as np
    dev = mx.gpu(0).torch_device()
    nd, r = mx.nd, mx.nd.random
    n = (RANDOM_DRAWS,)
    mx.random.seed(0)
    cpu_state = torch.get_rng_state()
    port_cpu_state = mx.random.generator("cpu").get_state()
    cuda_state = mx.random.generator(dev).get_state()
    t0 = time.perf_counter()
    rows = [("uniform", r.uniform(-1.0, 3.0, shape=n), 1.0, 16 / 12),
            ("normal", r.normal(1.0, 2.0, shape=n), 1.0, 4.0),
            ("gamma", r.gamma(2.0, 1.5, shape=n), 3.0, 4.5),
            ("exponential", r.exponential(2.0, shape=n), 0.5, 0.25),
            ("poisson", r.poisson(3.0, shape=n), 3.0, 3.0),
            ("negative_binomial", r.negative_binomial(3, 0.4, shape=n),
             4.5, 11.25),
            ("generalized_negative_binomial",
             r.generalized_negative_binomial(2.0, 0.5, shape=n), 2.0, 4.0),
            ("randint", r.randint(-3, 7, shape=n), 1.5, 8.25),
            ("multinomial", r.multinomial(mx.nd.array(
                [0.2, 0.3, 0.5], ctx=mx.gpu(0)), shape=n), 1.3, 0.61)]

    def pair(*vals):
        return mx.nd.array(np.asarray(vals, np.float32), ctx=mx.gpu(0))
    sampled = [
        ("_sample_uniform", (pair(-1.0, 2.0), pair(3.0, 3.5)),
         [(1.0, 16 / 12), (2.75, 2.25 / 12)]),
        ("_sample_normal", (pair(1.0, 0.0), pair(2.0, 0.5)),
         [(1.0, 4.0), (0.0, 0.25)]),
        ("_sample_gamma", (pair(2.0, 0.5), pair(1.5, 2.0)),
         [(3.0, 4.5), (1.0, 2.0)]),
        ("_sample_exponential", (pair(2.0, 0.5),), [(0.5, 0.25), (2.0, 4.0)]),
        ("_sample_poisson", (pair(3.0, 8.0),), [(3.0, 3.0), (8.0, 8.0)]),
        ("_sample_negative_binomial", (pair(3.0, 1.0), pair(0.4, 0.7)),
         [(4.5, 11.25), (3 / 7, 0.3 / 0.49)]),
        ("_sample_generalized_negative_binomial", (pair(2.0, 6.0),
                                                  pair(0.5, 0.2)),
         [(2.0, 4.0), (6.0, 13.2)])]
    for name, params, moments in sampled:
        draws = getattr(nd, name)(*params, shape=n)
        check(draws.shape == (2,) + n and draws.device == dev,
              f"{name}: {tuple(draws.shape)} on {draws.device}")
        rows += [(name, draws[i], *moments[i]) for i in range(2)]
    worst, worst_name = max((_moment_check(name, x, mean, var), name)
                            for name, x, mean, var in rows)
    for name, x, _, _ in rows:
        check(x.device == dev, f"{name} drawn on {x.device}")
    shuffled = r.shuffle(torch.arange(1000, dtype=torch.float32,
                                      device=dev).reshape(500, 2))
    check(torch.equal(torch.sort(shuffled[:, 0]).values,
                      torch.arange(0, 1000, 2, dtype=torch.float32,
                                   device=dev))
          and torch.equal(shuffled[:, 1] - shuffled[:, 0],
                          torch.ones(500, device=dev)),
          "shuffle is not a permutation of the rows")
    ints = rows[7][1]
    check(int(ints.min()) == -3 and int(ints.max()) == 6
          and ints.dtype == torch.int32, "randint out of [-3, 7) or not int32")
    torch.cuda.synchronize()
    t_draw = time.perf_counter() - t0
    check(torch.equal(torch.get_rng_state(), cpu_state) and torch.equal(
        mx.random.generator("cpu").get_state(), port_cpu_state),
        "a draw on the card moved a CPU generator")
    check(not torch.equal(mx.random.generator(dev).get_state(), cuda_state),
          "the draws on the card did not come from the CUDA generator")

    def draws():
        return [r.normal(shape=(4096,)), r.gamma(2.0, shape=(4096,)),
                r.poisson(3.0, shape=(4096,)), r.randint(0, 9, shape=(4096,)),
                r.multinomial(pair(0.5, 0.5), shape=(4096,)),
                r.shuffle(torch.arange(4096.0, device=dev)),
                nd._sample_normal(pair(0.0, 1.0), pair(1.0, 2.0),
                                  shape=(2048,))]
    mx.random.seed(7)
    first = draws()
    second = draws()
    mx.random.seed(7)
    again = draws()
    check(all(torch.equal(a, b) for a, b in zip(first, again)),
          "seed(7) twice gave different draws")
    check(all(not torch.equal(a, b) for a, b in zip(first, second)),
          "two consecutive draws were equal")
    print(f"random ops on the card: {len(rows)} distributions of "
          f"{RANDOM_DRAWS} draws in {t_draw:.2f} s (host clock, with the "
          f"checks), mean and variance within {worst:.2f} standard errors "
          f"at worst ({worst_name}; gate {RANDOM_SE:g}); shuffle a permutation, randint in "
          f"range; seed repeats bitwise, consecutive draws differ; the CPU "
          f"generators untouched, the CUDA generator moved")


def mha_reference(x, block, causal):
    """The block's function by the plain attention formula in x's dtype,
    from its weights: qkv projection, softmax(q k^T / sqrt(D), causal or
    not) v per head, output projection."""
    import torch
    N, T, E = x.shape
    H = MHA_HEADS
    D = E // H
    w = {k: p.data().to(x.dtype) for k, p in block.collect_params().items()}
    pre = block.prefix
    qkv = x @ w[pre + "qkv_weight"].t() + w[pre + "qkv_bias"]
    qkv = qkv.reshape(N, T, 3 * H, D).permute(0, 2, 1, 3)
    q, k, v = qkv[:, :H], qkv[:, H:2 * H], qkv[:, 2 * H:]
    s = q @ k.transpose(-1, -2) * D ** -0.5
    if causal:
        s = s.masked_fill(torch.ones(T, T, dtype=torch.bool,
                                     device=x.device).triu(1), float("-inf"))
    o = (torch.softmax(s, dim=-1) @ v).permute(0, 2, 1, 3).reshape(N, T, E)
    return o @ w[pre + "out_weight"].t() + w[pre + "out_bias"]


def phase_mha(mx):
    """MultiHeadAttention at the TransformerLM's width, hybridized,
    non-causal (its default) and causal: in bf16 (cast) against the plain
    formula in float32, and in float32, MXNet's default dtype (no cast),
    against the same formula in float64; one counted forward and backward
    each, then the times.  Returns the launches of the bf16 legs and of the
    float32 legs, and the times."""
    import torch
    from mxnet_tpu_torch.kernels import flash_attention as kfa
    T = CONFIG["max_len"]
    B, E, H = MHA_BATCH, MHA_UNITS, MHA_HEADS
    D = E // H
    dev = mx.gpu(0).torch_device()
    gen = torch.Generator(device=dev).manual_seed(0)
    x0 = torch.randn((B, T, E), generator=gen, device=dev)
    dout0 = torch.randn((B, T, E), generator=gen, device=dev)
    keys = ("sm90", "f32", "bwd.sm90", "bwd.f32")
    totals = {"bfloat16": dict.fromkeys(keys, 0),
              "float32": dict.fromkeys(keys, 0)}
    times = {}
    for dtype, causal in ((torch.bfloat16, False), (torch.bfloat16, True),
                          (torch.float32, False), (torch.float32, True)):
        name = str(dtype)[6:]
        variant = kfa._variant(dtype, D)
        other = "f32" if variant == "sm90" else "sm90"
        tol = TOL_MHA if dtype == torch.bfloat16 else TOL_MHA_F32
        ref_dtype = torch.float32 if dtype == torch.bfloat16 \
            else torch.float64
        mx.random.seed(0)
        block = mx.gluon.nn.MultiHeadAttention(E, H, causal=causal,
                                               prefix="mha_")
        block.initialize(ctx=mx.gpu(0))
        if dtype == torch.bfloat16:
            block.cast("bfloat16")
        block.hybridize()
        x = mx.nd.attach_grad(x0.to(dtype).clone())
        dout = dout0.to(dtype)

        def fwd_bwd():
            with mx.autograd.record():
                out = block(x)
            out.backward(dout)
            return out
        fwd_bwd()                              # traces; not counted
        torch.cuda.synchronize()
        reset_counts()
        out = fwd_bwd()
        torch.cuda.synchronize()
        c = read_counts()
        tag = ("causal" if causal else "non-causal") + f" {name}"
        check(c[f"flash_attention.{variant}"] == 1
              and c[f"flash_attention.{other}"] == 0
              and c[f"flash_attention.bwd.{variant}"] == 1
              and c[f"flash_attention.bwd.{other}"] == 0,
              f"MultiHeadAttention {tag}: launches {c}; want 1 {variant} K1 "
              f"and 1 {variant} K1b, none on {other}")
        for k in keys:
            totals[name][k] += c["flash_attention." + k]
        xr = x0.to(dtype).to(ref_dtype).detach().requires_grad_()
        ref = mha_reference(xr, block, causal)
        ref.backward(dout.to(ref_dtype))
        ref = ref.detach()
        err = float((out.detach().to(ref_dtype) - ref).abs().max()
                    / ref.abs().max())
        gerr = float((x.grad.to(ref_dtype) - xr.grad).abs().max()
                     / xr.grad.abs().max())
        check(out.dtype == dtype and out.shape == (B, T, E)
              and err <= tol and gerr <= tol,
              f"MultiHeadAttention {tag}: output off by {err:.3e}, input "
              f"gradient by {gerr:.3e} of the largest (gate {tol})")
        del ref, xr
        # the parts: K1 and K1b alone on contiguous inputs of the same
        # shape, SDPA's forward and backward on them (the yardstick), and
        # the copies of the three strided views
        qkv = torch.randn((B, T, 3 * H, D), generator=gen, device=dev).to(
            dtype).permute(0, 2, 1, 3)
        views = (qkv[:, :H], qkv[:, H:2 * H], qkv[:, 2 * H:])
        q, k, v = (t.contiguous() for t in views)
        scale = D ** -0.5
        o, lse = kfa.flash_attention_fwd(q, k, v, scale, causal,
                                         return_lse=True)
        do = dout.reshape(B, T, H, D).permute(0, 2, 1, 3).contiguous()
        qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
        sdpa_out = torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, is_causal=causal, scale=scale)
        times[tag] = {
            "block_ms": device_ms(fwd_bwd, iters=10),
            "block_host_ms": host_clock_ms(fwd_bwd),
            "k1_ms": device_ms(lambda: kfa.flash_attention_fwd(
                q, k, v, scale, causal, return_lse=True)),
            "k1b_ms": device_ms(lambda: kfa.flash_attention_bwd(
                q, k, v, o, do, scale, causal, lse)),
            "sdpa_ms": device_ms(lambda: torch.nn.functional.
                                 scaled_dot_product_attention(
                                     q, k, v, is_causal=causal,
                                     scale=scale)),
            "sdpa_bwd_ms": device_ms(lambda: torch.autograd.grad(
                sdpa_out, (qs, ks, vs), do, retain_graph=True)),
            "copy_ms": device_ms(lambda: [t.contiguous() for t in views]),
            "err": err, "grad_err": gerr}
        # the bounds by the kernels table's rule: bf16 at 989 TFLOP/s,
        # float32 at 3xTF32's 165; 4 D and 4 tensors forward, 10 D and 8
        # tensors backward
        rate = H100_BF16_FLOPS if dtype == torch.bfloat16 \
            else H100_3XTF32_FLOPS
        times[tag]["k1_bound"] = attention_bound_ms(
            B, H, T, D, causal, q.element_size(), rate)
        times[tag]["k1b_bound"] = attention_bound_ms(
            B, H, T, D, causal, q.element_size(), rate, ops_per_pair=10,
            tensors=8)
        t = times[tag]
        print(f"MultiHeadAttention {tag}, B={B} T={T} units {E} ({H} heads "
              f"of {D}): 1 {variant} K1 + 1 {variant} K1b per forward and "
              f"backward; output within {err:.2e}, input gradient "
              f"{gerr:.2e} of the largest against the formula in "
              f"{str(ref_dtype)[6:]}; forward+backward {t['block_ms']:.3f} "
              f"ms device, {t['block_host_ms']:.3f} ms host clock; K1 "
              f"{t['k1_ms']:.4f} ms, K1b {t['k1b_ms']:.4f} ms alone (SDPA "
              f"{t['sdpa_ms']:.4f} and {t['sdpa_bwd_ms']:.4f}; bounds "
              f"{t['k1_bound'][0]:.4f} ({t['k1_bound'][1]}) and "
              f"{t['k1b_bound'][0]:.4f} ({t['k1b_bound'][1]})); the q/k/v "
              f"contiguous copies {t['copy_ms']:.4f} ms")
        del block, x, out, qkv, views, q, k, v, o, lse, do, qs, ks, vs, \
            sdpa_out
    return totals["bfloat16"], totals["float32"], times


def dcgan_nets(mx, ngf, ndf, nc=3):
    """``example/gluon/dcgan.py:26-58``'s 32x32 generator and
    discriminator, built through the port."""
    nn = mx.gluon.nn
    g = nn.HybridSequential(prefix="gen_")
    with g.name_scope():
        for ch, stride, pad in ((ngf * 4, 1, 0), (ngf * 2, 2, 1),
                                (ngf, 2, 1)):
            g.add(nn.Conv2DTranspose(ch, 4, stride, pad, use_bias=False))
            g.add(nn.BatchNorm())
            g.add(nn.Activation("relu"))
        g.add(nn.Conv2DTranspose(nc, 4, 2, 1, use_bias=False))
        g.add(nn.Activation("tanh"))
    d = nn.HybridSequential(prefix="disc_")
    with d.name_scope():
        d.add(nn.Conv2D(ndf, 4, 2, 1, use_bias=False))
        d.add(nn.LeakyReLU(0.2))
        for ch in (ndf * 2, ndf * 4):
            d.add(nn.Conv2D(ch, 4, 2, 1, use_bias=False))
            d.add(nn.BatchNorm())
            d.add(nn.LeakyReLU(0.2))
        d.add(nn.Conv2D(1, 4, 1, 0, use_bias=False))
    return g, d


def phase_dcgan(mx):
    """The JAX package's DCGAN example at upstream MXNet's published widths
    (nz 100, ngf = ndf = 64, batch 64, Normal(0.02), Adam lr 2e-4 beta1
    0.5): ``dcgan.py:94-118``'s alternating D and G updates for 20 steps
    on a resident synthetic set, z drawn on the card each step, and
    ``loss.backward()`` on the (64,) loss vectors."""
    import torch
    cfg = DCGAN
    bs = cfg["batch"]
    dev = mx.gpu(0).torch_device()
    nd, autograd, gluon = mx.nd, mx.autograd, mx.gluon
    mx.random.seed(0)
    netG, netD = dcgan_nets(mx, cfg["ngf"], cfg["ndf"])
    for net in (netG, netD):
        net.initialize(mx.init.Normal(cfg["sigma"]), ctx=mx.gpu(0))
    trainerG = gluon.Trainer(netG.collect_params(), "adam",
                             {"learning_rate": cfg["lr"],
                              "beta1": cfg["beta1"]})
    trainerD = gluon.Trainer(netD.collect_params(), "adam",
                             {"learning_rate": cfg["lr"],
                              "beta1": cfg["beta1"]})
    loss_fn = gluon.loss.SigmoidBinaryCrossEntropyLoss()
    # dcgan.py's real images, tanh of normal noise, drawn on the card
    real = torch.tanh(torch.randn(
        (cfg["resident_batches"] * bs, 3, 32, 32),
        generator=mx.random.generator(dev), device=dev))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, lossD, lossG = [], [], []
    lo = hi = 0.0
    for step in range(cfg["steps"]):
        i = step % cfg["resident_batches"]
        data = real[i * bs:(i + 1) * bs]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_label = nd.ones((bs,))
        fake_label = nd.zeros((bs,))
        z = nd.random.normal(shape=(bs, cfg["nz"], 1, 1))
        fake = netG(z)
        with autograd.record():
            out_real = netD(data).reshape((-1,))
            errD_real = loss_fn(out_real, real_label)
            out_fake = netD(fake.detach()).reshape((-1,))
            errD_fake = loss_fn(out_fake, fake_label)
            errD = errD_real + errD_fake
        errD.backward()
        trainerD.step(bs)
        with autograd.record():
            out = netD(netG(z)).reshape((-1,))
            errG = loss_fn(out, real_label)
        errG.backward()
        trainerG.step(bs)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        check(z.device == dev and errD.shape == (bs,) and errG.shape == (bs,),
              f"DCGAN step {step}: z on {z.device}, losses {errD.shape} "
              f"{errG.shape}")
        lossD.append(errD.mean())
        lossG.append(errG.mean())
        lo, hi = min(lo, float(fake.min())), max(hi, float(fake.max()))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    lossD = torch.stack(lossD).tolist()
    lossG = torch.stack(lossG).tolist()
    check(all(map(math.isfinite, lossD + lossG)),
          f"DCGAN losses not finite: D {lossD}, G {lossG}")
    check(-1.0 <= lo and hi <= 1.0, f"G's output outside [-1, 1]: "
          f"[{lo}, {hi}]")
    n_g = sum(p.data().numel() for p in netG.collect_params().values())
    n_d = sum(p.data().numel() for p in netD.collect_params().values())
    step_ms = statistics.median(walls[1:])
    print(f"DCGAN, nz {cfg['nz']}, ngf = ndf = {cfg['ngf']}, batch {bs}, "
          f"32x32 ({n_g} + {n_d} parameters), Adam lr {cfg['lr']} beta1 "
          f"{cfg['beta1']}: {cfg['steps']} steps, first {walls[0]:.1f} ms, "
          f"then {step_ms:.2f} ms median (host clock, synchronized; D and G "
          f"updates, {bs * 1e3 / step_ms:.0f} images/s); peak "
          f"{peak:.3f} GiB; loss D {lossD[0]:.4f} -> {lossD[-1]:.4f}, G "
          f"{lossG[0]:.4f} -> {lossG[-1]:.4f}; G's output in [{lo:.4f}, "
          f"{hi:.4f}]")
    return {"step_ms": step_ms, "first_ms": walls[0], "peak_gib": peak}


# ---------------------------------------------------------------------------
# phase 13: training state
# ---------------------------------------------------------------------------
# one layer of the LM, the shapes every optimizer steps on the card
LAYER_SHAPES = {"ln1_gamma": (1024,), "ln1_beta": (1024,),
                "attn_qkv_weight": (3072, 1024), "attn_qkv_bias": (3072,),
                "attn_proj_weight": (1024, 1024), "attn_proj_bias": (1024,),
                "ln2_gamma": (1024,), "ln2_beta": (1024,),
                "ffn1_weight": (4096, 1024), "ffn1_bias": (4096,),
                "ffn2_weight": (1024, 4096), "ffn2_bias": (1024,)}
OPT_CASES = (("sgd", {"momentum": 0.9}), ("ccsgd", {"momentum": 0.9}),
             ("nag", {"momentum": 0.9}), ("adam", {}), ("rmsprop", {}),
             ("rmsprop", {"centered": True}), ("adagrad", {}),
             ("adadelta", {}), ("ftrl", {}), ("adamax", {}), ("nadam", {}),
             ("sgld", {}), ("dcasgd", {"momentum": 0.9}), ("test", {}))
FUSED_OPTS = ("sgd", "ccsgd", "nag", "adam", "rmsprop", "adagrad",
              "adadelta", "ftrl", "adamax")
OPT_STEPS = 5
# every parameter and state after OPT_STEPS, card against CPU (float32, the
# same foreach ops; FMA contraction and reduction order differ): max |diff|
# over the CPU value's largest magnitude
TOL_OPT_CARD = 1e-5
RESUME_SAVE_AT = 3      # steps before the checkpoint, then RESUME_STEPS more
RESUME_STEPS = 2
RESUME_LR = 1e-4        # Adam with float32 masters, bf16 weights
RELOAD_SHAPE = (1, 64)  # the served request of the hot-reload check
TOL_RELOAD = 3e-2       # served against eager bf16 logits, of the largest
MODULE_CKPT_EPOCHS = 2  # resnet18_v1 f32 fit, stopped after epoch 1
MODULE_CKPT_BATCHES = 2
MODULE_CKPT_LR = 0.01
# the steps' ranges with the per-key updater, before FusedUpdater became
# the default (NVIDIA H100 80GB HBM3, 700 W; PERF.md §5): printed beside
# phases 9 and 11's steps
PER_KEY_STEP_MS = {"phase 9 LM": (57.0, 103.5),
                   "phase 11 ResNet-50 Module": (154.3, 159.2)}
UPDATE_CALLS = {"update_all": 0, "per_key": 0}
LM_STATE_LAUNCHES = {}  # kernel launches of phase 13's LM training steps


def count_updates(mx):
    """Count ``FusedUpdater.update_all`` and per-key ``Updater.__call__``
    calls in ``UPDATE_CALLS`` (the per-key calls that ``update_all`` makes
    for a non-fused optimizer count too)."""
    cls_all, cls_key = mx.optimizer.FusedUpdater, mx.optimizer.Updater
    real_all, real_key = cls_all.update_all, cls_key.__call__

    def update_all(self, *a, **k):
        UPDATE_CALLS["update_all"] += 1
        return real_all(self, *a, **k)

    def per_key(self, *a, **k):
        UPDATE_CALLS["per_key"] += 1
        return real_key(self, *a, **k)

    cls_all.update_all, cls_key.__call__ = update_all, per_key


def optimizer_launches(updater, keys, grads, weights):
    """The kernels of one ``update_all`` over ``keys`` and of the per-key
    loop over the same parameters, by torch.profiler: (launches, ms) each,
    or None where it saw no device time.  Both step the weights."""
    def fused():
        updater.update_all(keys, grads, weights)

    def per_key():
        for k, g, w in zip(keys, grads, weights):
            updater(k, g, w)

    out = []
    for fn in (fused, per_key):
        fn()                                  # states exist, warm
        rows = kernel_rows(fn)
        out.append((sum(r[1] for r in rows), sum(r[0] for r in rows))
                   if rows else None)
    return out


def print_optimizer_launches(what, got):
    (fused, per_key) = got
    if fused is None or per_key is None:
        print(f"  {what}: optimizer kernels not measured (torch.profiler saw "
              "no device time)")
        return
    print(f"  {what}: one update_all {fused[0]} kernel launches, "
          f"{fused[1]:.3f} ms of kernel time; the per-key loop over the "
          f"same parameters {per_key[0]} launches, {per_key[1]:.3f} ms")


def layer_data(np, seed=0):
    rs = np.random.RandomState(seed)
    w0 = [(0.02 * rs.randn(*s)).astype(np.float32)
          for s in LAYER_SHAPES.values()]
    grads = [[rs.randn(*s).astype(np.float32)
              for s in LAYER_SHAPES.values()] for _ in range(OPT_STEPS)]
    return w0, grads


def run_optimizer(mx, name, kw, ctx, data, dtype="float32", fused=True,
                  **extra):
    w0, grads = data
    opt = mx.optimizer.create(name, learning_rate=0.01, wd=1e-4,
                              rescale_grad=1.0 / TRAIN_BATCH, **kw, **extra)
    upd = mx.optimizer.get_updater(opt) if fused \
        else mx.optimizer.Updater(opt)
    ws = [mx.nd.array(w, ctx=ctx, dtype=dtype) for w in w0]
    keys = list(range(len(ws)))
    for step in grads:
        gs = [mx.nd.array(g, ctx=ctx, dtype=dtype) for g in step]
        if fused:
            upd.update_all(keys, gs, ws)
        else:
            for k, g, w in zip(keys, gs, ws):
                upd(k, g, w)
    return ws, upd


def state_leaves(state):
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [a for s in state for a in state_leaves(s)]
    return [state]


def phase_optimizers(mx):
    """Every optimizer on one LM layer's shapes: OPT_STEPS float32 steps
    through ``update_all`` on the card against the same on the CPU; SGLD's
    draws repeated under one seed and taken from the card's generator;
    the FusedUpdater against the per-key Updater on the card, bitwise, in
    float32 and in bf16 with float32 masters."""
    import numpy as np
    import torch
    data = layer_data(np)
    gpu, cpu = mx.gpu(0), mx.cpu()
    for name, kw in OPT_CASES:
        if name == "sgld":
            continue
        t0 = time.perf_counter()
        cw, cu = run_optimizer(mx, name, kw, cpu, data)
        gw, gu = run_optimizer(mx, name, kw, gpu, data)
        torch.cuda.synchronize()
        errs, devices = [], set()
        for k in range(len(cw)):
            for a, b in zip([gw[k]] + state_leaves(gu.states[k]),
                            [cw[k]] + state_leaves(cu.states[k])):
                devices.add(a.device.type)
                scale = b.abs().max().item()
                errs.append((a.cpu() - b).abs().max().item() /
                            (scale if scale else 1.0))
        check(devices == {"cuda"}, f"{name}: weights and states on "
              f"{devices}, not all on the card")
        err = max(errs)
        print(f"  {name} {kw or ''}: {OPT_STEPS} steps on the card against "
              f"the CPU, {len(errs)} tensors, max |diff| over each one's "
              f"largest {err:.3e} ({time.perf_counter() - t0:.1f} s)")
        check(err <= TOL_OPT_CARD, f"{name} {kw}: card against CPU {err:.3e}"
              f" (limit {TOL_OPT_CARD})")
    # SGLD: random, so repeated under a seed and drawn on the card
    dev, host = gpu.torch_device(), torch.device("cpu")
    runs = []
    for _ in range(2):
        mx.random.seed(11)
        before = {d: mx.random.generator(d).get_state() for d in (dev, host)}
        ws, _ = run_optimizer(mx, "sgld", {}, gpu, data)
        runs.append(ws)
        check(not torch.equal(before[dev],
                              mx.random.generator(dev).get_state()),
              "SGLD drew nothing from the card's generator")
        check(torch.equal(before[host],
                          mx.random.generator(host).get_state()),
              "SGLD drew from the CPU generator")
    check(all(torch.equal(a, b) for a, b in zip(*runs)),
          "SGLD does not repeat under one seed")
    print("  sgld: bitwise equal under one seed, drawn from the CUDA "
          "generator (the CPU generator untouched)")
    # fused against per-key, bitwise
    for dtype in ("float32", "bfloat16"):
        mp = {"multi_precision": True} if dtype == "bfloat16" else {}
        for name, kw in OPT_CASES:
            if name not in FUSED_OPTS:
                continue
            fw, fu = run_optimizer(mx, name, kw, gpu, data, dtype, True,
                                   **mp)
            kw_, ku = run_optimizer(mx, name, kw, gpu, data, dtype, False,
                                    **mp)
            same = all(torch.equal(a, b) for a, b in zip(fw, kw_)) and all(
                torch.equal(x, y) for k in fu.states for x, y in zip(
                    state_leaves(fu.states[k]), state_leaves(ku.states[k])))
            check(same, f"{name} {kw} {dtype}: FusedUpdater and the per-key "
                  "Updater differ on the card")
        print(f"  FusedUpdater against the per-key Updater on the card, "
              f"{dtype}{' with float32 masters' if mp else ''}: bitwise "
              f"equal in all {sum(n in FUSED_OPTS for n, _ in OPT_CASES)} "
              "cases of the fused optimizers")


def lm_train_setup(mx, seed=0):
    """Phase 9's net and TrainStep under the name prefix ``lm_`` (every
    net of this phase has the same parameter names), bf16 with float32
    masters, ``Trainer("adam")``."""
    import numpy as np
    from mxnet_tpu_torch.gluon.model_zoo.transformer import TransformerLM
    mx.random.seed(seed)
    net = TransformerLM(**CONFIG, attn_type="flash", prefix="lm_")
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    net(mx.nd.array(np.zeros((1, 8), np.float32), ctx=mx.gpu(0)))
    step = train_step_block(mx, net)
    step.cast("bfloat16")
    trainer = mx.gluon.Trainer(step.collect_params(), "adam",
                               {"learning_rate": RESUME_LR,
                                "multi_precision": True})
    return net, step, trainer


def lm_batches(mx):
    import numpy as np
    rs = np.random.RandomState(1)
    out = []
    for _ in range(RESUME_SAVE_AT + RESUME_STEPS):
        toks = rs.randint(0, CONFIG["vocab"], (TRAIN_BATCH,
                                               CONFIG["max_len"] + 1))
        out.append((mx.nd.array(toks[:, :-1].astype(np.float32),
                                ctx=mx.gpu(0)),
                    mx.nd.array(toks[:, 1:].astype(np.float32),
                                ctx=mx.gpu(0))))
    return out


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic algorithms, for phase 13's resume
    comparisons only: the embedding's backward then sums without atomics,
    and cuDNN takes deterministic weight-gradient algorithms (with its
    default ones two identical fits differ from their first batch's
    gradients on: ``experiments/resume_determinism.py``)."""
    import torch
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def lm_steps(mx, step, trainer, batches, rec):
    """One training step per batch, under deterministic algorithms:
    losses, host times, launches and update calls per step into
    ``rec``."""
    import torch
    L = CONFIG["num_layers"]
    for x, y in batches:
        before, calls = read_counts(), dict(UPDATE_CALLS)
        t0 = time.perf_counter()
        with deterministic():
            with mx.autograd.record():
                loss = step(x, y)
            loss.backward()
            trainer.step(TRAIN_BATCH)
            torch.cuda.synchronize()
        rec["walls"].append((time.perf_counter() - t0) * 1e3)
        rec["losses"].append(loss.item())
        after = read_counts()
        c = {k: after[k] - before[k] for k in after}
        for k, v in c.items():
            LM_STATE_LAUNCHES[k] = LM_STATE_LAUNCHES.get(k, 0) + v
        u = {k: UPDATE_CALLS[k] - calls[k] for k in calls}
        check(c["flash_attention.sm90"] == L and c["flash_attention.f32"] == 0
              and c["flash_attention.bwd.sm90"] == L
              and c["flash_attention.bwd.f32"] == 0,
              f"phase 13 LM step: launches {c}; want {L} sm90 K1 and {L} "
              "sm90 K1b, none on f32")
        check(u == {"update_all": 1, "per_key": 0}, f"phase 13 LM step: "
              f"updater calls {u}; want one update_all and no per-key call")


def lm_params(trainer):
    return [p.data().detach().clone() for p in trainer._params]


def dir_gib(path):
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(path) for f in fs) / 2 ** 30


def phase_resume(mx, root):
    """The full-width LM through ``Trainer("adam")``: run A takes
    RESUME_SAVE_AT steps, is checkpointed (sync, then async into
    ``root``) and takes RESUME_STEPS more while the async write runs; run
    B takes the same steps uninterrupted; run C, a fresh net and trainer, restores from
    ``root`` and takes the last RESUME_STEPS.  B and C equal A bitwise.
    Then a bf16 BucketedPredictor over the LM's symbol hot-reloads
    ``root``."""
    import gc
    import shutil
    import numpy as np
    import torch
    from mxnet_tpu_torch import checkpoint as ckpt
    from mxnet_tpu_torch.observability import metrics as M
    from mxnet_tpu_torch.serving import BucketedPredictor
    gc.collect()
    torch.cuda.empty_cache()
    batches = lm_batches(mx)
    recs = {k: {"walls": [], "losses": []} for k in "ABC"}
    # run A: the checkpointed run
    net, step, trainer = lm_train_setup(mx)
    lm_steps(mx, step, trainer, batches[:RESUME_SAVE_AT], recs["A"])
    params = {p.name: p for p in trainer._params}
    sync_dir = os.path.join(root, "sync")
    t0 = time.perf_counter()
    ckpt.save_trainer(ckpt.CheckpointManager(sync_dir, async_save=False),
                      RESUME_SAVE_AT, params, trainer)
    sync_save = time.perf_counter() - t0
    gib = dir_gib(sync_dir)
    shutil.rmtree(sync_dir)
    mgr = ckpt.CheckpointManager(os.path.join(root, "async"))
    t0 = time.perf_counter()
    ckpt.save_trainer(mgr, RESUME_SAVE_AT, params, trainer)
    async_block = time.perf_counter() - t0
    lm_steps(mx, step, trainer, batches[RESUME_SAVE_AT:], recs["A"])
    mgr.wait()
    async_total = time.perf_counter() - t0
    mgr.close()
    want = lm_params(trainer)
    del net, step, trainer, params
    gc.collect()
    torch.cuda.empty_cache()
    # run B: uninterrupted, as A is
    net, step, trainer = lm_train_setup(mx)
    lm_steps(mx, step, trainer, batches, recs["B"])
    serve_init = {p.name: p.data().detach().clone() for p in trainer._params
                  if not p.name.startswith("trainstep")}
    again = lm_params(trainer)
    del net, step, trainer
    gc.collect()
    torch.cuda.empty_cache()
    # run C: a fresh net and trainer resume from the checkpoint
    net, step, trainer = lm_train_setup(mx, seed=5)
    t0 = time.perf_counter()
    got_step = ckpt.restore_or_initialize(
        ckpt.CheckpointManager(os.path.join(root, "async")),
        {p.name: p for p in trainer._params}, trainer)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check(got_step == RESUME_SAVE_AT, f"restored step {got_step}, want "
          f"{RESUME_SAVE_AT}")
    counts_t = trainer._optimizer._index_update_count
    check(set(counts_t.values()) == {RESUME_SAVE_AT},
          f"restored update counts {set(counts_t.values())}")
    # the served hot reload, against the restored net's eager logits
    ids = np.random.RandomState(2).randint(
        0, CONFIG["vocab"], RELOAD_SHAPE).astype(np.float32)
    eager = net(mx.nd.array(ids, ctx=mx.gpu(0))).float()
    pred = BucketedPredictor(net(mx.sym.var("data")), serve_init,
                             {"data": RELOAD_SHAPE}, batch_buckets=[1],
                             dev=mx.gpu(0)).warmup()
    compiles = M.SERVE_COMPILES.value

    def served():
        return torch.from_numpy(np.asarray(pred.predict(data=ids)[0],
                                           dtype=np.float32))

    before_reload = served()
    t0 = time.perf_counter()
    loaded = pred.hot_reload(os.path.join(root, "async"))
    reload_s = time.perf_counter() - t0
    after_reload = served()
    scale = eager.abs().max().item()
    reload_err = (after_reload - eager.cpu()).abs().max().item() / scale
    moved = (before_reload - eager.cpu()).abs().max().item() / scale
    print(f"  hot reload: loaded_step {loaded} in {reload_s:.2f} s; served "
          f"bf16 logits {RELOAD_SHAPE} against the restored net's eager "
          f"logits: max |diff| over the largest {reload_err:.3e} (limit "
          f"{TOL_RELOAD}; {moved:.3e} before the reload); SERVE_COMPILES "
          f"{compiles:.0f} -> {M.SERVE_COMPILES.value:.0f}")
    check(loaded == RESUME_SAVE_AT and pred.loaded_step == RESUME_SAVE_AT,
          f"hot_reload loaded step {loaded}")
    check(M.SERVE_COMPILES.value == compiles, "the hot reload built buckets")
    check(reload_err <= TOL_RELOAD, f"served logits after the reload differ "
          f"by {reload_err:.3e}")
    pred.close()
    del pred, eager
    lm_steps(mx, step, trainer, batches[RESUME_SAVE_AT:], recs["C"])
    got = lm_params(trainer)
    del net, step, trainer
    gc.collect()
    torch.cuda.empty_cache()

    def differ(xs, ys):
        """How many tensors are not bitwise equal, and the largest |diff|
        over its tensor's largest."""
        return (sum(not torch.equal(a, b) for a, b in zip(xs, ys)),
                max(((a.float() - b.float()).abs().max()
                     / b.float().abs().max().clamp_min(1e-30)).item()
                    for a, b in zip(xs, ys)))

    a_losses = recs["A"]["losses"]
    b_n, b_rel = differ(again, want)
    c_n, c_rel = differ(got, want)
    print(f"  LM resume, bf16 with float32 masters, Adam lr {RESUME_LR}, "
          f"B={TRAIN_BATCH} T={CONFIG['max_len']}, deterministic "
          f"algorithms: losses A {a_losses}, B {recs['B']['losses']}, C "
          f"(resumed) {recs['C']['losses']}")
    print(f"  against A, of {len(want)} tensors: B (uninterrupted) {b_n} "
          f"differ, max |diff| over the largest {b_rel:.3e}; C (resumed) "
          f"{c_n} differ, {c_rel:.3e}")
    check(b_n == 0 and recs["B"]["losses"] == a_losses, "two uninterrupted "
          "LM runs differ under deterministic algorithms")
    check(c_n == 0 and recs["C"]["losses"] == a_losses[RESUME_SAVE_AT:],
          "the resumed LM run differs from the uninterrupted one")
    step_b = statistics.median(recs["B"]["walls"][1:])
    overlapped = recs["A"]["walls"][RESUME_SAVE_AT:]
    print(f"  checkpoint: {gib:.3f} GiB ({len(want)} parameters, float32 "
          f"masters and Adam moments); sync_save_s {sync_save:.3f}, "
          f"async_block_s {async_block:.3f}, async_total_s {async_total:.3f}"
          f" (save to committed, {RESUME_STEPS} steps overlapped), "
          f"block_ratio {async_block / sync_save:.4f}, restore_s "
          f"{restore_s:.3f}")
    print(f"  steps overlapping the async write {[round(w, 1) for w in overlapped]}"
          f" ms against the uninterrupted run's median {step_b:.1f} ms")
    return dict(LM_STATE_LAUNCHES)


def phase_module_checkpoint(mx, root):
    """resnet18_v1 in float32 (B=2, 64x64) through
    ``Module.fit(checkpoint_dir=...)``, with no store and on the
    ``tpu_sync`` store (the optimizer on its ``pushpull``, ``bench.py``'s):
    stopped after epoch 1 and resumed by a fresh Module, against an
    uninterrupted fit, under deterministic algorithms; then
    ``save_optimizer_states``/``load_optimizer_states`` round-tripped."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import checkpoint as ckpt
    rs = np.random.RandomState(4)
    n = GRAD_VISION_SHAPE[0] * MODULE_CKPT_BATCHES
    xs = rs.normal(size=(n,) + GRAD_VISION_SHAPE[1:]).astype(np.float32)
    ys = rs.randint(0, 1000, n).astype(np.float32)
    sym = resnet_symbol(mx, "resnet18_v1")

    def fit(epochs, kvstore, ckpt_dir=None):
        mx.random.seed(0)
        mod = mx.mod.Module(sym, context=mx.gpu(0))
        it = mx.io.NDArrayIter(mx.nd.array(xs, ctx=mx.gpu(0)),
                               mx.nd.array(ys, ctx=mx.gpu(0)),
                               batch_size=GRAD_VISION_SHAPE[0])
        calls = dict(UPDATE_CALLS)
        with deterministic():
            mod.fit(it, num_epoch=epochs, kvstore=kvstore,
                    checkpoint_dir=ckpt_dir, optimizer="sgd",
                    optimizer_params={"learning_rate": MODULE_CKPT_LR,
                                      "momentum": 0.9, "wd": 1e-4},
                    initializer=mx.init.Xavier(rnd_type="gaussian",
                                               factor_type="in",
                                               magnitude=2))
        return mod, {k: UPDATE_CALLS[k] - calls[k] for k in calls}

    start = fit(0, "local")[0].get_params()[0]   # the weights fit starts from
    for kvstore in ("local", "tpu_sync"):
        want, calls = fit(MODULE_CKPT_EPOCHS, kvstore)
        check(bool(want._update_on_kvstore) == (kvstore == "tpu_sync"),
              f"Module.fit({kvstore}): update_on_kvstore "
              f"{want._update_on_kvstore}")
        check(calls == {"update_all": MODULE_CKPT_EPOCHS * MODULE_CKPT_BATCHES,
                        "per_key": 0},
              f"Module.fit({kvstore}) updater calls {calls}")
        d = os.path.join(root, f"module-{kvstore}")
        fit(1, kvstore, d)
        got, _ = fit(MODULE_CKPT_EPOCHS, kvstore, d)
        check(ckpt.all_steps(d) == [1, MODULE_CKPT_EPOCHS],
              f"Module checkpoints {ckpt.all_steps(d)}")
        w_arg, w_aux = want.get_params()
        arg, aux = got.get_params()
        param_err = max(((arg[k] - w_arg[k]).abs().max()
                         / (w_arg[k] - start[k]).abs().max().clamp_min(1e-30)
                         ).item() for k in w_arg)
        aux_err = max((aux[k] - w_aux[k]).abs().max().item() for k in w_aux)
        bitwise = all(torch.equal(arg[k], w_arg[k]) for k in w_arg) and all(
            torch.equal(aux[k], w_aux[k]) for k in w_aux)
        print(f"  resnet18_v1 f32 B={GRAD_VISION_SHAPE[0]}, "
              f"{MODULE_CKPT_BATCHES} batches an epoch, kvstore {kvstore!r}"
              f" (update on the store: {want._update_on_kvstore}), "
              f"Module.fit(checkpoint_dir) stopped after epoch 1 and "
              f"resumed, against an uninterrupted {MODULE_CKPT_EPOCHS}-epoch"
              f" fit: parameters max |diff| over each one's largest change "
              f"{param_err:.3e}, moving statistics {aux_err:.3e} (limits "
              f"{TOL_MODULE_GLUON}, {TOL_MODULE_AUX}); bitwise equal: "
              f"{bitwise}")
        check(param_err <= TOL_MODULE_GLUON, f"resumed Module ({kvstore}) "
              f"parameters differ by {param_err:.3e}")
        check(aux_err <= TOL_MODULE_AUX, f"resumed Module ({kvstore}) "
              f"moving statistics differ by {aux_err:.3e}")
    fname = os.path.join(root, "resnet18.states")
    updater = got._state_updater()
    states = {k: [t.clone() for t in state_leaves(s)]
              for k, s in updater.states.items()}
    got.save_optimizer_states(fname)
    got.load_optimizer_states(fname)
    updater = got._state_updater()
    round_trip = all(torch.equal(a.cpu(), b.cpu()) for k, s in
                     updater.states.items()
                     for a, b in zip(state_leaves(s), states[k]))
    print(f"  save/load_optimizer_states ({kvstore}) bitwise: {round_trip}")
    check(round_trip, "Module optimizer states did not round-trip bitwise")


# ---------------------------------------------------------------------------
# phase 14: the record-file input path
# ---------------------------------------------------------------------------
REC_IMAGES = 2048      # 8 batches of B=256: bench.py's epoch
REC_SRC = 256          # stored images 256x256x3 uint8, cropped to 224
# ImageNet's mean and std per channel, as upstream's train_imagenet.py
REC_NORM = dict(mean_r=123.68, mean_g=116.28, mean_b=103.53, std_r=58.395,
                std_g=57.12, std_b=57.375)
REC_CHECK_BATCHES = 2  # device_augment float32 against the host path
TOL_REC_F32 = 1e-4     # normalised float32 batches, absolute
MIRROR_STEPS = 5       # ResNet-50 mirrored and not: 1 warm-up + 4 timed
TOL_MIRROR = 1e-5      # of each one's largest, where not bitwise
# each timed step's NLL, mirrored against unmirrored, relative: those steps
# run cuDNN's default algorithms, and two identical fits then differ from
# their first batch's gradients on; a recomputation that is wrong (a
# segment fed the wrong inputs, statistics updated twice) moves it further
TOL_MIRROR_LOSS = 1e-3
MIRROR_DET_STEPS = 2   # ResNet-50 steps under deterministic algorithms,
                       # whose parameters and statistics are compared
EXPORT_PROMPT = 16


def rec_iter(mx, path, **kw):
    """Phase 14's ``ImageRecordIter``: ``data_shape`` (3, 224, 224), B=256,
    shuffled, random crop, ImageNet's mean and std, 4 batches read ahead,
    on gpu(0); ``kw`` overrides."""
    args = dict(data_shape=(3, VISION_IMG, VISION_IMG),
                batch_size=VISION_BATCH, shuffle=True, rand_crop=True,
                rand_mirror=True, device_augment=True,
                device_dtype="bfloat16",
                preprocess_threads=min(16, os.cpu_count() or 1),
                prefetch_buffer=4, ctx=mx.gpu(0), **REC_NORM)
    args.update(kw)
    return mx.io.ImageRecordIter(path, **args)


def write_image_rec(mx, root):
    """2,048 synthetic ImageNet-shaped images (uint8 256x256x3, ``.npy``
    payloads, labels 0-999, seed 0) into ``root/images.rec`` and its
    ``.idx``: (path, the first 64 images, labels)."""
    import numpy as np
    rs = np.random.RandomState(0)
    labels = rs.randint(0, 1000, REC_IMAGES)
    path = os.path.join(root, "images.rec")
    t0 = time.perf_counter()
    rec = mx.recordio.MXIndexedRecordIO(os.path.join(root, "images.idx"),
                                        path, "w")
    first = []
    for i in range(REC_IMAGES):
        img = rs.randint(0, 256, (REC_SRC, REC_SRC, 3), dtype=np.uint8)
        if i < 64:
            first.append(img)
        rec.write_idx(i, mx.recordio.pack_img(
            (0, float(labels[i]), i, 0), img, img_fmt=".npy"))
    rec.close()
    secs = time.perf_counter() - t0
    nbytes = os.path.getsize(path)
    print(f"  (a) wrote {REC_IMAGES} images ({REC_SRC}x{REC_SRC}x3 uint8, "
          f".npy payloads) and the index: {nbytes / 1e6:.1f} MB in "
          f"{secs:.2f} s ({nbytes / secs / 1e6:.0f} MB/s)")
    return path, np.stack(first), labels.astype(np.float32)


def read_epoch(it, check_batch=None):
    """One epoch of ``it`` to its end: (batches, seconds), the card
    synchronised at the end."""
    import torch
    t0 = time.perf_counter()
    n = 0
    for batch in it:
        if check_batch is not None:
            check_batch(batch)
        n += 1
    torch.cuda.synchronize()
    return n, time.perf_counter() - t0


def phase_rec_iter(mx, path, labels):
    """(b) the iterator alone: one warm epoch timed; every batch a bf16
    (256, 3, 224, 224) tensor on the card; device_augment in float32
    against the host path under the same seed."""
    import random
    import numpy as np
    import torch
    it = rec_iter(mx, path)
    seen = []

    def check_batch(b):
        x, y = b.data[0], b.label[0]
        check(x.dtype == torch.bfloat16 and x.is_cuda and tuple(x.shape) ==
              (VISION_BATCH, 3, VISION_IMG, VISION_IMG) and y.is_cuda,
              f"ImageRecordIter batch {x.dtype} {tuple(x.shape)} on "
              f"{x.device}, label on {y.device}")
        seen.append(y)

    n0, t_cold = read_epoch(it, check_batch)
    it.reset()
    seen.clear()
    n1, t_warm = read_epoch(it, check_batch)
    got = torch.cat(seen).cpu().numpy()
    check(n0 == n1 == REC_IMAGES // VISION_BATCH and
          sorted(got.tolist()) == sorted(labels.tolist()),
          f"an epoch gave {n1} batches or other labels")
    threads = min(16, os.cpu_count() or 1)
    rate = REC_IMAGES / t_warm
    print(f"  (b) ImageRecordIter, B={VISION_BATCH}, shuffled, random crop "
          f"and mirror, mean/std, device_augment bf16, {threads} "
          f"preprocess threads, prefetch 4 (host: {os.cpu_count()} CPUs): "
          f"first epoch {t_cold:.2f} s, warm epoch {t_warm:.3f} s, "
          f"{rate:.1f} images/s; every batch bf16 "
          f"{(VISION_BATCH, 3, VISION_IMG, VISION_IMG)} on the card, labels "
          "a permutation")
    # float32 on the device against the host path: no mirror (the two
    # paths draw its flips from different streams) and one thread (the
    # crops draw from Python's random in the order images are decoded)
    outs = []
    for dev in (True, False):
        random.seed(0)
        np.random.seed(0)
        ref = rec_iter(mx, path, rand_mirror=False, device_augment=dev,
                       device_dtype="float32", preprocess_threads=1,
                       prefetch_buffer=1)
        outs.append([ref.next() for _ in range(REC_CHECK_BATCHES)])
        ref.close()
    err = 0.0
    for d, h in zip(*outs):
        check(d.data[0].dtype == torch.float32 and d.data[0].is_cuda,
              "device_augment float32 batch not float32 on the card")
        check(torch.equal(d.label[0], h.label[0]),
              "device_augment labels differ from the host path's")
        err = max(err, (d.data[0] - h.data[0]).abs().max().item())
    print(f"  device_augment float32 against the host path, "
          f"{REC_CHECK_BATCHES} batches, same seed: max |diff| {err:.3e} "
          f"(limit {TOL_REC_F32}), labels equal")
    check(err <= TOL_REC_F32, f"device_augment differs from the host path "
          f"by {err:.3e}")
    return rate


def phase_rec_fit(mx, path, resident, it_rate):
    """(c) phase 11's ResNet-50 ``Module.fit`` (3 epochs of 8 batches)
    fed by the ``ImageRecordIter`` of (b)."""
    import gc
    import numpy as np
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    sym = resnet_symbol(mx, VISION_MODEL)
    mod = bind_resnet_module(mx, sym)
    it = rec_iter(mx, path)
    metric = DeviceNLL(mx)
    marks = []

    def epoch_end(epoch, sym_, arg, aux):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    marks.append(time.perf_counter())
    mod.fit(it, num_epoch=MODULE_EPOCHS, eval_metric=metric.metric,
            epoch_end_callback=epoch_end)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = metric.materialize()
    epochs = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    step = (marks[-1] - marks[1]) * 1e3 / (MODULE_BATCHES *
                                           (MODULE_EPOCHS - 1))
    rate = VISION_BATCH / step * 1e3
    print(f"  (c) Module.fit fed by ImageRecordIter: epochs "
          f"{[round(e, 1) for e in epochs]} ms (one synchronisation each); "
          f"{step:.1f} ms per step over the two timed epochs, {rate:.1f} "
          f"images/s; peak memory {peak / 2 ** 30:.2f} GiB")
    print(f"  beside phase 11's resident step {resident['step_ms']:.1f} ms, "
          f"{resident['images_s']:.1f} images/s, peak "
          f"{resident['peak_gib']:.2f} GiB; fed over resident "
          f"{step / resident['step_ms']:.3f}x; the iterator alone "
          f"{it_rate:.1f} images/s")
    print(f"  NLL per batch {[round(v, 4) for v in losses]}")
    check(len(losses) == MODULE_EPOCHS * MODULE_BATCHES and
          np.isfinite(losses).all(), f"fed Module losses: {losses}")
    check(not any(counts.values()), f"the fed Module path launched a kernel "
          f"of the repo: {counts}")
    it.close()

    def traced_epoch():
        # a fresh iterator, so that every upload and augment of the epoch
        # falls inside the trace; closed before the trace ends
        fresh = rec_iter(mx, path)
        mod.fit(fresh, begin_epoch=MODULE_EPOCHS,
                num_epoch=MODULE_EPOCHS + 1, eval_metric=metric.metric)
        fresh.close()

    rows = kernel_rows(traced_epoch)
    if rows:
        # the augment runs on a stream of its own: its kernels may overlap
        # the step's, so the sum bounds the device's busy time from above
        busy = sum(r[0] for r in rows) / MODULE_BATCHES
        up = [r for r in rows if "HtoD" in r[2]]
        up_ms = sum(r[0] for r in up) / MODULE_BATCHES
        print(f"  one fed epoch under torch.profiler: device time per step "
              f"{busy:.3f} ms (kernels and copies of both streams, summed), "
              f"of which host-to-device copies {up_ms:.3f} ms "
              f"({sum(r[1] for r in up)} copies in the epoch); beside phase "
              f"11's resident kernel time "
              f"{resident.get('kernel_ms', float('nan')):.3f} ms; the fed "
              f"step less its device time {step - busy:.3f} ms (the "
              "resident step's "
              f"{resident.get('host_gaps_ms', float('nan')):.3f} ms)")
        for g, (ms, count) in sorted(group_rows(rows).items(),
                                     key=lambda kv: -kv[1][0]):
            print(f"    {g}: {ms / MODULE_BATCHES:.3f} ms per step, "
                  f"{count} launches in the epoch")
    else:
        print("  fed epoch device time not measured: torch.profiler saw no "
              "device time")
    del mod


def phase_tensor_rec(mx, root):
    """(d) ``TensorRecordIter`` over 2,048 raw uint8 3x224x224 records on
    the native loader, B=256, shuffled."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import _native
    from mxnet_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    _native.lib()
    built = _build.BUILD_LOG.get("mxtpu_runtime", {}).get("seconds")
    print(f"  (d) native runtime (src/runtime, g++): loaded in "
          f"{time.perf_counter() - t0:.2f} s"
          + (f" (built in {built:.2f} s)" if built else ""))
    rs = np.random.RandomState(1)
    data = rs.randint(0, 256, (REC_IMAGES, 3, VISION_IMG, VISION_IMG),
                      dtype=np.uint8)
    labels = np.arange(REC_IMAGES, dtype=np.float32)
    path = os.path.join(root, "tensors.rec")
    t0 = time.perf_counter()
    mx.io.save_tensor_rec(path, data, labels)
    secs = time.perf_counter() - t0
    nbytes = os.path.getsize(path)
    it = mx.io.TensorRecordIter(path, (3, VISION_IMG, VISION_IMG),
                                VISION_BATCH, shuffle=True, seed=0,
                                prefetch_buffer=4, ctx=mx.gpu(0))
    seen, first = [], []

    def check_batch(b):
        x, y = b.data[0], b.label[0]
        check(x.dtype == torch.uint8 and x.is_cuda and y.is_cuda and
              tuple(x.shape) == (VISION_BATCH, 3, VISION_IMG, VISION_IMG),
              f"TensorRecordIter batch {x.dtype} {tuple(x.shape)} on "
              f"{x.device}")
        seen.append(y)
        if not first:
            first.append((x[5].cpu().numpy(), int(y[5].item())))

    n, t_epoch = read_epoch(it, check_batch)
    got = torch.cat(seen).cpu().numpy()
    rate = REC_IMAGES / t_epoch
    print(f"  wrote {REC_IMAGES} records ({nbytes / 1e6:.1f} MB) in "
          f"{secs:.2f} s; one shuffled epoch, B={VISION_BATCH}, to the card:"
          f" {n} batches in {t_epoch:.3f} s, {rate:.1f} images/s")
    check(sorted(got.tolist()) == labels.tolist(),
          "TensorRecordIter's labels are not a permutation of those written")
    check(not np.array_equal(got, labels), "TensorRecordIter did not "
          "shuffle")
    sample, idx = first[0]
    check(np.array_equal(sample, data[idx]), f"record {idx}'s bytes differ "
          "from those written")
    print(f"  labels a permutation of those written; record {idx}'s bytes "
          "equal")
    del it, data


def mirror_resnet18_step(mx, sym, mirror):
    """resnet18_v1's ``sym`` in f32 (B=2, 64x64), one Module
    forward_backward from seed 0 under deterministic algorithms:
    (segments, gradients, moving statistics)."""
    import numpy as np
    rs = np.random.RandomState(3)
    xs = rs.normal(size=GRAD_VISION_SHAPE).astype(np.float32)
    ys = rs.randint(0, 1000, GRAD_VISION_SHAPE[0]).astype(np.float32)
    mod = mx.mod.Module(sym, context=mx.gpu(0))
    with mirrored(mirror):
        mod.bind([("data", GRAD_VISION_SHAPE)],
                 [("softmax_label", (GRAD_VISION_SHAPE[0],))])
    mx.random.seed(0)
    mod.init_params(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                   magnitude=2))
    with deterministic():
        mod.forward_backward(mx.io.DataBatch(
            [mx.nd.array(xs, ctx=mx.gpu(0))],
            [mx.nd.array(ys, ctx=mx.gpu(0))]))
    ex = mod._exec
    return ex._segments, {n: g.clone() for n, g in ex.grad_dict.items()}, \
        {n: a.clone() for n, a in ex.aux_dict.items()}


def mirror_resnet50_steps(mx, sym, mirror, steps=MIRROR_STEPS, det=False):
    """Phase 11's ResNet-50 Module (bf16, B=256) of ``sym`` on one resident
    batch,
    mirrored or not: ``steps`` steps, the first a warm-up, under
    deterministic algorithms with ``det``; (median step ms, peak GiB,
    segments, losses, parameters and moving statistics after the steps)."""
    import gc
    import numpy as np
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    with mirrored(mirror):
        mod = bind_resnet_module(mx, sym)
    data, labels = module_data(mx, VISION_BATCH)
    batch = mx.io.DataBatch([data], [labels])
    metric = DeviceNLL(mx)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    with deterministic() if det else contextlib.nullcontext():
        for _ in range(steps):
            t0 = time.perf_counter()
            mod.forward_backward(batch)
            mod.update()
            mod.update_metric(metric.metric, batch.label)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = metric.materialize()
    segs = mod._exec._segments
    arg, aux = mod.get_params()
    params = {n: t.clone() for n, t in list(arg.items()) + list(aux.items())}
    del mod, batch, data, labels
    check(np.isfinite(losses).all(), f"ResNet-50 losses {losses}")
    return statistics.median(walls[1:]), peak, segs, losses, params


def mirror_diff(want, got):
    """(bitwise, the largest |diff| of a tensor over that tensor's largest
    magnitude) of two {name: tensor} with the same names."""
    import torch
    bitwise = all(torch.equal(want[n], got[n]) for n in want)
    err = max((got[n].float() - want[n].float()).abs().max().item() /
              max(want[n].float().abs().max().item(), 1e-30) for n in want)
    return bitwise, err


def phase_mirror(mx, lm_gluon, lm_module):
    """(e) ``MXNET_BACKWARD_DO_MIRROR``: resnet18_v1 f32 mirrored against
    unmirrored; ResNet-50 and the LM Module leg mirrored, peak memory and
    step time against unmirrored (the LM's: phase 11's run)."""
    sym = resnet_symbol(mx, "resnet18_v1")
    (s0, g0, a0), (s1, g1, a1) = (mirror_resnet18_step(mx, sym, m)
                                  for m in (False, True))
    check(s0 == 1 and s1 > 1, f"segments {s0} and {s1}")
    bitwise, err = mirror_diff({**g0, **a0}, {**g1, **a1})
    print(f"  (e) resnet18_v1 f32 B={GRAD_VISION_SHAPE[0]} Module step under "
          f"deterministic algorithms, {s1} segments against 1: "
          f"{len(g0)} gradients and {len(a0)} moving statistics "
          + ("bitwise equal" if bitwise else
             f"not bitwise (cuDNN picks its algorithms per call and the "
             f"recomputed forward is another call); max |diff| over each "
             f"one's largest {err:.3e} (limit {TOL_MIRROR})"))
    check(bitwise or err <= TOL_MIRROR, f"mirrored resnet18_v1 step differs "
          f"by {err:.3e}")
    sym = resnet_symbol(mx, VISION_MODEL)
    rows = {m: mirror_resnet50_steps(mx, sym, m) for m in (False, True)}
    for m, (step, peak, segs, losses, _) in rows.items():
        print(f"  ResNet-50 Module B={VISION_BATCH} bf16, "
              f"{'mirrored' if m else 'unmirrored'} ({segs} segment(s)): "
              f"{step:.1f} ms per step (median of {MIRROR_STEPS - 1} after a "
              f"warm-up), peak {peak:.2f} GiB; NLL "
              f"{[round(v, 4) for v in losses]}")
    (s_p, p_p, _, l_p, _), (s_m, p_m, _, l_m, _) = rows[False], rows[True]
    l_err = max(abs(b - a) / abs(a) for a, b in zip(l_p, l_m))
    print(f"  ResNet-50 mirrored over unmirrored: step {s_m / s_p:.3f}x, "
          f"peak {p_m / p_p:.3f}x; NLL of each step max relative |diff| "
          f"{l_err:.3e} (limit {TOL_MIRROR_LOSS})")
    check(l_err <= TOL_MIRROR_LOSS, f"mirrored ResNet-50 NLL {l_m} against "
          f"unmirrored {l_p}")
    det = [mirror_resnet50_steps(mx, sym, m, MIRROR_DET_STEPS, det=True)[4]
           for m in (False, True)]
    bitwise, err = mirror_diff(*det)
    print(f"  ResNet-50 {MIRROR_DET_STEPS} steps under deterministic "
          f"algorithms, mirrored against unmirrored: {len(det[0])} parameters"
          " and moving statistics after them "
          + ("bitwise equal" if bitwise else
             f"not bitwise; max |diff| over each one's largest {err:.3e} "
             f"(limit {TOL_MIRROR})"))
    check(bitwise or err <= TOL_MIRROR, f"mirrored ResNet-50 parameters "
          f"differ by {err:.3e}")
    counts, lm = phase_module_lm(mx, lm_gluon, mirror=True)
    lm_err = max(abs(b - a) / abs(a) for a, b in
                 zip(lm_module["losses"], lm["losses"]))
    print(f"  LM Module leg mirrored: step {lm['step_ms']:.1f} ms, peak "
          f"{lm['peak_gib']:.2f} GiB against phase 11's unmirrored "
          f"{lm_module['step_ms']:.1f} ms, {lm_module['peak_gib']:.2f} GiB "
          f"({lm['step_ms'] / lm_module['step_ms']:.3f}x, "
          f"{lm['peak_gib'] / lm_module['peak_gib']:.3f}x); NLL against "
          f"phase 11's (same weights, batch and steps) max relative |diff| "
          f"{lm_err:.3e} (limit {TOL_MIRROR_LOSS})")
    check(len(lm["losses"]) == len(lm_module["losses"]) and
          lm_err <= TOL_MIRROR_LOSS, f"mirrored LM NLL {lm['losses']} "
          f"against phase 11's {lm_module['losses']}")
    return counts, {"resnet50": rows, "lm": lm}


def phase_export(mx, root):
    """(f) ``export_decode_step`` of phase 3's float32 net, served by a
    ``Predictor`` on the card: 8 greedy tokens from a 16-token prompt,
    the cache outputs fed back, against ``generate(kv_cache=True)``."""
    import gc
    import numpy as np
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    flash, dense = build_nets(mx)
    del dense
    prompt = np.random.RandomState(42).randint(
        0, CONFIG["vocab"], (1, EXPORT_PROMPT)).astype(np.float32)
    want = mx.nd.asnumpy(flash.generate(mx.nd.array(prompt, ctx=mx.gpu(0)),
                                        MAX_NEW, kv_cache=True))
    prefix = os.path.join(root, "lm-decode")
    t0 = time.perf_counter()
    names = flash.export_decode_step(prefix)
    t_export = time.perf_counter() - t0
    blk = flash.blocks._children[0].attn
    cache = (1, blk._h, CONFIG["max_len"], blk._dh)
    del flash
    gc.collect()
    torch.cuda.empty_cache()
    shapes = {"data0": (1, 1), "data1": (1,)}
    shapes.update({n: cache for n in names[2:]})
    t0 = time.perf_counter()
    pred = mx.predictor.create(prefix + "-symbol.json", prefix + "-0000.params",
                               shapes, dev=mx.gpu(0))
    t_load = time.perf_counter() - t0
    toks = [float(t) for t in prompt[0]]
    t0 = time.perf_counter()
    for t in range(EXPORT_PROMPT + MAX_NEW - 1):
        pred.set_input("data0", np.array([[toks[t]]], np.float32))
        pred.set_input("data1", np.array([float(t)], np.float32))
        pred.forward()
        outs = pred.outputs
        for name, c in zip(names[2:], outs[1:]):
            pred.set_input(name, c)
        if t + 1 >= EXPORT_PROMPT:
            toks.append(float(outs[0].argmax(-1)[0]))
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    got = np.array([toks], np.float32)
    size = os.path.getsize(prefix + "-0000.params")
    print(f"  (f) export_decode_step, float32: {len(names)} inputs, "
          f"{size / 2 ** 30:.3f} GiB of parameters, written in "
          f"{t_export:.2f} s, loaded by Predictor on the card in "
          f"{t_load:.2f} s; {EXPORT_PROMPT + MAX_NEW - 1} steps in "
          f"{t_decode:.2f} s; new tokens "
          f"{got[0, EXPORT_PROMPT:].astype(int).tolist()}")
    check(np.array_equal(got, want), f"Predictor tokens "
          f"{got[0, EXPORT_PROMPT:].tolist()} differ from generate's "
          f"{want[0, EXPORT_PROMPT:].tolist()}")
    print("  equal to generate(kv_cache=True)'s tokens")
    del pred


def phase_rec_dataset(mx, path, first):
    """(g) ``ImageRecordDataset`` over (a)'s file through a ``DataLoader``:
    one batch to the card."""
    import numpy as np
    import torch
    ds = mx.gluon.data.vision.ImageRecordDataset(path)
    first = first[:REC_IMAGES]
    loader = mx.gluon.data.DataLoader(ds, batch_size=len(first))
    t0 = time.perf_counter()
    x, y = next(iter(loader))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check(len(ds) == REC_IMAGES and isinstance(x, torch.Tensor) and x.is_cuda
          and tuple(x.shape) == first.shape
          and x.dtype == torch.uint8, f"ImageRecordDataset batch "
          f"{getattr(x, 'shape', None)} on {getattr(x, 'device', None)}")
    check(np.array_equal(x.cpu().numpy(), first), "ImageRecordDataset's "
          "images differ from those written")
    print(f"  (g) ImageRecordDataset + DataLoader: one batch "
          f"{tuple(x.shape)} uint8 on the card in {secs:.3f} s, equal to the "
          "images written")


# ---------------------------------------------------------------------------
# phase 15: the one-program training step (CUDA graphs)
# ---------------------------------------------------------------------------
WHOLE_STEPS = 6         # (a): phase 9's LM through WholeStepCompiler
WHOLE_LR = 0.01
AMP_LR = 3e-4           # (b): f32 weights, Adam, MXNET_AMP=bf16
TOL_AMP_BF16 = 3e-2     # each step's loss against the f32 policy, relative
FP16_INIT = 1024        # (c): MXNET_LOSS_SCALE_INIT, MXNET_LOSS_SCALE_WINDOW
FP16_WINDOW = 3
FP16_FINITE = 5
COMP_STEPS = 4          # (d): 2-bit compression, threshold 0.5
SUPER_K = 4             # (f): 8 steps as 2 supersteps of 4
SUPER_STEPS = 8
FUSED_VS_STD_STEPS = 3  # (e): resnet18_v1 fused against standard
FUSED_LM_STEPS = 4      # (e): the LM leg, eager, captured, two replays
TOL_CAPTURED = 1e-5     # where not bitwise: of each one's largest change


@contextlib.contextmanager
def env_vars(**kw):
    """Environment variables set (a value of None unsets) for a block."""
    old = {k: os.environ.get(k) for k in kw}
    for k, v in kw.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = str(v)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def lm_start(mx):
    """Phase 9's LM from seed 0 (Xavier), its float32 weights by name (the
    parameters named ``lm_*``, as every net built by ``lm_fresh``)."""
    import numpy as np
    from mxnet_tpu_torch.gluon.model_zoo.transformer import TransformerLM
    mx.random.seed(0)
    net = TransformerLM(**CONFIG, attn_type="flash", prefix="lm_")
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    net(mx.nd.array(np.zeros((1, 8), np.float32), ctx=mx.gpu(0)))
    return {p.name: p.data().detach().clone()
            for p in net.collect_params().values()}


def lm_fresh(mx, start, dtype):
    """A new LM holding ``start``'s weights, in ``dtype``, hybridized."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.gluon.model_zoo.transformer import TransformerLM
    net = TransformerLM(**CONFIG, attn_type="flash", prefix="lm_")
    net.initialize(mx.init.Zero(), ctx=mx.gpu(0))
    net(mx.nd.array(np.zeros((1, 8), np.float32), ctx=mx.gpu(0)))
    with torch.no_grad():
        for p in net.collect_params().values():
            p.data().copy_(start[p.name])
    if dtype != "float32":
        net.cast(dtype)
    net.hybridize()
    return net


def token_batches(mx, n, seed=1):
    """``n`` (tokens, next tokens) batches of B=8, T=1024 on the card."""
    import numpy as np
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        toks = rs.randint(0, CONFIG["vocab"], (TRAIN_BATCH,
                                               CONFIG["max_len"] + 1))
        out.append((mx.nd.array(toks[:, :-1].astype(np.float32),
                                ctx=mx.gpu(0)),
                    mx.nd.array(toks[:, 1:].astype(np.float32),
                                ctx=mx.gpu(0))))
    return out


def lm_trainer(mx, net, optimizer="sgd", compression=None):
    """(a)'s trainer (SGD momentum 0.9, lr 0.01, float32 masters), Adam
    (lr 3e-4) for (b); with ``compression`` on a ``tpu_sync`` store that
    only reduces (the store compresses)."""
    params = {"learning_rate": WHOLE_LR, "momentum": 0.9,
              "multi_precision": True} if optimizer == "sgd" else \
        {"learning_rate": AMP_LR}
    kw = {} if compression is None else dict(
        kvstore="tpu_sync", update_on_kvstore=False,
        compression_params=compression)
    return mx.gluon.Trainer(net.collect_params(), optimizer, params, **kw)


def run_steps(fn, batches, rec):
    """``fn(x, y)`` per batch, synchronized: losses (per-sample means on
    the host after the run), host times and kernel launches per step into
    ``rec``."""
    import torch
    losses = []
    for x, y in batches:
        before = read_counts()
        t0 = time.perf_counter()
        losses.append(fn(x, y))
        torch.cuda.synchronize()
        rec["walls"].append((time.perf_counter() - t0) * 1e3)
        after = read_counts()
        rec["launches"].append({k: after[k] - before[k] for k in after})
    rec["raw"] += [l.detach() for l in losses]
    rec["losses"] += [float(l.detach().float().mean()) for l in losses]
    return rec


def new_rec():
    return {"walls": [], "launches": [], "losses": [], "raw": []}


def check_step_launches(what, rec, variant, L, captured_from=1):
    """Every eager step and the capture launch (and count) ``L`` K1 and
    ``L`` K1b of ``variant`` and none of the other; a replay counts none
    (it runs no Python).  ``captured_from``: the step that captured."""
    other = "f32" if variant == "sm90" else "sm90"
    for i, c in enumerate(rec["launches"]):
        want = L if i <= captured_from else 0
        check(c[f"flash_attention.{variant}"] == want
              and c[f"flash_attention.bwd.{variant}"] == want
              and c[f"flash_attention.{other}"] == 0
              and c[f"flash_attention.bwd.{other}"] == 0,
              f"{what} step {i}: launches {c}; want {want} {variant} K1 and "
              f"{want} {variant} K1b (the eager step and the capture count, "
              "a replay runs no Python), none on " + other)


def replay_kernel_counts(fn):
    """Launches of K1 and of each K1b kernel that torch.profiler records in
    one call of ``fn`` (a replay); None where it records no device time."""
    rows = kernel_rows(fn)
    if not rows:
        return None
    names = {"K1": ("flash_attention_fwd",), "K1b dK/dV": ("dkdv_kernel",),
             "K1b dQ": ("dq_kernel",), "K1b D_i": ("stats_kernel",)}
    return {g: sum(r[1] for r in rows if any(k in r[2] for k in keys))
            for g, keys in names.items()}


def tensors_diff(want, got):
    """(bitwise, max |diff| over each tensor's largest |want|)."""
    import torch
    bitwise = len(want) == len(got) and all(
        torch.equal(a, b) for a, b in zip(want, got))
    rel = 0.0
    for a, b in zip(want, got):
        scale = a.float().abs().max().item() or 1.0
        rel = max(rel, (a.float() - b.float()).abs().max().item() / scale)
    return bitwise, rel


def moved_diff(start, want, got):
    """Max |got - want| over each parameter's largest change from
    ``start``."""
    rel = 0.0
    for s, a, b in zip(start, want, got):
        moved = (a.float() - s.float()).abs().max().item()
        err = (a.float() - b.float()).abs().max().item()
        rel = max(rel, err / moved if moved else err)
    return rel


def lm_weights(trainer):
    """The weights, then every optimizer state tensor (the float32 masters
    and momenta)."""
    from mxnet_tpu_torch.gluon.wholestep import _leaves
    out = [p.data().detach().clone() for p in trainer._params]
    for i in sorted(trainer._updater.states):
        out += [t.detach().clone()
                for t in _leaves(trainer._updater.states[i])]
    return out


def phase_wholestep(mx, start, gluon):
    """(a) phase 9's LM (bf16 weights, float32 masters, SGD momentum) for
    WHOLE_STEPS steps through WholeStepCompiler with MXNET_WHOLE_STEP=1,
    against the fused path (the same compiler with it unset) from the same
    weights and batches, both under deterministic algorithms."""
    import gc
    import torch
    from mxnet_tpu_torch.gluon.wholestep import WholeStepCompiler
    L = CONFIG["num_layers"]
    batches = token_batches(mx, WHOLE_STEPS)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    runs = {}
    for whole in (False, True):
        gc.collect()
        torch.cuda.empty_cache()
        net = lm_fresh(mx, start, "bfloat16")
        trainer = lm_trainer(mx, net)
        stepper = WholeStepCompiler(net, loss_fn, trainer)
        rec = new_rec()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with env_vars(MXNET_WHOLE_STEP=1 if whole else 0), deterministic():
            run_steps(stepper.step, batches, rec)
        rec["counts"] = read_counts()
        rec["peak"] = torch.cuda.max_memory_allocated()
        rec["weights"] = lm_weights(trainer)
        if whole:
            check(stepper.active, f"whole step inactive: "
                  f"{stepper.fallback_reason}")
            rec["captures"] = stepper.captures
            rec["replay_ms"] = stepper._graph.replay_host_ms
            with env_vars(MXNET_WHOLE_STEP=1):
                x, y = batches[0]
                rec["profile"] = replay_kernel_counts(
                    lambda: stepper.step(x, y))
        runs[whole] = rec
        del net, trainer, stepper
    fused, whole = runs[False], runs[True]
    bitwise_l, _ = tensors_diff(fused["raw"], whole["raw"])
    bitwise_w, _ = tensors_diff(fused["weights"], whole["weights"])
    step = statistics.median(whole["walls"][1:])
    fstep = statistics.median(fused["walls"][1:])
    print(f"  (a) whole step, policy f32, bf16 weights with f32 masters, "
          f"SGD momentum 0.9, B={TRAIN_BATCH} T={CONFIG['max_len']}: losses"
          f" {[round(v, 4) for v in whole['losses']]}; captures "
          f"{whole['captures']}")
    print(f"      step times (host clock, synchronized) "
          f"{[round(w, 1) for w in whole['walls']]} ms: step 1 eager, 2 "
          f"captures and replays, 3-6 replay; median of steps 2-6 "
          f"{step:.1f} ms ({TRAIN_BATCH * CONFIG['max_len'] / step * 1e3:.0f}"
          f" tokens/s) beside the fused path's {fstep:.1f} ms in this run "
          f"({[round(w, 1) for w in fused['walls']]}) and phase 9's "
          f"{gluon['step_ms']:.1f} ms; the replay call's host time "
          f"{whole['replay_ms']:.3f} ms; peak memory "
          f"{whole['peak'] / 2 ** 30:.2f} GiB (fused path "
          f"{fused['peak'] / 2 ** 30:.2f}, phase 9 "
          f"{gluon['peak_gib']:.2f})")
    prof = whole["profile"]
    print(f"      against the fused path: losses bitwise {bitwise_l}, "
          f"{len(whole['weights'])} weights and optimizer states bitwise "
          f"{bitwise_w};"
          f" launches counted per step {[c['flash_attention.sm90'] for c in whole['launches']]}"
          f" sm90 K1, {[c['flash_attention.bwd.sm90'] for c in whole['launches']]}"
          f" sm90 K1b; one replay's kernels by name: "
          + (str(prof) if prof is not None else "not measured "
             "(torch.profiler saw no device time)"))
    if not (bitwise_l and bitwise_w):
        lrel = max(abs(a - b) / max(abs(a), 1e-12)
                   for a, b in zip(fused["losses"], whole["losses"]))
        _, wrel = tensors_diff(fused["weights"], whole["weights"])
        print(f"      not bitwise: losses within {lrel:.3e} relative, "
              f"weights within {wrel:.3e} of each one's largest")
        check(lrel <= TOL_CAPTURED and wrel <= TOL_CAPTURED,
              "the whole step and the fused path differ beyond "
              f"{TOL_CAPTURED}")
    check(len(whole["captures"]) == 1, f"want one capture in "
          f"{WHOLE_STEPS} steps, got {whole['captures']}")
    check_step_launches("(a) whole step", whole, "sm90", L)
    if prof is not None:
        check(prof["K1"] == L and prof["K1b dK/dV"] == L
              and prof["K1b dQ"] == L, f"one replay's flash kernels by "
              f"name: {prof}; want {L} of each")
    return whole["counts"], {"step_ms": step, "fused_ms": fstep,
                             "replay_ms": whole["replay_ms"],
                             "peak_gib": whole["peak"] / 2 ** 30}


def phase_dropout_replay(mx):
    """Dropout 0.5 under replay: an MLP at the LM's width, SGD with lr 0
    (the weights stay), one batch for 5 whole steps: each replay draws a
    new mask from the port's generator, registered with the graph, so
    the losses of the replayed steps differ; where PyTorch cannot
    register a generator, the capture raises instead.  Then 2 steps on
    half the batch: a new data shape, captured again, the reason said."""
    import torch
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.gluon.wholestep import WholeStepCompiler
    dev = mx.gpu(0).torch_device()
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((64, 1024), generator=gen, device=dev)
    y = torch.randn((64, 1024), generator=gen, device=dev)
    mx.random.seed(0)
    net = mx.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(1024, activation="relu"))
        net.add(mx.gluon.nn.Dropout(0.5))
        net.add(mx.gluon.nn.Dense(1024))
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    net.hybridize()
    net(x)
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.0})
    stepper = WholeStepCompiler(net, mx.gluon.loss.L2Loss(), trainer)
    can = hasattr(torch.cuda.CUDAGraph, "register_generator_state")
    losses = []
    with env_vars(MXNET_WHOLE_STEP=1):
        try:
            for _ in range(5):
                losses.append(float(stepper.step(x, y).mean()))
        except MXNetError as e:
            check(not can, f"dropout capture raised: {e}")
            print(f"  dropout 0.5 under replay: the capture raised, as it "
                  f"must without a generator registration: {e}")
            return
    with env_vars(MXNET_WHOLE_STEP=1):
        half = [float(stepper.step(x[:32], y[:32]).mean())
                for _ in range(2)]
    print(f"  dropout 0.5 under replay (lr 0, one batch): losses "
          f"{[round(v, 6) for v in losses]}; then B=32: "
          f"{[round(v, 6) for v in half]}; captures {stepper.captures}")
    check(can and len(set(losses[1:])) == len(losses) - 1,
          "the replays did not draw new dropout masks")
    check(len(stepper.captures) == 2 and "data" in stepper.captures[1],
          f"a new data shape did not capture again: {stepper.captures}")


def phase_amp_bf16(mx, start):
    """(b) the LM with float32 weights and Adam under MXNET_AMP=bf16,
    against the f32-policy whole step from the same weights and batches."""
    import gc
    import torch
    from mxnet_tpu_torch.gluon.wholestep import WholeStepCompiler
    L = CONFIG["num_layers"]
    batches = token_batches(mx, WHOLE_STEPS)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    runs = {}
    for policy in ("f32", "bf16"):
        gc.collect()
        torch.cuda.empty_cache()
        net = lm_fresh(mx, start, "float32")
        trainer = lm_trainer(mx, net, "adam")
        stepper = WholeStepCompiler(net, loss_fn, trainer)
        rec = new_rec()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with env_vars(MXNET_WHOLE_STEP=1, MXNET_AMP=policy):
            run_steps(stepper.step, batches, rec)
        check(stepper.active, f"whole step inactive under {policy}: "
              f"{stepper.fallback_reason}")
        rec["counts"] = read_counts()
        rec["peak"] = torch.cuda.max_memory_allocated()
        rec["captures"] = stepper.captures
        rec["dtypes"] = {str(t.dtype)[6:] for t in lm_weights(trainer)}
        runs[policy] = rec
        del net, trainer, stepper
    ref, amp = runs["f32"], runs["bf16"]
    rel = max(abs(a - b) / abs(a) for a, b in zip(ref["losses"],
                                                   amp["losses"]))
    step = statistics.median(amp["walls"][1:])
    print(f"  (b) MXNET_AMP=bf16, f32 weights, Adam lr {AMP_LR}: losses "
          f"{[round(v, 4) for v in amp['losses']]} against the f32 policy's"
          f" {[round(v, 4) for v in ref['losses']]}: within {rel:.3e} "
          f"relative (limit {TOL_AMP_BF16}); weights and Adam states "
          f"{sorted(amp['dtypes'])}; step times {[round(w, 1) for w in amp['walls']]}"
          f" ms, median of 2-6 {step:.1f} ms (f32 policy "
          f"{statistics.median(ref['walls'][1:]):.1f} ms); peak "
          f"{amp['peak'] / 2 ** 30:.2f} GiB (f32 policy "
          f"{ref['peak'] / 2 ** 30:.2f}); captures {amp['captures']}")
    check(rel <= TOL_AMP_BF16, f"bf16 AMP losses off the f32 policy's by "
          f"{rel:.3e}")
    check(amp["dtypes"] == {"float32"}, f"AMP weights or states "
          f"{amp['dtypes']}, not float32")
    for what, rec in (("(b) f32 policy", ref), ("(b) bf16 AMP", amp)):
        check(len(rec["captures"]) == 1, f"{what}: captures "
              f"{rec['captures']}")
        check_step_launches(what, rec, "f32", L)
    return amp["counts"], {"step_ms": step, "peak_gib": amp["peak"] / 2 ** 30}


def phase_amp_fp16(mx, mha_times):
    """(c) phase 12's MultiHeadAttention block (float32 weights, Adam) under
    an L2Loss against a random target through the whole step with
    MXNET_AMP=fp16 and the loss scaler: FP16_FINITE finite steps, one batch
    with an inf, one finite step."""
    import torch
    from mxnet_tpu_torch.gluon.wholestep import WholeStepCompiler
    T, B, E, H = CONFIG["max_len"], MHA_BATCH, MHA_UNITS, MHA_HEADS
    dev = mx.gpu(0).torch_device()
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((B, T, E), generator=gen, device=dev)
    target = torch.randn((B, T, E), generator=gen, device=dev)
    bad = torch.full_like(x, float("inf"))
    mx.random.seed(0)
    block = mx.gluon.nn.MultiHeadAttention(E, H, prefix="mha_")
    block.initialize(ctx=mx.gpu(0))
    block.hybridize()
    block(x)                    # resolves any deferred shape
    trainer = mx.gluon.Trainer(block.collect_params(), "adam",
                               {"learning_rate": AMP_LR})
    stepper = WholeStepCompiler(block, mx.gluon.loss.L2Loss(), trainer)
    rec, scales = new_rec(), []
    reset_counts()
    with env_vars(MXNET_WHOLE_STEP=1, MXNET_AMP="fp16",
                  MXNET_LOSS_SCALE_INIT=FP16_INIT,
                  MXNET_LOSS_SCALE_WINDOW=FP16_WINDOW):
        for _ in range(FP16_FINITE):
            run_steps(stepper.step, [(x, target)], rec)
            scales.append(trainer.loss_scale)
        upd = trainer._updater
        keep = [p.data().clone() for p in trainer._params] + \
            [t.clone() for s in upd.states.values() for t in s] + \
            [trainer._applied_ts[1].clone()]
        run_steps(stepper.step, [(bad, target)], rec)
        scales.append(trainer.loss_scale)
        after = [p.data().clone() for p in trainer._params] + \
            [t.clone() for s in upd.states.values() for t in s] + \
            [trainer._applied_ts[1].clone()]
        run_steps(stepper.step, [(x, target)], rec)
        scales.append(trainer.loss_scale)
    counts = read_counts()
    held = all(torch.equal(a, b) for a, b in zip(keep, after))
    moved = any(not torch.equal(a, p.data()) for a, p in
                zip(after, trainer._params))
    step = statistics.median(rec["walls"][1:FP16_FINITE])
    t12 = mha_times["non-causal float32"]
    print(f"  (c) MXNET_AMP=fp16, MultiHeadAttention (units {E}, {H} heads, "
          f"B={B} T={T}), Adam, L2Loss: loss scale per step {scales} "
          f"(init {FP16_INIT}, window {FP16_WINDOW}; step "
          f"{FP16_FINITE + 1} has an inf input); on it the "
          f"{len(trainer._params)} weights, the Adam states and the "
          f"applied-step counter held bitwise: {held}; the next finite step "
          f"moved the weights: {moved}; losses "
          f"{[round(v, 5) for v in rec['losses']]}")
    print(f"      step times {[round(w, 2) for w in rec['walls']]} ms, median"
          f" of steps 2-{FP16_FINITE} {step:.3f} ms beside phase 12's float32"
          f" forward and backward {t12['block_ms']:.3f} ms device, "
          f"{t12['block_host_ms']:.3f} ms host clock; captures "
          f"{stepper.captures}")
    grown = FP16_INIT * 2.0
    check(scales[FP16_WINDOW - 1] == grown and scales[FP16_FINITE - 1] ==
          grown, f"the scale did not grow to {grown} after {FP16_WINDOW} "
          f"finite steps: {scales}")
    check(scales[FP16_FINITE] == grown / 2, f"the inf step did not halve "
          f"the scale: {scales}")
    check(held, "the skipped step changed weights, Adam states or the "
          "applied-step counter")
    check(moved, "the finite step after the skip did not train")
    check(len(stepper.captures) == 1, f"captures {stepper.captures}")
    check_step_launches("(c) fp16 MultiHeadAttention", rec, "f32", 1)
    del block, trainer, stepper
    return counts, {"step_ms": step}


def phase_compressed(mx, start):
    """(d) (a)'s configuration with 2-bit compression (threshold 0.5) on a
    tpu_sync store that reduces: the whole step against the fused
    compressed path, COMP_STEPS steps, deterministic algorithms."""
    import gc
    import torch
    from mxnet_tpu_torch.gluon.wholestep import WholeStepCompiler
    batches = token_batches(mx, COMP_STEPS)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    runs = {}
    comp = {"type": "2bit", "threshold": 0.5}
    for whole in (False, True):
        gc.collect()
        torch.cuda.empty_cache()
        net = lm_fresh(mx, start, "bfloat16")
        trainer = lm_trainer(mx, net, compression=comp)
        stepper = WholeStepCompiler(net, loss_fn, trainer)
        rec = new_rec()
        reset_counts()
        with env_vars(MXNET_WHOLE_STEP=1 if whole else 0), deterministic():
            run_steps(stepper.step, batches, rec)
        rec["counts"] = read_counts()
        rec["weights"] = lm_weights(trainer)
        rec["residuals"] = [r.clone() for r in trainer._residuals]
        rec["buckets"] = trainer._bucketer
        if whole:
            check(stepper.active, f"whole step inactive: "
                  f"{stepper.fallback_reason}")
            rec["captures"] = stepper.captures
        runs[whole] = rec
        del net, trainer, stepper
    fused, whole = runs[False], runs[True]
    bw, wrel = tensors_diff(fused["weights"], whole["weights"])
    br, rrel = tensors_diff(fused["residuals"], whole["residuals"])
    bk = whole["buckets"]
    mib = [round(n * 2 / 2 ** 20, 1) for n in bk.sizes]
    check(len(whole["captures"]) == 1, f"(d) captures {whole['captures']}")
    print(f"  (d) 2-bit compression, threshold 0.5: {len(bk.sizes)} buckets"
          f" of {[len(b) for b in bk.layout]} gradients, {mib} MiB of bf16 "
          f"gradients each ({bk.cap / 2 ** 20:.0f} MiB cap), float32 "
          f"residuals of {list(bk.sizes)} elements; whole step against the "
          f"fused compressed path over {COMP_STEPS} steps: weights and "
          f"masters bitwise {bw}, residuals bitwise {br}; losses "
          f"{[round(v, 4) for v in whole['losses']]}; captures "
          f"{whole['captures']}")
    if not (bw and br):
        print(f"      not bitwise: weights within {wrel:.3e}, residuals "
              f"within {rrel:.3e} of each one's largest")
        check(wrel <= TOL_CAPTURED and rrel <= TOL_CAPTURED,
              "compressed whole step and fused path differ")
    check_step_launches("(d) compressed whole step", whole, "sm90",
                        CONFIG["num_layers"])
    return whole["counts"]


def phase_superstep(mx, start):
    """(f) SuperStepCompiler with K=4 on (a)'s configuration: SUPER_STEPS
    steps as 2 supersteps against as many sequential whole steps,
    deterministic algorithms."""
    import gc
    import torch
    from mxnet_tpu_torch.autotune import SuperStepCompiler
    batches = token_batches(mx, SUPER_STEPS)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    runs = {}
    for sup in (False, True):
        gc.collect()
        torch.cuda.empty_cache()
        net = lm_fresh(mx, start, "bfloat16")
        trainer = lm_trainer(mx, net)
        stepper = SuperStepCompiler(net, loss_fn, trainer, k=SUPER_K)
        rec = new_rec()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with env_vars(MXNET_WHOLE_STEP=1), deterministic():
            if sup:
                for i in range(0, SUPER_STEPS, SUPER_K):
                    group = batches[i:i + SUPER_K]
                    run_steps(lambda _x, _y, g=group: stepper.superstep(
                        [b[0] for b in g], [b[1] for b in g]),
                        [(None, None)], rec)
                rec["raw"] = [l for sup_l in rec["raw"] for l in sup_l]
            else:
                run_steps(stepper.step, batches, rec)
        rec["counts"] = read_counts()
        rec["peak"] = torch.cuda.max_memory_allocated()
        rec["weights"] = lm_weights(trainer)
        rec["captures"] = stepper.super_captures if sup else \
            stepper.captures
        rec["k"] = stepper.k
        if sup:
            # one more superstep, a replay only, for the time per step
            with env_vars(MXNET_WHOLE_STEP=1):
                group = batches[:SUPER_K]
                rec["replay_walls"] = run_steps(
                    lambda _x, _y: stepper.superstep(
                        [b[0] for b in group], [b[1] for b in group]),
                    [(None, None)], new_rec())["walls"]
            rec["replay_ms"] = stepper._super_graph.replay_host_ms
        runs[sup] = rec
        del net, trainer, stepper
    return runs


def phase_superstep_report(mx, runs):
    L = CONFIG["num_layers"]
    seq, sup = runs[False], runs[True]
    bw, wrel = tensors_diff(seq["weights"], sup["weights"])
    bl, lrel = tensors_diff(seq["raw"], sup["raw"])
    per_step = sup["replay_walls"][0] / SUPER_K
    print(f"  (f) SuperStepCompiler K={sup['k']}: {SUPER_STEPS} steps as 2 "
          f"supersteps (the first eager, the second captured and replayed): "
          f"times {[round(w, 1) for w in sup['walls']]} ms; a third "
          f"(replayed) {sup['replay_walls'][0]:.1f} ms, {per_step:.1f} ms a "
          f"step (the replay call {sup['replay_ms']:.3f} ms host) beside "
          f"{statistics.median(seq['walls'][1:]):.1f} ms for a whole step; "
          f"peak {sup['peak'] / 2 ** 30:.2f} GiB with {SUPER_K} staged "
          f"batches ({seq['peak'] / 2 ** 30:.2f} sequential); against "
          f"{SUPER_STEPS} sequential whole steps: losses bitwise {bl}, "
          f"weights and optimizer states bitwise {bw}; captures "
          f"{sup['captures']}")
    if not (bl and bw):
        print(f"      not bitwise: losses within {lrel:.3e}, weights within"
              f" {wrel:.3e} of each one's largest")
    want = 2 * SUPER_K * L      # the eager superstep and the capture
    c = sup["counts"]
    check(c["flash_attention.sm90"] == want and
          c["flash_attention.bwd.sm90"] == want and
          c["flash_attention.f32"] == 0 and c["flash_attention.bwd.f32"] == 0,
          f"superstep launches {c}; want {want} sm90 K1 and K1b (the eager "
          "superstep and the capture), none on f32")
    return (bw and bl) or max(wrel, lrel) <= TOL_CAPTURED, per_step


def phase_module_fused(mx, resident, lm_module):
    """(e) Module with MXNET_FUSED_STEP=1: bench.py's ResNet-50 through fit
    (3 epochs of 8 resident batches), resnet18_v1 fused against standard,
    and phase 11's LM leg."""
    import gc
    import numpy as np
    import torch
    L = CONFIG["num_layers"]
    gc.collect()
    torch.cuda.empty_cache()
    sym = resnet_symbol(mx, VISION_MODEL)
    n = VISION_BATCH * MODULE_BATCHES
    data, labels = module_data(mx, n)
    it = mx.io.NDArrayIter(data, labels, batch_size=VISION_BATCH)
    metric = DeviceNLL(mx)
    marks = []

    def epoch_end(epoch, sym_, arg, aux):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    with env_vars(MXNET_FUSED_STEP=1):
        mod = bind_resnet_module(mx, sym)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        marks.append(time.perf_counter())
        mod.fit(it, num_epoch=MODULE_EPOCHS, eval_metric=metric.metric,
                epoch_end_callback=epoch_end)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = metric.materialize()
    epochs = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    step = (marks[-1] - marks[1]) * 1e3 / (MODULE_BATCHES *
                                           (MODULE_EPOCHS - 1))
    final = float(np.mean(losses[-MODULE_BATCHES:]))
    graph = mod._fstep_graph
    fit_replay_ms = graph.replay_host_ms
    batch = next(iter(it))
    torch.cuda.synchronize()
    with env_vars(MXNET_FUSED_STEP=1):
        mod.forward_backward(batch)     # one more replay, on an idle card
        mod.update()
    torch.cuda.synchronize()
    print(f"  (e) ResNet-50 v1 Module.fit with MXNET_FUSED_STEP=1 (B="
          f"{VISION_BATCH}, bf16, f32 masters, tpu_sync): epochs "
          f"{[round(e, 1) for e in epochs]} ms; {step:.1f} ms a step over "
          f"the timed epochs, {VISION_BATCH / step * 1e3:.1f} images/s, "
          f"beside phase 11's standard step {resident['step_ms']:.1f} ms, "
          f"{resident['images_s']:.1f} images/s; peak "
          f"{peak / 2 ** 30:.2f} GiB (phase 11 {resident['peak_gib']:.2f});"
          f" the replay call's host time {graph.replay_host_ms:.3f} ms on "
          f"an idle card, {fit_replay_ms:.3f} ms for the last one in fit "
          f"(no synchronisation between steps); captures "
          f"{graph.captures}, {graph.replays - 1} replays in fit")
    print(f"      NLL per batch {[round(v, 4) for v in losses]}")
    check(np.isfinite(losses).all(), f"fused Module losses not finite")
    check(final < max(losses[0] * 1.2, np.log(1000.0) + 0.5),
          f"bench.py's loss check failed: final {final:.4f}, first "
          f"{losses[0]:.4f}")
    check(len(graph.captures) == 1 and graph.replays ==
          MODULE_EPOCHS * MODULE_BATCHES, f"want 1 capture and "
          f"{MODULE_EPOCHS * MODULE_BATCHES - 1} replays, got "
          f"{graph.captures}, {graph.replays}")
    check(not any(counts.values()), f"the vision path launched a kernel "
          f"of the repo: {counts}")
    out = {"step_ms": step, "images_s": VISION_BATCH / step * 1e3,
           "peak_gib": peak / 2 ** 30}
    del mod, it, data, labels
    gc.collect()
    torch.cuda.empty_cache()

    # resnet18_v1 f32: fused against standard from the same weights
    rs = np.random.RandomState(3)
    xs = rs.normal(size=GRAD_VISION_SHAPE).astype(np.float32)
    ys = rs.randint(0, 1000, GRAD_VISION_SHAPE[0]).astype(np.float32)
    ctx = mx.gpu(0)
    mx.random.seed(0)
    net = mx.gluon.model_zoo.vision.resnet18_v1()
    net.initialize(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                  magnitude=2), ctx=ctx)
    x, y = mx.nd.array(xs, ctx=ctx), mx.nd.array(ys, ctx=ctx)
    net(x)
    startw = {p.name: p.data().detach().clone()
              for p in net.collect_params().values()}
    sym18 = mx.sym.SoftmaxOutput(net(mx.sym.var("data")), name="softmax")
    aux_names = set(sym18.list_auxiliary_states())
    got = {}
    for fused in (False, True):
        mod = mx.mod.Module(sym18, context=ctx)
        mod.bind([("data", GRAD_VISION_SHAPE)],
                 [("softmax_label", (GRAD_VISION_SHAPE[0],))])
        mod.init_params(arg_params={n_: t for n_, t in startw.items()
                                    if n_ not in aux_names},
                        aux_params={n_: t for n_, t in startw.items()
                                    if n_ in aux_names})
        mod.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": 0.1, "momentum": 0.9})
        with env_vars(MXNET_FUSED_STEP=1 if fused else 0), deterministic():
            for _ in range(FUSED_VS_STD_STEPS):
                mod.forward_backward(mx.io.DataBatch([x], [y]))
                mod.update()
        arg, aux = mod.get_params()
        got[fused] = {n_: t.detach().clone()
                      for n_, t in list(arg.items()) + list(aux.items())}
        if fused:
            check(len(mod._fstep_graph.captures) == 1, "resnet18 fused "
                  f"captures {mod._fstep_graph.captures}")
        del mod
    names = sorted(startw)
    pn = [n_ for n_ in names if n_ not in aux_names]
    an = [n_ for n_ in names if n_ in aux_names]
    bp, _ = tensors_diff([got[False][n_] for n_ in pn],
                         [got[True][n_] for n_ in pn])
    ba, arel = tensors_diff([got[False][n_] for n_ in an],
                            [got[True][n_] for n_ in an])
    prel = moved_diff([startw[n_] for n_ in pn], [got[False][n_] for n_ in pn],
                      [got[True][n_] for n_ in pn])
    print(f"      resnet18_v1 f32 B={GRAD_VISION_SHAPE[0]}: "
          f"{FUSED_VS_STD_STEPS} fused steps (eager, captured, replayed) "
          f"against as many standard steps from the same weights: "
          f"{len(pn)} parameters bitwise {bp}, {len(an)} moving statistics "
          f"bitwise {ba}" + ("" if bp and ba else
                             f"; within {prel:.3e} of each parameter's "
                             f"largest change, statistics {arel:.3e}"))
    check((bp or prel <= TOL_CAPTURED) and (ba or arel <= TOL_CAPTURED),
          "fused and standard Module steps differ")
    del net
    gc.collect()
    torch.cuda.empty_cache()

    # phase 11's LM leg with MXNET_FUSED_STEP=1
    from mxnet_tpu_torch.gluon.model_zoo.transformer import TransformerLM
    B, T = TRAIN_BATCH, CONFIG["max_len"]
    mx.random.seed(0)
    lm = TransformerLM(**CONFIG, attn_type="flash")
    lm.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    lm(mx.nd.array(np.zeros((1, 8), np.float32), ctx=mx.gpu(0)))
    lm.cast("bfloat16")
    lsym = mx.sym.SoftmaxOutput(lm(mx.sym.var("data")), preserve_shape=True,
                                normalization="valid", name="softmax")
    weights = {p.name: p.data() for p in lm.collect_params().values()}
    mod = mx.mod.Module(lsym, context=mx.gpu(0))
    mod.bind([mx.io.DataDesc("data", (B, T), np.float32)],
             [mx.io.DataDesc("softmax_label", (B, T), np.float32)])
    mod.init_params(arg_params=weights)
    del lm, weights
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": LM_MODULE_LR, "momentum": 0.9,
        "multi_precision": True})
    toks = np.random.RandomState(0).randint(0, CONFIG["vocab"], (B, T + 1))
    batch = mx.io.DataBatch(
        [mx.nd.array(toks[:, :-1].astype(np.float32), ctx=mx.gpu(0))],
        [mx.nd.array(toks[:, 1:].astype(np.float32), ctx=mx.gpu(0))])
    nll = DeviceNLL(mx)
    rec = new_rec()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()

    def lm_step(_x, _y):
        mod.forward_backward(batch)
        mod.update()
        mod.update_metric(nll.metric, batch.label)
        return torch.zeros(())

    with env_vars(MXNET_FUSED_STEP=1):
        run_steps(lm_step, [(None, None)] * FUSED_LM_STEPS, rec)
    lcounts = read_counts()
    mod.forward(batch, is_train=False)
    mod.update_metric(nll.metric, batch.label)
    nlls = nll.materialize()
    lpeak = torch.cuda.max_memory_allocated()
    lstep = statistics.median(rec["walls"][2:])
    print(f"      LM Module leg with MXNET_FUSED_STEP=1, bf16 B={B} T={T}: "
          f"NLL {nlls} (the last after {FUSED_LM_STEPS} updates; phase "
          f"11's {[round(v, 6) for v in lm_module['losses']]} after "
          f"{LM_MODULE_STEPS}); step times "
          f"{[round(w, 1) for w in rec['walls']]} ms (eager, captured, "
          f"replays), the replays' median {lstep:.1f} ms beside phase 11's "
          f"{lm_module['step_ms']:.1f} ms; "
          f"peak {lpeak / 2 ** 30:.2f} GiB (phase 11 "
          f"{lm_module['peak_gib']:.2f}); captures "
          f"{mod._fstep_graph.captures}")
    check(np.isfinite(nlls).all() and nlls[-1] < nlls[0],
          f"fused Module LM NLL not finite and falling: {nlls}")
    check_step_launches("(e) fused Module LM", rec, "sm90", L)
    del mod, batch
    out.update(lm_step_ms=lstep, lm_peak_gib=lpeak / 2 ** 30)
    return lcounts, out


def phase_onestep(mx, gluon, resident, lm_module, mha_times):
    """Phase 15: (a)-(f); returns the flash launches of its runs, summed by
    kernel, and the times."""
    import torch
    t0 = time.perf_counter()
    start = lm_start(mx)
    print(f"  LM start weights (seed 0, Xavier) in "
          f"{time.perf_counter() - t0:.1f} s; PyTorch {torch.__version__}, "
          "CUDAGraph.register_generator_state "
          f"{hasattr(torch.cuda.CUDAGraph, 'register_generator_state')}")
    totals = {}

    def add(c):
        for k, v in c.items():
            totals[k] = totals.get(k, 0) + v

    ca, whole = phase_wholestep(mx, start, gluon)
    add(ca)
    phase_dropout_replay(mx)
    cb, amp = phase_amp_bf16(mx, start)
    add(cb)
    cc, fp16 = phase_amp_fp16(mx, mha_times)
    add(cc)
    add(phase_compressed(mx, start))
    runs = phase_superstep(mx, start)
    del start
    same, per_step = phase_superstep_report(mx, runs)
    add(runs[True]["counts"])
    check(same, "the superstep differs from the sequential steps")
    check(len(runs[True]["captures"]) == 1, f"superstep captures "
          f"{runs[True]['captures']}")
    del runs
    ce, module = phase_module_fused(mx, resident, lm_module)
    add(ce)
    print(f"  one-program step times: LM whole step {whole['step_ms']:.1f} "
          f"ms (fused path {whole['fused_ms']:.1f}, phase 9 "
          f"{gluon['step_ms']:.1f}); superstep {per_step:.1f} ms a step; "
          f"ResNet-50 fused Module step {module['step_ms']:.1f} ms (phase "
          f"11 {resident['step_ms']:.1f}); LM fused Module step "
          f"{module['lm_step_ms']:.1f} ms (phase 11 "
          f"{lm_module['step_ms']:.1f}); MXNET_AMP=bf16 LM "
          f"{amp['step_ms']:.1f} ms; fp16 MultiHeadAttention "
          f"{fp16['step_ms']:.3f} ms")
    return totals


# ---------------------------------------------------------------------------
# phase 16: observability and training resilience
# ---------------------------------------------------------------------------
SUP_STEPS = 8           # (a): supervised whole steps, snapshots every 2
SUP_SNAPSHOT_STEPS = 2
SUP_FAULT_AT = 5        # the trainer.step raise fires at step 5 (from 0)
COST_PAIRS = 6          # (b): paired supervised/bare (and on/off) steps
COST_SNAPSHOT_STEPS = 50  # MXNET_SUPERVISE_SNAPSHOT_STEPS' default
MLP_WIDTH = 1024        # (c), (d): the small float32 MLP on the card
MLP_BATCH = 256
DIVERGE_PATIENCE = 2
STALL_FACTOR = 5.0      # (c): the deadline, x the step EWMA
STALL_DELAY_X = 20.0    # the injected delay, x the step EWMA
ATTRIBUTION_FLOOR = 90.0  # (d): bench.py's memory-rider acceptance, %
PROFILE_TRIES = 3       # (f): torch.profiler sessions before failing
MODULE_SUP_STEPS = 3    # (g): phase 11's LM Module leg
PREFETCH_DEPTH = 2      # (h)


def observed():
    """The phase's instruments: the flight recorder, the memory ledger,
    goodput and the run journal on, their files in a temporary directory
    under ``build/``, post-mortems not rate-limited; returns the
    directory's TemporaryDirectory."""
    from mxnet_tpu_torch import resilience
    from mxnet_tpu_torch.observability import (flight, goodput, journal,
                                               memory)
    tmp = tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build"))
    os.environ["MXNET_FLIGHT_DIR"] = os.path.join(tmp.name, "flight")
    flight.enable()
    flight.reset()
    memory.enable()
    memory.configure(budget_mb=0.0, oom_dump_min_s=0.0)
    goodput.enable()
    goodput.reset()
    journal.configure(run_dir=os.path.join(tmp.name, "run"))
    journal.MILESTONE_EVERY = 2
    resilience.POST_MORTEM_MIN_S = 0.0
    resilience.reset()
    return tmp


def supervised_lm_run(mx, start, batches, supervised):
    """SUP_STEPS whole steps of phase 9's LM (bf16, float32 masters, SGD
    momentum 0.9) under deterministic algorithms; ``supervised``: through
    a TrainingSupervisor (snapshots every SUP_SNAPSHOT_STEPS) with a
    trainer.step raise at step SUP_FAULT_AT.  Returns the run's record and
    (net, trainer, stepper, supervisor) for the later checks."""
    import gc
    import torch
    from mxnet_tpu_torch import faultinject as fi
    from mxnet_tpu_torch.gluon.supervisor import TrainingSupervisor
    from mxnet_tpu_torch.gluon.wholestep import WholeStepCompiler
    from mxnet_tpu_torch.observability import goodput
    gc.collect()
    torch.cuda.empty_cache()
    net = lm_fresh(mx, start, "bfloat16")
    trainer = lm_trainer(mx, net)
    stepper = WholeStepCompiler(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                                trainer)
    sup = None
    fn = stepper.step
    plan = fi.FaultPlan()
    if supervised:
        sup = TrainingSupervisor(stepper.step, trainer=trainer, params=net,
                                 snapshot_steps=SUP_SNAPSHOT_STEPS)
        fn = sup.step
        plan.add("trainer.step", "raise", exc=OSError, times=1,
                 after=SUP_FAULT_AT)
    rec = new_rec()
    goodput.reset()
    goodput.start()
    torch.cuda.synchronize()
    reset_counts()
    with env_vars(MXNET_WHOLE_STEP=1), deterministic(), fi.active(plan):
        run_steps(fn, batches, rec)
    rec["goodput"] = goodput.report()
    rec["fired"] = plan.stats()
    rec["weights"] = lm_weights(trainer)
    rec["captures"] = stepper.captures
    rec["capture_s"] = list(stepper._graph.capture_seconds)
    check(stepper.active, f"whole step inactive: {stepper.fallback_reason}")
    return rec, (net, trainer, stepper, sup)


def paired_ms(fn_a, fn_b, x, y, pairs=COST_PAIRS):
    """Per-step paired interleave (``bench.py``'s chaos-rider method): the
    two arms alternate, each step synchronized; the medians of each arm
    and of the adjacent-pair differences, ms."""
    import torch
    a_t, b_t, deltas = [], [], []
    for i in range(pairs):
        order = ((fn_a, a_t), (fn_b, b_t)) if i % 2 == 0 else \
            ((fn_b, b_t), (fn_a, a_t))
        for fn, acc in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(x, y)
            torch.cuda.synchronize()
            acc.append((time.perf_counter() - t0) * 1e3)
        deltas.append(a_t[-1] - b_t[-1])
    return (statistics.median(a_t), statistics.median(b_t),
            statistics.median(deltas))


def phase_cost(mx, stepper, sup, batches):
    """(b) what the instruments cost a replayed LM step: supervised
    against bare, the snapshot's own time and its share amortized over
    COST_SNAPSHOT_STEPS steps; then the flight recorder, the memory ledger
    and goodput each on against off."""
    import torch
    from mxnet_tpu_torch.observability import flight, goodput, memory
    x, y = batches[0]
    # no snapshot boundary inside the interleave: the default cadence
    sup.snapshot_steps = COST_SNAPSHOT_STEPS
    with env_vars(MXNET_WHOLE_STEP=1):
        sup_ms, bare_ms, d = paired_ms(sup.step, stepper.step, x, y)
        # the snapshot alone: its call and the copies landing
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sup._snap = None            # force the next boundary
        sup._maybe_snapshot()
        call_ms = sup.snapshot_seconds[-1] * 1e3
        torch.cuda.synchronize()
        snap_ms = (time.perf_counter() - t0) * 1e3
        nbytes = sup._snap.nbytes
        amort = snap_ms / COST_SNAPSHOT_STEPS
        print(f"  (b) supervised against bare replayed steps ({COST_PAIRS} "
              f"pairs, interleaved): {sup_ms:.2f} against {bare_ms:.2f} ms, "
              f"median pair difference {d:.3f} ms ({100 * d / bare_ms:.2f} "
              f"%); one snapshot of {nbytes / 2 ** 30:.3f} GiB into pinned "
              f"host buffers: {snap_ms:.1f} ms to land ({call_ms:.1f} ms "
              f"host call, {nbytes / snap_ms / 1e6:.1f} GB/s), "
              f"{amort:.3f} ms a step amortized over {COST_SNAPSHOT_STEPS}"
              f" steps ({100 * amort / bare_ms:.2f} %)")
        costs = {"supervisor_ms": d, "supervisor_pct": 100 * d / bare_ms,
                 "snapshot_ms": snap_ms, "snapshot_gib": nbytes / 2 ** 30,
                 "snapshot_amortized_pct": 100 * amort / bare_ms}
        for name, mod in (("flight recorder", flight),
                          ("memory ledger", memory),
                          ("goodput", goodput)):
            def off(x, y, mod=mod):
                mod.ENABLED = False
                try:
                    return stepper.step(x, y)
                finally:
                    mod.ENABLED = True
            on_ms, off_ms, d = paired_ms(stepper.step, off, x, y)
            print(f"      {name} on against off: {on_ms:.2f} against "
                  f"{off_ms:.2f} ms, median pair difference {d:.3f} ms "
                  f"({100 * d / off_ms:.2f} %)")
            costs[name] = 100 * d / off_ms
    return costs


def phase_retry(mx, start, batches):
    """(a) the supervised retry against an uninterrupted run, bitwise;
    (d)'s per-tag bytes over the LM; (f)'s goodput account.  Returns the
    supervised run's objects for (b), (d)-(f)."""
    from mxnet_tpu_torch.observability import memory
    L = CONFIG["num_layers"]
    ref, objs = supervised_lm_run(mx, start, batches, False)
    ref_losses, ref_weights = ref["raw"], ref["weights"]
    replayed_ms = statistics.median(ref["walls"][2:])
    del objs, ref
    got, objs = supervised_lm_run(mx, start, batches, True)
    net, trainer, stepper, sup = objs
    bit_l, _ = tensors_diff(ref_losses, got["raw"])
    bit_w, rel = tensors_diff(ref_weights, got["weights"])
    del ref_weights
    st = sup.stats()
    fail_ms = got["walls"][SUP_FAULT_AT]
    gp = got["goodput"]
    cls = gp["classes"]
    replay_s = cls.get("retry_replay", {}).get("seconds", 0.0)
    recompile_s = cls.get("recompile", {}).get("seconds", 0.0)
    print(f"  (a) {SUP_STEPS} supervised whole steps (snapshots every "
          f"{SUP_SNAPSHOT_STEPS}), a trainer.step raise at step "
          f"{SUP_FAULT_AT}: fired {got['fired']}; losses "
          f"{[round(v, 4) for v in got['losses']]}; against "
          f"{SUP_STEPS} uninterrupted steps: losses bitwise {bit_l}, "
          f"{len(got['weights'])} weights and optimizer states bitwise "
          f"{bit_w}")
    print(f"      the recovering step took {fail_ms:.1f} ms (the restore's "
          f"host call {sup.restore_seconds[-1] * 1e3:.1f} ms, in place: "
          f"{sup.last_restore}; the replay of "
          f"{SUP_FAULT_AT % SUP_SNAPSHOT_STEPS} step(s); the retry; a "
          f"{sup.backoff_s * 1e3:.0f} ms backoff) against an uninterrupted "
          f"replayed step's {replayed_ms:.1f} ms, so the recovery itself (less the backoff "
          f"and the retried step) {fail_ms - sup.backoff_s * 1e3 - replayed_ms:.1f}"
          f" ms; supervisor {st}; captures {got['captures']}")
    check(got["fired"] == {"trainer.step": 1}, f"fault plan {got['fired']}")
    check(bit_l and bit_w, f"the retried run differs from the "
          f"uninterrupted one (weights within {rel:.3e})")
    check(len(got["captures"]) == 1, f"the retried run captured "
          f"{got['captures']}; a retry should capture nothing")
    check(sup.last_restore is not None and sup.last_restore["in_place"],
          f"the restore was not in place: {sup.last_restore}")
    check_step_launches("(a) supervised whole step", got, "sm90", L)
    # (f) the goodput account of this run
    print(f"  (f) goodput of (a)'s run: {gp['goodput_pct']:.2f} % compute "
          f"over {gp['wall_s']:.3f} s; retry_replay {replay_s:.4f} s (the "
          f"recovery, less the backoff and the retried step, "
          f"{(fail_ms - sup.backoff_s * 1e3 - replayed_ms) / 1e3:.4f} s); "
          f"recompile {recompile_s:.4f} s (the captures "
          f"{sum(got['capture_s']):.4f} s); unattributed "
          f"{gp['unattributed_pct']:.2f} % (a replay's compute is the "
          "card's time of it, from the introspector's CUDA events); classes "
          + ", ".join(f"{c} {b['seconds']:.4f} s" for c, b in
                      sorted(cls.items())))
    check(abs(recompile_s - sum(got["capture_s"])) < 1e-9,
          "goodput's recompile is not the capture time")
    check(sup.restore_seconds[-1] <= replay_s <= fail_ms / 1e3,
          f"retry_replay {replay_s} s outside [restore, recovering step]")
    # (d) the ledger over the LM
    rep = memory.report()
    dev = rep["device"]
    alloc = __import__("torch").cuda.memory_allocated()
    print(f"  (d) memory ledger after the LM's steps, live bytes by tag: "
          + ", ".join(f"{t} {v['live_bytes'] / 2 ** 30:.3f} GiB "
                      f"({v['buffers']} tensors)"
                      for t, v in sorted(dev["tags"].items()))
          + f"; untagged {dev['untagged_bytes'] / 2 ** 30:.3f} GiB; "
          f"tracked {dev['total_bytes'] / 2 ** 30:.3f} GiB beside "
          f"torch.cuda.memory_allocated() {alloc / 2 ** 30:.3f} GiB; "
          f"{dev['attribution_pct']:.2f} % tagged; the capture's pool "
          f"{rep['compiled']}")
    check(dev["attribution_pct"] >= ATTRIBUTION_FLOOR,
          f"{dev['attribution_pct']} % of tracked bytes tagged, under "
          f"{ATTRIBUTION_FLOOR}")
    return got, objs


def profile_replays(mx, stepper, batches, path, want):
    """(f) two replayed steps under ``profiler`` (a torch.profiler session
    with the spans merged), up to PROFILE_TRIES sessions until CUPTI
    records device events and a record of each of the ``want`` launches
    of every flash kernel (CUPTI may drop records of a session): the
    dumped trace, its events, and the session's number."""
    import torch
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.observability import flight
    for attempt in range(1, PROFILE_TRIES + 1):
        flight.reset()
        profiler.set_config(filename=path)
        profiler.set_state("run")
        with env_vars(MXNET_WHOLE_STEP=1):
            for x, y in batches[:2]:
                stepper.step(x, y)
        torch.cuda.synchronize()
        profiler.dump_profile()
        if not profiler.device_event_count():
            print(f"      profiler session {attempt}: no device events")
            continue
        with open(path) as f:
            total = kernels_in_spans(json.load(f)["traceEvents"])[1]
        if all(v >= want for v in total.values()):
            break
        print(f"      profiler session {attempt}: records of {total} flash "
              f"kernel launches, {want} of each launched")
    with open(path) as f:
        trace = json.load(f)
    check(isinstance(trace.get("traceEvents"), list),
          "the profiler's dump is not a Chrome trace")
    evs = trace["traceEvents"]
    check(profiler.device_event_count() > 0, f"torch.profiler recorded no "
          f"device events in {PROFILE_TRIES} sessions")
    return trace, evs, attempt


def kernels_in_spans(evs, span="whole_step"):
    """Flash kernel launches inside ``span``: a kernel counts when the
    CUDA runtime call it correlates with (the graph launch of a replay)
    starts inside a host ``span`` range of the profiler's trace."""
    spans = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in evs
             if e.get("name") == span and e.get("ph") == "X"
             and e.get("cat") in ("user_annotation", "cpu_op")]
    runtime = {}
    for e in evs:
        c = (e.get("args") or {}).get("correlation")
        if c is not None and e.get("cat") in ("cuda_runtime",
                                              "cuda_driver"):
            runtime[c] = e["ts"]
    names = {"K1": ("flash_attention_fwd",), "K1b dK/dV": ("dkdv_kernel",),
             "K1b dQ": ("dq_kernel",)}
    got = dict.fromkeys(names, 0)
    total = dict.fromkeys(names, 0)
    for e in evs:
        if e.get("cat") != "kernel":
            continue
        for g, keys in names.items():
            if any(k in e.get("name", "") for k in keys):
                total[g] += 1
                t = runtime.get((e.get("args") or {}).get("correlation"))
                if t is not None and any(a <= t <= b for a, b in spans):
                    got[g] += 1
    return got, total, len(spans)


def phase_traces(mx, objs, batches, tmp):
    """(e) a replayed whole step inside ``analysis.no_sync()``; (f) the
    profiler's and the flight recorder's Chrome traces over two replayed
    steps, and the journal read back by ``report``."""
    import torch
    from mxnet_tpu_torch import analysis
    from mxnet_tpu_torch.observability import flight, journal, report
    L = CONFIG["num_layers"]
    net, trainer, stepper, sup = objs
    x, y = batches[1]
    with env_vars(MXNET_WHOLE_STEP=1), analysis.sanitized():
        v0 = analysis.sanitizer.state()["sync_violations"]
        with analysis.no_sync("a replayed whole step"):
            loss = stepper.step(x, y)
        v1 = analysis.sanitizer.state()["sync_violations"]
        armed = False
        try:
            with analysis.no_sync("the control"):
                mx.nd.asnumpy(loss)
        except analysis.SyncViolation:
            armed = True
    print(f"  (e) a replayed whole step inside analysis.no_sync() under "
          f"MXNET_SANITIZE: {v1 - v0} sync violations; nd.asnumpy of its "
          f"loss in the same region raises SyncViolation: {armed}")
    check(v1 == v0 and armed, "no_sync: a replay synced, or the region "
          "was not armed")
    path = os.path.join(tmp, "profile.json")
    trace, evs, tries = profile_replays(mx, stepper, batches, path, 2 * L)
    inside, total, nspans = kernels_in_spans(evs)
    host = sum(1 for e in evs if e.get("name") == "whole_step")
    kern = sum(1 for e in evs if e.get("cat") == "kernel")
    print(f"  (f) profiler.dump_profile() over 2 replayed steps (session "
          f"{tries}): {len(evs)} events, {host} whole_step host spans "
          f"({nspans} from torch.profiler), {kern} kernels on one "
          f"timeline; flash kernels inside whole_step spans {inside} of "
          f"{total}")
    check(all(v == 2 * L for v in inside.values()) and
          all(v == 2 * L for v in total.values()),
          f"flash kernels in the profiled replays {total}, inside "
          f"whole_step spans {inside}; want {2 * L} of each")
    fpath = flight.dump(os.path.join(tmp, "flight.json"))
    with open(fpath) as f:
        ftrace = json.load(f)
    fevs = ftrace["traceEvents"]
    steps = [e for e in fevs if e.get("name") == "whole_step"
             and e.get("cat") == "step"]
    check(isinstance(fevs, list) and len(steps) == 2 and all(
        "ph" in e and ("ts" in e or e["ph"] == "M") for e in fevs),
        f"flight dump: {len(steps)} whole_step records")
    fk = sum(1 for e in fevs if e.get("cat") == "kernel")
    print(f"      flight.dump(): {len(fevs)} events, the 2 whole_step "
          f"records (step ids {[e['args'].get('step') for e in steps]}) "
          f"and the session's {fk} kernels merged; flight summary "
          f"whole_step {flight.summary().get('whole_step', {}).get('p50_ms')}"
          " ms p50 (the host's replay call)")
    s = report.summarize_run(journal.RUN_DIR)
    print(f"      report.summarize_run: run {s['run_id']}, "
          f"{s['incarnations']} incarnation, {s['entries']} entries, "
          f"events {s['event_counts']}, last step {s['last_step']}")
    check(s["incarnations"] == 1 and s["event_counts"].get(
        "supervisor_retry") == 1 and s["event_counts"].get("milestone"),
        f"the journal read back: {s['event_counts']}")


def phase_oom_budget(mx, stepper, batches):
    """(d) a real CUDA out-of-memory error inside ``oom_guard`` re-raised
    as DeviceMemoryError with a post-mortem, the next LM step running;
    MXNET_HBM_BUDGET_MB below the tracked bytes raising HBMBudgetError."""
    import torch
    from mxnet_tpu_torch.observability import memory
    free, total = torch.cuda.mem_get_info()
    # more than the card holds: the allocator cannot free its cache into it
    want = total + (1 << 30)
    err = None
    try:
        with memory.oom_guard("phase16.allocate"):
            torch.empty(want, dtype=torch.uint8, device="cuda")
    except memory.DeviceMemoryError as e:
        err = e
    path = memory.wait_oom_dump(30.0)
    check(err is not None and type(err.__cause__).__name__ ==
          "OutOfMemoryError" and path and os.path.exists(path),
          f"a real CUDA OOM gave {err!r}, post-mortem {path}")
    with open(path) as f:
        pm = json.load(f)
    x, y = batches[2]
    with env_vars(MXNET_WHOLE_STEP=1):
        loss = stepper.step(x, y)
    fin = bool(torch.isfinite(loss).all())
    print(f"  (d) allocating {want / 2 ** 30:.2f} GiB ({free / 2 ** 30:.2f} "
          f"GiB free of {total / 2 ** 30:.2f}) inside oom_guard: "
          f"{type(err).__name__} from {type(err.__cause__).__name__}; "
          f"post-mortem {os.path.basename(path)} (top tag "
          f"{pm['report']['top'][0]['tag'] if pm['report']['top'] else None}"
          f", flight dump {bool(memory.last_oom().get('flight_path'))}); "
          f"the next LM step's loss finite: {fin}")
    check(fin, "the LM step after the OOM is not finite")
    tracked = memory.tracked_bytes()
    budget_mb = tracked / 2 ** 20 / 2
    raised = None
    with env_vars(MXNET_HBM_BUDGET_MB=f"{budget_mb:.3f}"):
        memory.configure()
        try:
            memory.register(torch.empty(1024, device="cuda"), tag="data")
        except memory.HBMBudgetError as e:
            raised = e
        finally:
            os.environ.pop("MXNET_HBM_BUDGET_MB", None)
            memory.configure(budget_mb=0.0)
    print(f"      MXNET_HBM_BUDGET_MB={budget_mb:.1f} below the "
          f"{tracked / 2 ** 20:.1f} MB tracked: the next registration "
          f"raises {type(raised).__name__}: {str(raised)[:100]}")
    check(raised is not None, "the budget below the live bytes raised "
          "nothing")


def mlp(mx, seed=0):
    """(c)'s float32 MLP on the card: 3 Dense layers of MLP_WIDTH."""
    mx.random.seed(seed)
    net = mx.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(MLP_WIDTH, activation="relu",
                                  in_units=MLP_WIDTH))
        net.add(mx.gluon.nn.Dense(MLP_WIDTH, activation="relu",
                                  in_units=MLP_WIDTH))
        net.add(mx.gluon.nn.Dense(1, in_units=MLP_WIDTH))
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    net.hybridize()
    return net


def mlp_step(mx, net, momentum=0.9):
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.01, "momentum": momentum})
    loss = mx.gluon.loss.L2Loss()

    def step(x, y):
        with mx.autograd.record():
            l = loss(net(x), y)
        l.backward()
        tr.step(x.shape[0])
        return l
    return step, tr


def mlp_data(mx, n, nan=False, seed=0):
    import numpy as np
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        x = rs.normal(0, 1, (MLP_BATCH, MLP_WIDTH)).astype(np.float32)
        if nan:
            x[0, 0] = np.nan
        out.append((mx.nd.array(x, ctx=mx.gpu(0)), mx.nd.array(
            rs.normal(0, 1, (MLP_BATCH, 1)).astype(np.float32),
            ctx=mx.gpu(0))))
    return out


def phase_watchdogs(mx):
    """(c) divergence (raise, rewind) and the stall watchdog on the MLP;
    (d) a superstep demoted by a headroom refusal."""
    import torch
    from mxnet_tpu_torch import faultinject as fi
    from mxnet_tpu_torch import resilience as res
    from mxnet_tpu_torch.autotune import SuperStepCompiler
    from mxnet_tpu_torch.gluon.supervisor import TrainingSupervisor
    from mxnet_tpu_torch.gluon.wholestep import WholeStepCompiler
    from mxnet_tpu_torch.observability import flight, memory
    flight.reset()      # the LM's step EWMAs must not set the MLP's deadline
    clean = mlp_data(mx, 8)
    nan = mlp_data(mx, 2, nan=True, seed=1)
    # raise
    net = mlp(mx)
    step, tr = mlp_step(mx, net)
    sup = TrainingSupervisor(step, trainer=tr, params=net,
                             diverge_patience=DIVERGE_PATIENCE,
                             snapshot_steps=2)
    err = None
    try:
        for x, y in clean[:2] + nan:
            sup.step(x, y)
    except res.DivergenceError as e:
        err = e
    rep = (err.report or {}) if err else {}
    pm = {}
    if rep.get("report_path"):
        with open(rep["report_path"]) as f:
            pm = json.load(f)
    check(err is not None and err.step == 3 and "memory" in pm and
          rep.get("flight_path") and os.path.exists(rep["flight_path"]),
          f"divergence raise: {err!r}, post-mortem {rep}")
    sup.close()
    # rewind: the step-2 snapshot restored bitwise
    net = mlp(mx)
    step, tr = mlp_step(mx, net)
    sup = TrainingSupervisor(step, trainer=tr, params=net,
                             diverge_patience=DIVERGE_PATIENCE,
                             on_diverge="rewind", snapshot_steps=2)
    for x, y in clean[:2]:
        sup.step(x, y)
    at_snap = [p.data().detach().clone()
               for p in net.collect_params().values()]
    for x, y in nan:
        sup.step(x, y)
    bit, _ = tensors_diff(at_snap, [p.data().detach() for p in
                                    net.collect_params().values()])
    print(f"  (c) divergence (patience {DIVERGE_PATIENCE}, f32 MLP of "
          f"{MLP_WIDTH}): raise gives {type(err).__name__} at step "
          f"{err.step} with a post-mortem ({os.path.basename(rep['report_path'])}"
          f", ledger report and flight ring); rewind restores the step-2 "
          f"snapshot bitwise: {bit} ({sup.last_restore})")
    check(bit, "the rewind did not restore the snapshot bitwise")
    sup.close()
    # stall: a delay of STALL_DELAY_X x the EWMA against a deadline of
    # STALL_FACTOR x it
    net = mlp(mx)
    step, tr = mlp_step(mx, net)
    sup = TrainingSupervisor(step, trainer=tr, params=net,
                             stall_factor=STALL_FACTOR, stall_min_s=0.0)
    for x, y in clean[:5]:          # the EWMA's warm-up: no deadline yet
        sup.step(x, y)
        torch.cuda.synchronize()
    ewma = sup._ewma
    delay = STALL_DELAY_X * ewma
    deadline = sup._stall_timeout()
    plan = fi.FaultPlan().add("trainer.step", "delay", delay_s=delay,
                              times=1)
    serr = None
    t_wall = time.time()
    t0 = time.perf_counter()
    with fi.active(plan):
        try:
            sup.step(*clean[5])
        except res.TrainingStalledError as e:
            serr = e
    waited = time.perf_counter() - t0
    time.sleep(delay + 0.2)     # the delayed step finishes on the worker
    torch.cuda.synchronize()
    # the watchdog's trip: the post-mortem's own timestamp (writing it, the
    # ledger report and the flight dump, comes after)
    tripped = None
    if serr is not None and serr.report.get("report_path"):
        with open(serr.report["report_path"]) as f:
            tripped = json.load(f)["time"] - t_wall
    print(f"      stall: step EWMA {ewma * 1e3:.2f} ms, a trainer.step "
          f"delay of {delay * 1e3:.1f} ms against a deadline of "
          f"{deadline * 1e3:.1f} ms: the watchdog tripped after "
          f"{tripped * 1e3 if tripped is not None else float('nan'):.1f} "
          f"ms, {type(serr).__name__} raised after {waited * 1e3:.1f} ms "
          f"(with the post-mortem written; step "
          f"{getattr(serr, 'step', None)})")
    check(serr is not None and tripped is not None and tripped < delay,
          f"stall: {serr!r}, the watchdog tripped after {tripped} s, the "
          f"delay {delay:.3f} s")
    # (d) the headroom ask: a superstep of 4 demoted to 4 whole steps
    losses = {}
    for refused in (False, True):
        net = mlp(mx)
        tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.01})
        stepper = SuperStepCompiler(net, mx.gluon.loss.L2Loss(), tr, k=4)
        xs = [x for x, _ in clean[:4]]
        ys = [y for _, y in clean[:4]]
        with env_vars(MXNET_WHOLE_STEP=1):
            if refused:
                need = 4 * (memory.nbytes_of(xs[0]) + memory.nbytes_of(ys[0]))
                memory.configure(budget_mb=(memory.tracked_bytes() + need / 2)
                                 / 2 ** 20)
                try:
                    out = stepper.superstep(xs, ys)
                finally:
                    memory.configure(budget_mb=0.0)
                check(stepper.super_captures == [] and stepper._super_warned,
                      "the refused superstep was not demoted")
            else:
                out = torch.stack([stepper.step(x, y) for x, y in
                                   zip(xs, ys)])
        losses[refused] = out
    same = torch.equal(losses[False], losses[True])
    print(f"      a headroom refusal (the budget {need / 2 ** 20 / 2:.1f} MB "
          f"short of 4 staged batches) demotes the superstep to K=1: its "
          f"losses equal 4 whole steps' bitwise: {same}")
    check(same, "the demoted superstep's losses differ from K=1's")


def phase_module_supervised(mx):
    """(g) phase 11's LM Module leg, MODULE_SUP_STEPS steps through
    ``fit(supervise=True)`` with one injected transient against
    ``fit()``, under deterministic algorithms: parameters bitwise."""
    import gc
    import numpy as np
    import torch
    from mxnet_tpu_torch import faultinject as fi
    from mxnet_tpu_torch.gluon.model_zoo.transformer import TransformerLM
    B, T = TRAIN_BATCH, CONFIG["max_len"]
    toks = np.random.RandomState(0).randint(
        0, CONFIG["vocab"], (B * MODULE_SUP_STEPS, T + 1))
    data = mx.nd.array(toks[:, :-1].astype(np.float32), ctx=mx.gpu(0))
    label = mx.nd.array(toks[:, 1:].astype(np.float32), ctx=mx.gpu(0))
    out = {}
    for supervise in (False, True):
        gc.collect()
        torch.cuda.empty_cache()
        mx.random.seed(0)
        net = TransformerLM(**CONFIG, attn_type="flash", prefix="lm_")
        net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
        net(mx.nd.array(np.zeros((1, 8), np.float32), ctx=mx.gpu(0)))
        net.cast("bfloat16")
        sym = mx.sym.SoftmaxOutput(net(mx.sym.var("data")),
                                   preserve_shape=True,
                                   normalization="valid", name="softmax")
        weights = {p.name: p.data() for p in net.collect_params().values()}
        mod = mx.mod.Module(sym, context=mx.gpu(0))
        it = mx.io.NDArrayIter(data, label, batch_size=B)
        plan = fi.FaultPlan()
        if supervise:
            plan.add("trainer.step", "raise", exc=OSError, times=1, after=1)
        t0 = time.perf_counter()
        with deterministic(), fi.active(plan):
            mod.fit(it, num_epoch=1, arg_params=weights,
                    eval_metric=DeviceNLL(mx).metric, optimizer="sgd",
                    optimizer_params={"learning_rate": LM_MODULE_LR,
                                      "momentum": 0.9,
                                      "multi_precision": True},
                    supervise=supervise)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        out[supervise] = ({k: v.detach().clone() for k, v in
                           mod.get_params()[0].items()}, plan.stats(), secs)
        del net, weights, mod, it, sym
    ref, _, t_ref = out[False]
    got, fired, t_sup = out[True]
    bit = all(torch.equal(ref[k], got[k]) for k in ref)
    print(f"  (g) the LM Module leg, fit(supervise=True) for "
          f"{MODULE_SUP_STEPS} steps, a trainer.step raise at step 1 "
          f"(fired {fired}), against fit(): {len(ref)} parameters bitwise "
          f"{bit}; {t_sup:.1f} s against {t_ref:.1f} s")
    check(fired == {"trainer.step": 1} and bit,
          "the supervised Module fit differs from fit()")


def phase_prefetch(mx, path, it_rate):
    """(h) ``prefetch_to_device`` over phase 14's record file read on the
    host: images/s to the card beside phase 14 (b); a data.batch OSError
    (a respawn, no batch lost) and two corrupt records within the budget
    in one epoch; one more than the budget raises DataSkipBudgetError."""
    import torch
    from mxnet_tpu_torch import faultinject as fi
    from mxnet_tpu_torch import resilience as res
    from mxnet_tpu_torch.gluon.data import prefetch_to_device
    from mxnet_tpu_torch.observability import metrics as M
    outer = rec_iter(mx, path, device_augment=False, ctx=mx.cpu(),
                     prefetch_buffer=1)
    src = outer.iter                # the host reader alone
    outer.close()

    def epoch(budget=None, plan=None):
        src.reset()
        labels, n = [], 0
        it = prefetch_to_device(src, depth=PREFETCH_DEPTH,
                                device=mx.gpu(0), skip_budget=budget)
        t0 = time.perf_counter()
        with fi.active(plan or fi.FaultPlan()):
            try:
                for b in it:
                    check(b.data[0].is_cuda and b.data[0].dtype ==
                          torch.float32, "prefetched batch not on the card")
                    labels.append(b.label[0].cpu())
                    n += 1
            finally:
                torch.cuda.synchronize()
                it.close()
        return n, time.perf_counter() - t0, labels

    n, secs, labels = epoch()
    rate = n * VISION_BATCH / secs
    r0, s0 = M.PREFETCH_RESPAWNS.value, M.DATA_RECORDS_SKIPPED.value
    plan = (fi.FaultPlan()
            .add("data.batch", "raise", exc=OSError, times=1, after=2)
            .add("data.batch", "raise", exc=res.DataCorruptionError,
                 times=2, after=4))
    n2, _, labels2 = epoch(budget=2, plan=plan)
    resp = M.PREFETCH_RESPAWNS.value - r0
    skip = M.DATA_RECORDS_SKIPPED.value - s0
    same = sorted(torch.cat(labels).tolist()) == \
        sorted(torch.cat(labels2).tolist())
    over = None
    try:
        epoch(budget=2, plan=fi.FaultPlan().add(
            "data.batch", "raise", exc=res.DataCorruptionError, times=3,
            after=1))
    except res.DataSkipBudgetError as e:
        over = e
    print(f"  (h) prefetch_to_device(depth {PREFETCH_DEPTH}) over the host "
          f"reader of phase 14's file (B={VISION_BATCH} float32, pinned "
          f"staging, a side stream): {n} batches in {secs:.3f} s, "
          f"{rate:.1f} images/s to the card beside phase 14 (b)'s "
          f"{it_rate:.1f} (device augment); an OSError and 2 corrupt "
          f"records in one epoch: {resp} respawn, {skip} skipped, {n2} "
          f"batches, labels the same: {same}; one more than the budget: "
          f"{type(over).__name__}")
    check(n == n2 == REC_IMAGES // VISION_BATCH and resp == 1 and skip == 2
          and same and over is not None,
          "prefetch_to_device's respawn or skip budget")
    return rate


def phase_resilience(mx, path, it_rate):
    """Phase 16: (a)-(h)."""
    import gc
    import torch
    flight_dir = os.environ.get("MXNET_FLIGHT_DIR")
    tmp = observed()
    try:
        t0 = time.perf_counter()
        start = lm_start(mx)
        batches = token_batches(mx, SUP_STEPS)
        got, objs = phase_retry(mx, start, batches)
        del start
        net, trainer, stepper, sup = objs
        costs = phase_cost(mx, stepper, sup, batches)
        phase_traces(mx, objs, batches, tmp.name)
        phase_oom_budget(mx, stepper, batches)
        sup.close()
        del net, trainer, stepper, sup, objs, got, batches
        gc.collect()
        torch.cuda.empty_cache()
        phase_watchdogs(mx)
        phase_module_supervised(mx)
        rate = phase_prefetch(mx, path, it_rate)
        print(f"  phase 16 instruments' cost (%): {json.dumps(costs)}; "
              f"prefetch {rate:.1f} images/s; {time.perf_counter() - t0:.1f}"
              " s")
    finally:
        from mxnet_tpu_torch.observability import journal
        journal.configure(run_dir="")
        if flight_dir is None:
            os.environ.pop("MXNET_FLIGHT_DIR", None)
        else:
            os.environ["MXNET_FLIGHT_DIR"] = flight_dir
        tmp.cleanup()


# -- phase 17: the program introspector, the tuner, decode, the registry ---
INTRO_STEPS = 7         # (a): phase 9's LM whole step: eager, capture, replays
INTRO_PAIRS = 6         # (a): the introspector on against off, interleaved
TOL_MFU = 0.05          # (a): MFU against probe flops / host median / peak
RESNET_FLOP_STEPS = 3   # (a): ResNet-50 Module steps: 1 counted, 2 timed
SENTINEL_STEPS = 3      # (b): replayed steps against a halved baseline
TUNE_KS = (2, 4, 8)     # (c)
TUNE_PAIRS = 6
TUNE_BUCKETS_MB = (8, 32, 128)
DECODE = dict(vocab=32768, dim=1024, window=16)  # (d): ToyLM, the LM's widths
DECODE_SLOTS = 64
DECODE_PAGE_TOKENS = 16
DECODE_PAGES = 64       # capacity 1024 tokens a sequence
DECODE_SEQS = 128
DECODE_PROMPT = (16, 300)   # prompt tokens, inclusive
DECODE_NEW = (32, 256)      # new tokens, inclusive
DECODE_FIRST = 48       # admitted up front; one more every DECODE_JOIN steps
DECODE_JOIN = 2
DECODE_SOLO_EVERY = 8   # every 8th sequence against its solo run
DECODE_CPU = 4          # the 4 shortest against the same engine on the CPU
REG_MODELS = 4          # (e): bf16 TransformerLMs, seeds 0-3
REG_BATCH = (1, 4)
REG_SEQ = (256, 1024)
REG_REQUESTS = 64       # the flood, from 4 tenant threads
REG_SHAPES = ((1, 200), (1, 256), (2, 256), (1, 700), (4, 256), (1, 1000))
REG_SLACK = 0.6         # the budget: the two resident models + 0.6 of one


def probe_flops(B, T):
    """``experiments/lm_mfu_probe.py:123-127``: the matrix products and the
    attention of one training step, 3 x the forward's."""
    L, d, v = CONFIG["num_layers"], CONFIG["dim"], CONFIG["vocab"]
    f = CONFIG.get("ffn_dim") or 4 * d
    p = L * (4 * d * d + 2 * d * f) + d * v
    return 3 * (2 * p * B * T + L * 4 * B * T * T * d)


def phase_introspect(mx, start):
    """(a) the LM whole step's counted flops, MFU over the card's step time
    against probe flops over the synchronized host median, per-layer rows,
    the introspector's cost per replayed step; (b) the perf sentinel.
    Returns the LM's MFU record."""
    import gc
    import torch
    from mxnet_tpu_torch.gluon.wholestep import WholeStepCompiler
    from mxnet_tpu_torch.observability import goodput
    from mxnet_tpu_torch.observability import introspect as I
    from mxnet_tpu_torch.observability import metrics as M
    I.enable()
    I.reset()
    net = lm_fresh(mx, start, "bfloat16")
    trainer = lm_trainer(mx, net)
    stepper = WholeStepCompiler(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                                trainer)
    x, y = token_batches(mx, 1)[0]
    walls = []
    # Python's collector off while the steps are timed, as timeit does:
    # a collection of the heap sixteen phases left would land on the
    # host clock's steps and not on the card's
    gc.collect()
    gc.disable()
    try:
        with env_vars(MXNET_WHOLE_STEP=1):
            for _ in range(INTRO_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                stepper.step(x, y)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
    finally:
        gc.enable()
    I.drain_device_times()
    check(stepper.active, f"whole step inactive: {stepper.fallback_reason}")
    rec = I.programs()["whole_step"]
    kind = rec["by_kind"]
    mm = kind.get("matmul", 0.0) + kind.get("attention", 0.0)
    want = probe_flops(TRAIN_BATCH, CONFIG["max_len"])
    out = I.mfu()
    host_med = statistics.median(walls[1:6])
    peak, src = I.peak_flops()
    mfu_host = want / (host_med / 1e3) / peak
    print(f"  (a) LM whole step (bf16, B={TRAIN_BATCH}, T="
          f"{CONFIG['max_len']}): counted {rec['flops']:.6e} flops a step "
          f"({', '.join(f'{k} {v:.6e}' for k, v in sorted(kind.items()))}), "
          f"{rec['bytes']:.6e} bytes (unfused ops' inputs and outputs), "
          f"compute dtype {rec['dtype']}; matrix products and attention "
          f"{mm:.6e} against the probe formula's {want:.6e}")
    print(f"      peak {peak:.4e} flops/s ({src}); the card's step time "
          f"{out.get('step_time_ms')} ms ({out.get('step_time_source')}) -> "
          f"MFU {out.get('mfu')} ({out.get('mfu_pct')} %), "
          f"{out.get('flops_per_s', 0):.4e} flops/s, arithmetic intensity "
          f"{out.get('arithmetic_intensity')}; synchronized host clock of "
          f"steps 2-6 {[round(w, 2) for w in walls[1:6]]}, median "
          f"{host_med:.2f} ms -> probe flops / median / peak {mfu_host:.6f};"
          f" the replay call's host time {stepper._graph.replay_host_ms} ms")
    check(mm == want, f"counted matrix-product flops {mm} != the probe "
          f"formula's {want}")
    check(out.get("step_time_source") == "device",
          f"MFU's step time is not the card's: {out}")
    check(0.0 < out["mfu"] < 1.0, f"MFU {out['mfu']} outside (0, 1)")
    check(abs(out["mfu"] / mfu_host - 1.0) <= TOL_MFU,
          f"MFU {out['mfu']} not within {TOL_MFU:.0%} of {mfu_host}")
    rows = I.per_layer("whole_step", top=6)
    pct = I.attributed_pct("whole_step")
    print("      per_layer top rows: " + "; ".join(
        f"{r['layer']} {r['flops']:.4e} ({r['pct']} %, est {r['est_ms']} "
        f"ms)" for r in rows) + f"; attributed {pct} %")
    check(pct >= ATTRIBUTION_FLOOR, f"{pct} % of the flops attributed")
    # the introspector's own cost per replayed step (goodput held off in
    # both arms, so the difference is the event pair and the sentinel)
    was_gp = goodput.ENABLED
    goodput.disable()

    def off(a, b):
        I.disable()
        try:
            return stepper.step(a, b)
        finally:
            I.enable()
    try:
        with env_vars(MXNET_WHOLE_STEP=1):
            on_ms, off_ms, d = paired_ms(stepper.step, off, x, y,
                                         pairs=INTRO_PAIRS)
    finally:
        if was_gp:
            goodput.enable()
    print(f"      introspector on against off per replayed step "
          f"({INTRO_PAIRS} pairs, interleaved): {on_ms:.2f} against "
          f"{off_ms:.2f} ms, median pair difference {d:.3f} ms "
          f"({100 * d / off_ms:.2f} %)")
    lm = dict(out, cost_pct=100 * d / off_ms, host_median_ms=host_med,
              mfu_host=mfu_host, counted_flops=rec["flops"],
              matmul_flops=mm)
    # (b) the perf sentinel: a baseline of this step, re-armed at half
    I.drain_device_times()
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d, \
            env_vars(MXNET_PERF_BASELINE_DIR=d, MXNET_WHOLE_STEP=1):
        I.configure(sentinel_every=1, regression_min_s=300.0)
        try:
            base = I.refresh_baseline("whole_step")
            check(base is not None and base["step_time_source"] == "device",
                  f"baseline {base}")
            path = I.baseline_path("whole_step")
            with open(path, "w") as f:
                json.dump(dict(base, step_time_p50_ms=base[
                    "step_time_p50_ms"] / 2), f)
            I._sentinel.clear()
            fired0 = M.PERF_REGRESSIONS.get(kind="step_time",
                                            phase="whole_step")
            pred, srv = sentinel_server(mx)
            try:
                for _ in range(SENTINEL_STEPS):
                    stepper.step(x, y)
                    torch.cuda.synchronize()
                fired = M.PERF_REGRESSIONS.get(
                    kind="step_time", phase="whole_step") - fired0
                rz = srv.readyz()
                I.refresh_baseline("whole_step")
                rz2 = srv.readyz()
            finally:
                srv.close()
                pred.close()
        finally:
            I.configure(sentinel_every=25)
    print(f"  (b) sentinel: baseline {os.path.basename(path)} at "
          f"{base['step_time_p50_ms']} ms (the card's), re-armed at "
          f"{base['step_time_p50_ms'] / 2:.4f} ms; {SENTINEL_STEPS} replayed "
          f"steps fired {fired:.0f} time(s); readyz perf_regression "
          f"{rz['checks'].get('perf_regression')} ({rz['reasons']}), after "
          f"refresh_baseline {rz2['checks'].get('perf_regression')}")
    check(fired == 1, f"the sentinel fired {fired} times, want once")
    check(rz["checks"].get("perf_regression") is False,
          f"readyz did not flip: {rz['checks']}")
    check(rz2["checks"].get("perf_regression") is True,
          f"refresh_baseline did not clear the check: {rz2['checks']}")
    return lm


def sentinel_server(mx):
    """A small served model on the card behind a ResilientServer (its
    readyz carries the sentinel's check)."""
    import numpy as np
    sym = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=4,
                                name="sentinel_fc")
    params = {"sentinel_fc_weight": np.ones((4, 8), np.float32),
              "sentinel_fc_bias": np.zeros(4, np.float32)}
    pred = mx.serving.BucketedPredictor(sym, params, {"data": (4, 8)})
    pred.warmup()
    return pred, mx.serving.ResilientServer(pred, watchdog_interval_s=60.0)


def phase_resnet_flops(mx):
    """(a) the ResNet-50 ``Module`` step's counted flops and MFU: phase
    11's configuration, one counted step and two timed ones."""
    import gc
    import torch
    from mxnet_tpu_torch.observability import introspect as I
    gc.collect()
    torch.cuda.empty_cache()
    mod = bind_resnet_module(mx, resnet_symbol(mx, VISION_MODEL))
    data, labels = module_data(mx, VISION_BATCH)
    batch = mx.io.DataBatch([data], [labels])
    walls = []
    for _ in range(RESNET_FLOP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mod.forward_backward(batch)
        mod.update()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    progs = I.programs()
    flops = progs["executor:fwd_bwd"]["flops"] + \
        progs["fused_update"]["flops"]
    step_ms = statistics.median(walls[1:])
    out = I.mfu(step_time_s=step_ms / 1e3, flops=flops,
                peak=I.peak_flops("bfloat16")[0])
    print(f"      ResNet-50 Module step (B={VISION_BATCH}, bf16): counted "
          f"{flops:.6e} flops (executor:fwd_bwd "
          f"{progs['executor:fwd_bwd']['flops']:.6e}, matrix products and "
          f"convolutions {progs['executor:fwd_bwd']['by_kind'].get('conv', 0) + progs['executor:fwd_bwd']['by_kind'].get('matmul', 0):.6e}; "
          f"fused_update {progs['fused_update']['flops']:.6e}); steps "
          f"{[round(w, 1) for w in walls]} ms, MFU {out['mfu_pct']} % at "
          f"{step_ms:.1f} ms (synchronized host clock)")
    check(0.0 < out["mfu"] < 1.0, f"ResNet-50 MFU {out['mfu']}")
    del mod, data, labels, batch
    return {"flops": flops, "mfu": out["mfu"], "step_ms": step_ms}


def phase_tune(mx, start, serve_obs):
    """(c) ``autotune.tune()`` on the LM: K, bucket size, the serving
    lattice from phase 8's traffic and the hold window from its dispatch
    EWMA; a second tune() runs nothing; a fresh predictor and batcher read
    the decision."""
    import gc
    import torch
    from mxnet_tpu_torch.autotune import decisions, sweep
    from mxnet_tpu_torch.serving import BucketSpec
    gc.collect()
    torch.cuda.empty_cache()
    net = lm_fresh(mx, start, "bfloat16")
    trainer = lm_trainer(mx, net)
    loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    x, y = token_batches(mx, 1)[0]
    shapes = {"data": (SCORE_BATCH, CONFIG["max_len"])}
    spec_sig = BucketSpec(shapes, seq_axes={"data": 1}).signature
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d, \
            env_vars(MXNET_AUTOTUNE_DIR=d):
        decisions.enable()
        decisions.reset_cache()
        t0 = time.perf_counter()
        rec = sweep.tune(net, loss, trainer, x, y, ks=TUNE_KS,
                         pairs=TUNE_PAIRS,
                         bucket_candidates_mb=TUNE_BUCKETS_MB,
                         serve_traffic=serve_obs["traffic"],
                         serve_max_batch=SCORE_BATCH, apply_env=False,
                         serve_signature=spec_sig,
                         serve_dispatch_ewma_s=serve_obs["ewma_s"])
        t_tune = time.perf_counter() - t0
        runs = sweep.last_sweep_runs
        check(rec is not None, "tune() returned no decision")
        ev = rec["evidence"]
        print(f"  (c) tune(): {t_tune:.1f} s, {runs} measured runs; "
              f"decision {json.dumps(rec['knobs'], sort_keys=True)}")
        for k, row in sorted(ev["superstep"].items(), key=lambda kv:
                             int(kv[0])):
            print(f"      K={k}: superstep {row['superstep_ms_per_step']} "
                  f"ms a step against whole steps' "
                  f"{row['wholestep_ms_per_step']} (chunked delta "
                  f"{row['delta_pct']} %, ran {row['scanned']})")
        print("      bucket size: " + "; ".join(
            f"{mb} MB {row['med_ms']} ms ({row['buckets']} buckets)"
            for mb, row in ev["bucket_size"].items())
            + f"; phase 8's traffic {len(serve_obs['traffic'])} requests, "
            f"sizes {sorted(set(serve_obs['traffic']))}; its dispatch EWMA "
            f"{ev['serve_dispatch_ewma_ms']} ms")
        check(runs > 0, "the first tune() measured nothing")
        decisions.reset_cache()
        t0 = time.perf_counter()
        rec2 = sweep.tune(net, loss, trainer, x, y, ks=TUNE_KS,
                          pairs=TUNE_PAIRS,
                          bucket_candidates_mb=TUNE_BUCKETS_MB,
                          apply_env=False)
        t2 = time.perf_counter() - t0
        print(f"      second tune(): {sweep.last_sweep_runs} measured runs "
              f"in {t2:.2f} s, the same knobs "
              f"{rec2 is not None and rec2['knobs'] == rec['knobs']}")
        check(sweep.last_sweep_runs == 0 and rec2 is not None
              and rec2["knobs"] == rec["knobs"],
              "the second tune() did not reload the decision")
        lattice = [int(t) for t in rec["knobs"]["serve_buckets"].split(",")]
        params = {n: p.data() for n, p in net.collect_params().items()}
        pred = mx.serving.BucketedPredictor(net(mx.sym.var("data")), params,
                                            shapes, seq_axes={"data": 1})
        mb = mx.serving.MicroBatcher(pred)
        wait_ms = mb._max_wait_s * 1e3
        mb.close()
        pred.close()
        print(f"      a fresh BucketedPredictor's batch buckets "
              f"{pred.spec.batch_buckets} (decided {lattice}); its "
              f"MicroBatcher waits {wait_ms} ms (decided "
              f"{rec['knobs']['serve_max_wait_ms']})")
        check(pred.spec.batch_buckets == lattice,
              "the fresh predictor did not read the persisted lattice")
        check(abs(wait_ms - rec["knobs"]["serve_max_wait_ms"]) < 1e-9,
              "the fresh batcher did not read the persisted wait")
    return {"runs": runs, "knobs": rec["knobs"], "seconds": t_tune}


def toylm_logits64(params, prompt, gen, j, window):
    """ToyLM's logits at the step that emits generated token ``j`` of a
    sequence, in float64 on the host (the near-tie check)."""
    import numpy as np
    emb, wx, wh, out = (np.asarray(params[k], np.float64)
                        for k in ("emb", "wx", "wh", "out"))
    toks = list(prompt) + list(gen)
    h = np.zeros(wx.shape[0])
    kv = []
    last = len(prompt) - 1 + j
    for pos in range(last + 1):
        h = np.tanh(emb[toks[pos]] @ wx + h @ wh)
        kv.append(h)
    r = np.mean(kv[max(0, last - window + 1):last + 1], axis=0)
    return (h + r) @ out


def same_tokens(params, seq, got, want, what):
    """``got`` equals ``want``, except after a printed near-tie: the first
    differing token's float64 top-2 logits within NEAR_TIE."""
    import numpy as np
    if got == want:
        return True
    j = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b) \
        if any(a != b for a, b in zip(got, want)) else min(len(got),
                                                          len(want))
    logits = toylm_logits64(params, seq[0], want, j, DECODE["window"])
    top = np.sort(logits)[-2:]
    gap = float(top[1] - top[0])
    print(f"      {what}: tokens differ from token {j} on "
          f"({got[j:j + 3]} against {want[j:j + 3]}); float64 top-2 gap "
          f"there {gap:.3e}")
    check(gap <= NEAR_TIE, f"{what}: tokens differ at {j} without a "
          f"near-tie (gap {gap:.3e})")
    return False


def phase_decode(mx):
    """(d) ``DecodeEngine`` serving ``ToyLM`` at the LM's widths."""
    import collections
    import gc
    import numpy as np
    import torch
    from mxnet_tpu_torch.observability import metrics as M
    from mxnet_tpu_torch.serving import (DeadlineExceeded, DecodeEngine,
                                         Overloaded, SequenceEvicted, ToyLM)
    gc.collect()
    torch.cuda.empty_cache()
    model = ToyLM(**DECODE)
    params = model.init_params(0)
    # the recurrence's matrices scaled by 4 / sqrt(dim): the JAX package's
    # draws are sized for its default width 16, where the recurrence
    # contracts; at 1024 they make it chaotic, and the last-bit differences
    # of matrix products of other shapes (a solo run's, the CPU's) would
    # grow into other tokens
    for k in ("wx", "wh"):
        params[k] = params[k] * np.float32(4.0 / math.sqrt(DECODE["dim"]))
    kw = dict(params=params, slots=DECODE_SLOTS,
              page_tokens=DECODE_PAGE_TOKENS, max_pages=DECODE_PAGES)
    eng = DecodeEngine(model, warmup=False, name="toylm", **kw)
    c0 = M.SERVE_COMPILES.value
    t0 = time.perf_counter()
    n_keys = eng.warmup()
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    built = M.SERVE_COMPILES.value - c0
    held = eng.stats()["kv_bytes"]
    print(f"  (d) DecodeEngine(ToyLM vocab {DECODE['vocab']}, dim "
          f"{DECODE['dim']}, window {DECODE['window']}; {DECODE_SLOTS} "
          f"slots, pages of {DECODE_PAGE_TOKENS} tokens, {DECODE_PAGES} "
          f"pages): warmup captured {n_keys} keys in {t_warm:.2f} s "
          f"({built:.0f} SERVE_COMPILES), holding {held / 2 ** 30:.3f} GiB "
          f"of state")
    check(built == n_keys == len(eng.spec.all_keys()),
          f"warmup built {built} of {n_keys} keys")
    rs = np.random.RandomState(17)
    seqs = [([int(t) for t in rs.randint(0, DECODE["vocab"], rs.randint(
        DECODE_PROMPT[0], DECODE_PROMPT[1] + 1))],
             int(rs.randint(DECODE_NEW[0], DECODE_NEW[1] + 1)))
            for _ in range(DECODE_SEQS)]
    c1 = M.SERVE_COMPILES.value
    st0 = eng.stats()
    futs = [eng.submit(*s) for s in seqs[:DECODE_FIRST]]
    nxt, k, walls, keys = DECODE_FIRST, 0, [], collections.Counter()
    t0 = time.perf_counter()
    while nxt < DECODE_SEQS or eng.pending():
        ts = time.perf_counter()
        eng.step()
        walls.append((time.perf_counter() - ts) * 1e3)
        keys[eng.stats()["key"]] += 1
        k += 1
        if nxt < DECODE_SEQS and k % DECODE_JOIN == 0:
            futs.append(eng.submit(*seqs[nxt]))
            nxt += 1
    t_traffic = time.perf_counter() - t0
    outs = [f.result(timeout=60) for f in futs]
    st = eng.stats()
    steps, replays = st["steps"] - st0["steps"], st["replays"] - st0[
        "replays"]
    tokens = sum(len(o) for o in outs)
    top_key = max((kk for kk in keys if kk is not None), key=keys.get)
    ent = eng._compiled[top_key]
    dev_ms = device_ms(lambda: ent["graph"].replay())
    print(f"      {DECODE_SEQS} sequences joining and leaving: {steps} "
          f"steps, {replays} replays, {tokens} tokens in {t_traffic:.2f} s "
          f"({tokens / t_traffic:.1f} tokens/s); a step's host clock median "
          f"{statistics.median(walls):.3f} ms (p90 "
          f"{percentile(walls, 90):.3f}); the most used key {top_key} "
          f"({keys[top_key]} steps) replays in {dev_ms:.4f} ms of device "
          f"time; SERVE_COMPILES after warmup "
          f"{M.SERVE_COMPILES.value - c1:.0f}")
    check(replays == steps, f"{replays} replays for {steps} steps")
    check(M.SERVE_COMPILES.value == c1, "traffic captured a key")
    check(all(len(o) == s[1] for o, s in zip(outs, seqs)),
          "a sequence ended short")
    # solo runs and the CPU
    solo = DecodeEngine(model, warmup=False, name="solo", **kw)
    same = 0
    for i in range(0, DECODE_SEQS, DECODE_SOLO_EVERY):
        same += same_tokens(params, seqs[i], outs[i],
                            solo.generate(*seqs[i]), f"sequence {i} solo")
    solo.close()
    short = sorted(range(DECODE_SEQS), key=lambda i: len(seqs[i][0]) +
                   seqs[i][1])[:DECODE_CPU]
    cpu = DecodeEngine(model, warmup=False, name="cpu", dev=mx.cpu(), **kw)
    cfuts = [cpu.submit(*seqs[i]) for i in short]
    cpu.drain()
    cpu_same = sum(same_tokens(params, seqs[i], outs[i], f.result(),
                               f"sequence {i} on the CPU")
                   for i, f in zip(short, cfuts))
    cpu.close()
    n_solo = len(range(0, DECODE_SEQS, DECODE_SOLO_EVERY))
    print(f"      tokens bitwise equal to the solo run for {same} of "
          f"{n_solo} sequences and to the CPU engine for {cpu_same} of "
          f"{DECODE_CPU} (the rest after printed near-ties)")
    # EDF shed, mid-flight expiry, KV eviction
    try:
        eng.submit(seqs[0][0], DECODE_NEW[1], deadline_ms=0.01)
        check(False, "an unmeetable deadline was admitted")
    except Overloaded as e:
        shed = str(e)
    # a deadline twice the admission estimate (remaining tokens over every
    # slot), which one sequence decoding alone cannot meet
    n_new = min(200, eng.capacity - 16)
    eta_ms = eng._edf.eta_s(15 + n_new, DECODE_SLOTS) * 1e3
    fut = eng.submit(seqs[1][0][:16], n_new, deadline_ms=2 * eta_ms)
    e0 = eng.stats()["expired"]
    while not fut.done():
        eng.step()
    try:
        fut.result()
        check(False, "a sequence outlived its deadline")
    except DeadlineExceeded as e:
        expired = str(e)
    check(eng.stats()["expired"] == e0 + 1, "the expiry was not counted")
    vfuts = [eng.submit(seqs[i][0][:32], 64) for i in range(3)]
    eng.step()
    eng.step()
    st = eng.stats()
    cur = eng._state_bytes(st["key"])
    freed = eng.release_kv_pages(st["kv_bytes"] - cur + 1, why="phase 17")
    eng.drain()
    kinds = []
    for f in vfuts:
        try:
            f.result()
            kinds.append("done")
        except SequenceEvicted as e:
            kinds.append(f"SequenceEvicted(retry_after_s="
                         f"{e.retry_after_s:.3f})")
    print(f"      EDF shed at admission: Overloaded({shed[:60]}...); "
          f"expired mid-flight: DeadlineExceeded({expired[:50]}...); "
          f"release_kv_pages freed {freed / 2 ** 20:.1f} MiB of "
          f"{st['kv_bytes'] / 2 ** 20:.1f}: {kinds}")
    check(sum(k != "done" for k in kinds) == 1 and freed > 0,
          f"the KV reclaim evicted {kinds}")
    eng.close()
    return {"tokens_s": tokens / t_traffic, "steps": steps,
            "step_ms": statistics.median(walls), "device_ms": dev_ms,
            "warmup_s": t_warm, "state_gib": held / 2 ** 30}


def registry_model(mx, seed):
    """A full-width bf16 TransformerLM from ``seed``: (symbol, params)."""
    import numpy as np
    from mxnet_tpu_torch.gluon.model_zoo.transformer import TransformerLM
    mx.random.seed(seed)
    net = TransformerLM(**CONFIG, attn_type="flash", prefix=f"m{seed}_")
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    net(mx.nd.array(np.zeros((1, 8), np.float32), ctx=mx.gpu(0)))
    net.cast("bfloat16")
    net.hybridize()
    return net(mx.sym.var("data")), {n: p.data() for n, p in
                                     net.collect_params().items()}


def phase_registry(mx):
    """(e) ``ModelRegistry``: four LMs under a budget for two."""
    import gc
    import threading
    import numpy as np
    import torch
    from mxnet_tpu_torch.kernels import flash_attention as kfa
    from mxnet_tpu_torch.observability import memory
    from mxnet_tpu_torch.observability import metrics as M
    from mxnet_tpu_torch.serving import (DeadlineExceeded, DecodeEngine,
                                         ModelRegistry, ModelUnavailable,
                                         Overloaded, SequenceEvicted, ToyLM)
    gc.collect()
    torch.cuda.empty_cache()
    names = [f"m{i}" for i in range(REG_MODELS)]
    reg = ModelRegistry(budget_mb=1e9)        # sized below, once built
    t0 = time.perf_counter()
    for i, n in enumerate(names):
        sym, params = registry_model(mx, i)
        reg.register(n, sym, params, {"data": (max(REG_BATCH),
                                               max(REG_SEQ))},
                     tenants=[f"{n}-t"], batch_buckets=list(REG_BATCH),
                     seq_axes={"data": 1}, seq_buckets=list(REG_SEQ),
                     server_kwargs={"watchdog_interval_s": 60.0})
        del sym, params
    torch.cuda.synchronize()
    t_reg = time.perf_counter() - t0
    rs = np.random.RandomState(23)
    probe = rs.randint(0, CONFIG["vocab"], REG_SHAPES[0]).astype(np.float32)
    before = reg.predict(model="m0", data=probe)[0]
    wb = reg._entry("m0").predictor.memory_stats()["weights_bytes"]
    print(f"  (e) ModelRegistry: {REG_MODELS} LMs (bf16, {wb / 2 ** 30:.3f} "
          f"GiB of weights each; batch buckets {REG_BATCH} x sequence "
          f"buckets {REG_SEQ}) registered and warmed in {t_reg:.1f} s")
    # the LRU order: decode KV, then buckets, then weights
    eng = DecodeEngine(ToyLM(**DECODE), slots=8, page_tokens=16,
                       max_pages=8, warmup=False, name="regkv")
    gens = [eng.submit([1, 2, 3], 64), eng.submit([4, 5], 64)]
    eng.step()
    eng.step()

    def ev():
        """Evictions so far by kind, over every model and the engine."""
        return {k: sum(M.SERVE_EVICTIONS.get(kind=k, model=m)
                       for m in names + ["regkv"])
                for k in ("kv_pages", "bucket", "model")}

    e0 = ev()
    reg._make_room(eng.stats()["kv_bytes"] / 4.0, exclude=None,
                   why="phase 17 kv")
    e1 = ev()
    kinds = [type(f.exception()).__name__ if f.done() and f.exception()
             else "live" for f in gens]
    eng.close()
    reg._make_room(1.0, exclude=None, why="phase 17 bucket")
    e2 = ev()
    reg._make_room(float(2 ** 40), exclude="m3", why="phase 17 weights")
    e3 = ev()
    d1, d2, d3 = ({k for k in a if b[k] != a[k]}
                  for a, b in ((e0, e1), (e1, e2), (e2, e3)))
    print(f"      reclaim order: a small deficit with a decode engine live "
          f"took {sorted(d1)} (its sequences {kinds}); a 1-byte deficit "
          f"{sorted(d2)}; everything but m3 {sorted(d3)}; evictions by kind "
          f"{e3}; rungs {[reg.degradation(n) for n in names]}")
    check(d1 == {"kv_pages"} and "SequenceEvicted" in kinds,
          f"the first reclaim took {d1} (sequences {kinds})")
    check(d2 == {"bucket"}, f"a 1-byte deficit took {d2}")
    check("model" in d3, f"the large deficit took {d3}")
    # readmission bitwise, timed
    e = reg._entry("m0")
    check(not e.predictor.resident, "m0 kept its weights")
    t0 = time.perf_counter()
    again = reg.predict(model="m0", data=probe)[0]
    t_readmit = time.perf_counter() - t0
    check(np.array_equal(before, again), "m0's logits changed across its "
          "eviction and readmission")
    t0 = time.perf_counter()
    freed = reg._evict_model(e, why="phase 17 timing")
    torch.cuda.synchronize()
    t_evict = time.perf_counter() - t0
    print(f"      m0 readmitted (weights uploaded, the 1x256 bucket "
          f"rebuilt, one request) in {t_readmit * 1e3:.1f} ms, logits "
          f"bitwise equal to before its eviction; evicting it again freed "
          f"{freed / 2 ** 30:.3f} GiB in {t_evict * 1e3:.1f} ms")
    # the flood under a budget for two models
    for n in names:
        reg._entry(n).predictor.evict()
    for n in names[:2]:
        reg.predict(model=n, data=probe)
    gc.collect()
    reg.budget_bytes = memory.tracked_bytes() + REG_SLACK * wb
    reqs = [rs.randint(0, CONFIG["vocab"], REG_SHAPES[i % len(REG_SHAPES)])
            .astype(np.float32) for i in range(REG_REQUESTS)]
    results = {"errors": [], "typed": [], "served": 0, "lat": []}
    lock = threading.Lock()

    def load(tenant, idx):
        for i in idx:
            model = names[(i * 3 + len(tenant)) % REG_MODELS]
            t = time.perf_counter()
            try:
                reg.predict(model=model, tenant=tenant, data=reqs[i])
                with lock:
                    results["served"] += 1
                    results["lat"].append(time.perf_counter() - t)
            except (ModelUnavailable, Overloaded, DeadlineExceeded) as ex:
                with lock:
                    results["typed"].append(type(ex).__name__)
            except Exception as ex:  # noqa: BLE001 — the invariant
                with lock:
                    results["errors"].append(repr(ex))
    b0, c0 = M.SERVE_BATCHES.value, M.SERVE_COMPILES.value
    ev0 = M.SERVE_EVICTIONS.value
    rm0 = M.SERVE_READMITS.value
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=load, args=(
        t, range(j, REG_REQUESTS, 4))) for j, t in
        enumerate(("acme", "beta", "gamma", "delta"))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    torch.cuda.synchronize()
    counts = read_counts()
    t_flood = time.perf_counter() - t0
    batches = M.SERVE_BATCHES.value - b0
    builds = M.SERVE_COMPILES.value - c0
    launches = counts["flash_attention.sm90"]
    print(f"      flood: {REG_REQUESTS} requests from 4 tenants over "
          f"{REG_MODELS} models under a budget for two "
          f"({reg.budget_bytes / 2 ** 30:.2f} GiB) in {t_flood:.1f} s: "
          f"{results['served']} served (p50 "
          f"{percentile([1e3 * v for v in results['lat']], 50):.1f} ms, p99 "
          f"{percentile([1e3 * v for v in results['lat']], 99):.1f} ms), "
          f"typed {collections_count(results['typed'])}, errors "
          f"{results['errors']}; {M.SERVE_EVICTIONS.value - ev0:.0f} "
          f"evictions, {M.SERVE_READMITS.value - rm0:.0f} readmissions; "
          f"{batches:.0f} dispatches + {builds:.0f} bucket builds, "
          f"{launches} sm90 K1 launches ({counts['flash_attention.f32']} "
          f"f32)")
    check(not results["errors"], f"untyped failures: {results['errors']}")
    check(results["served"] > 0, "the flood served nothing")
    check(launches == CONFIG["num_layers"] * (batches + builds)
          and counts["flash_attention.f32"] == 0,
          f"{launches} sm90 launches for {batches} dispatches and {builds} "
          f"builds, want {CONFIG['num_layers']} each")
    check(M.SERVE_EVICTIONS.value > ev0, "no eviction under the budget")
    reg.close()
    return {"counts": counts, "readmit_ms": t_readmit * 1e3,
            "evict_ms": t_evict * 1e3, "served": results["served"]}


def collections_count(xs):
    import collections
    return dict(collections.Counter(xs))


def phase_programs(mx, serve_obs):
    """Phase 17: (a)-(e)."""
    import gc
    import torch
    t0 = time.perf_counter()
    start = lm_start(mx)
    lm = phase_introspect(mx, start)
    gc.collect()
    torch.cuda.empty_cache()
    rn = phase_resnet_flops(mx)
    tune = phase_tune(mx, start, serve_obs)
    del start
    dec = phase_decode(mx)
    reg = phase_registry(mx)
    print(f"  phase 17: LM MFU {lm['mfu_pct']} % ({lm['step_time_ms']} ms), "
          f"ResNet-50 MFU {100 * rn['mfu']:.4f} %, tune {tune['runs']} runs, "
          f"decode {dec['tokens_s']:.1f} tokens/s, registry readmit "
          f"{reg['readmit_ms']:.1f} ms; {time.perf_counter() - t0:.1f} s")
    return reg["counts"]


# ---------------------------------------------------------------------------
# phase 18: RNN and sequences
# ---------------------------------------------------------------------------
# (a): example/gluon/word_language_model.py's RNNModel at the upstream
# word_language_model README's large setting (embed and hidden 1500, 2
# layers, dropout 0.65, untied), PTB's vocabulary, this repo's example's
# batch, bptt, lr and clip
RNN_LM = dict(vocab=10000, embed=1500, hidden=1500, layers=2, dropout=0.65)
RNN_BATCH = 32
RNN_BPTT = 35
RNN_LR = 1.0
RNN_CLIP = 0.25         # times bptt x batch, as the example clips
RNN_STEPS = 20
RNN_TIMED = 15          # the last 15 steps' median and spread
RNN_GEN = 20            # greedy tokens at B=1, as the example's tail
# (b): the RNN op and the CTC loss on the card against the CPU, float64
RNN_CHECK = dict(T=35, B=4, hidden=1500, layers=2)
CTC_CHECK = dict(T=64, N=32, C=1500, L=40)
TOL_RECURRENT = 1e-4    # relative to each output's largest magnitude
# (c): example/rnn/lstm_bucketing.py at its defaults, one epoch
BUCKETS = [10, 20, 30, 40, 50, 60]
BUCKET_LM = dict(layers=2, hidden=200, embed=200, batch=32, lr=0.01)
FUSED_BUCKET = 30
FUSED_BATCHES = 3
TOL_UNFUSE = 1e-4
# (d): CellModel over two LSTMCell(1500), PTB's vocabulary
CELL_DECODE = dict(vocab=10000, hidden=1500, slots=16, page_tokens=16,
                   pages=4, seqs=8, new=32, prompt=(4, 16), first=4, join=2)
# (d)'s rate: a backlog that keeps the 16 slots full for seconds
CELL_RATE = dict(seqs=256, new=(128, 384), prompt=(4, 16), pages=25)
# (a): one step's gradients on the card against the CPU, float32, relative
# to each gradient's largest magnitude
TOL_LM_GRAD = 1e-4


def markov_tokens(n, vocab, seed=0):
    """``example/gluon/word_language_model.py``'s synthetic corpus: a
    random transition per id, taken 9 times in 10."""
    import numpy as np
    rs = np.random.RandomState(seed)
    trans = rs.randint(0, vocab, (vocab,))
    toks = [int(rs.randint(0, vocab))]
    for _ in range(n - 1):
        toks.append(int(trans[toks[-1]]) if rs.rand() < 0.9
                    else int(rs.randint(0, vocab)))
    return toks


def markov_sentences(n=2000, vocab=200, seed=0):
    """``example/rnn/lstm_bucketing.py``'s synthetic corpus: sentences of
    5 to 39 ids following one transition per id."""
    import numpy as np
    rs = np.random.RandomState(seed)
    trans = rs.randint(1, vocab, (vocab,))
    sents = []
    for _ in range(n):
        s = [int(rs.randint(1, vocab))]
        for _ in range(rs.randint(5, 40) - 1):
            s.append(int(trans[s[-1]]))
        sents.append(s)
    return sents


def rnn_model(mx, **over):
    """The example's ``RNNModel`` on the port: Embedding, dropout, the
    fused 2-layer LSTM, dropout, Dense (``over`` replaces entries of
    ``RNN_LM`` or passes the Block's ``prefix``)."""
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon import nn, rnn

    class RNNModel(gluon.Block):
        def __init__(self, vocab, embed, hidden, layers, dropout, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.drop = nn.Dropout(dropout)
                self.encoder = nn.Embedding(vocab, embed)
                self.rnn = rnn.LSTM(hidden, layers, dropout=dropout,
                                    input_size=embed)
                self.decoder = nn.Dense(vocab, in_units=hidden)
                self.hidden = hidden

        def forward(self, inputs, hidden):
            emb = self.drop(self.encoder(inputs))
            output, hidden = self.rnn(emb, hidden)
            output = self.drop(output)
            return self.decoder(output.reshape((-1, self.hidden))), hidden

        def begin_state(self, *args, **kwargs):
            return self.rnn.begin_state(*args, **kwargs)

    return RNNModel(**dict(RNN_LM, **over))


def lm_grad_check(mx, model, x, y):
    """One hybridized step of the LM without dropout, on ``model``'s
    weights and the batch (``x``, ``y``), from zero states: every
    parameter's gradient on the card against the CPU's, float32.  Returns
    {name: relative error}."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import autograd, gluon
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    xn, yn = mx.nd.asnumpy(x), mx.nd.asnumpy(y)
    grads = []
    for ctx in (mx.gpu(0), mx.cpu()):
        net = rnn_model(mx, dropout=0.0, prefix="lmcheck_")
        net.initialize(mx.init.Zero(), ctx=ctx)
        names = list(model.collect_params().keys())
        for p, src in zip(net.collect_params().values(),
                          model.collect_params().values()):
            p.set_data(src.data().detach())
        net.hybridize()
        hidden = net.begin_state(batch_size=xn.shape[1], ctx=ctx)
        with autograd.record():
            out, _ = net(mx.nd.array(xn, ctx=ctx), hidden)
            L = loss_fn(out, mx.nd.array(yn, ctx=ctx))
        L.backward()
        grads.append([p.grad().detach().cpu() for p in
                      net.collect_params().values()])
        del net
    check(all(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
              for g in grads[0]), "a gradient on the card is zero or not "
          "finite")
    return {n: rel_err(a, b) for n, a, b in zip(names, *grads)}


def phase_rnn_lm(mx):
    """(a) the full-width LSTM language model: training steps, one step
    under torch.profiler, and stateful greedy decoding."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import autograd, gluon
    ctx = mx.gpu(0)
    B, T = RNN_BATCH, RNN_BPTT
    toks = markov_tokens(T * B * (RNN_STEPS + 4) + 1, RNN_LM["vocab"])
    n = len(toks) // B
    data = mx.nd.array(np.asarray(toks[:n * B], np.float32).reshape(B, n).T,
                       ctx=ctx)
    mx.random.seed(0)
    model = rnn_model(mx)
    model.initialize(mx.init.Xavier(), ctx=ctx)
    model.hybridize()
    params = model.collect_params()
    n_params = sum(int(np.prod(p.shape)) for p in params.values())
    start = {n: p.data().detach().clone() for n, p in params.items()}
    trainer = gluon.Trainer(params, "sgd", {"learning_rate": RNN_LR,
                                            "momentum": 0, "wd": 0})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    live = [p for p in params.values() if p.grad_req != "null"]
    state = {"hidden": model.begin_state(batch_size=B, ctx=ctx), "i": 0}

    def step():
        i = state["i"] * T
        state["i"] += 1
        x = data[i:i + T]
        y = data[i + 1:i + 1 + T].reshape((-1,))
        hidden = [h.detach() for h in state["hidden"]]
        with autograd.record():
            out, hidden = model(x, hidden)
            L = loss_fn(out, y)
        L.backward()
        gluon.utils.clip_global_norm([p.grad() for p in live],
                                     RNN_CLIP * T * B)
        trainer.step(T * B)
        state["hidden"] = hidden
        return float(L.detach().mean())

    losses, walls = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(RNN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step())
        walls.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    timed = walls[-RNN_TIMED:]
    step_ms = statistics.median(timed)
    rows = kernel_rows(step)
    launches = sum(r[1] for r in rows)
    busy = sum(r[0] for r in rows)
    print(f"  (a) RNNModel (vocab {RNN_LM['vocab']}, embed "
          f"{RNN_LM['embed']}, 2-layer LSTM {RNN_LM['hidden']}, dropout "
          f"{RNN_LM['dropout']}; {n_params / 1e6:.1f} M parameters, "
          f"float32, TF32 off), hybridized, SGD lr {RNN_LR}, clip "
          f"{RNN_CLIP} x bptt x batch, B={B}, bptt {T}: {RNN_STEPS} steps")
    print(f"      a step (last {RNN_TIMED}, host clock, synchronized): "
          f"median {step_ms:.2f} ms (min {min(timed):.2f}, max "
          f"{max(timed):.2f}); first step {walls[0]:.1f} ms; "
          f"{T * B / step_ms * 1e3:.0f} tokens/s; peak {peak:.2f} GiB")
    if rows:
        print(f"      one profiled step: {launches} kernel launches, "
              f"{busy:.2f} ms of kernels, device idle "
              f"{100 * max(0.0, 1 - busy / step_ms):.1f} % of the median "
              f"step")
        for ms, count, key in rows[:6]:
            print(f"        {ms:8.3f} ms  x{count:<5d} {key[:90]}")
    else:
        print("      launches and idle share not measured: torch.profiler "
              "saw no device time")
    print(f"      loss first {losses[0]:.4f}, last {losses[-1]:.4f}, "
          f"all: {[round(v, 3) for v in losses]}")
    check(all(math.isfinite(v) for v in losses), "LM loss not finite")
    check(losses[-1] < losses[0], f"LM loss did not fall: {losses}")
    # every parameter took its share of the steps, the LSTM's too
    moved = {n: float((p.data().detach() - start[n]).abs().max())
             for n, p in params.items()}
    del start
    least = min(moved, key=moved.get)
    print(f"      {sum(v > 0 for v in moved.values())} of {len(moved)} "
          f"parameters moved over the {RNN_STEPS + 1} steps (the least: "
          f"{least}, by {moved[least]:.3e} at most)")
    check(all(v > 0 for v in moved.values()),
          f"parameters that did not move: "
          f"{[n for n, v in moved.items() if v == 0]}")
    t0 = time.perf_counter()
    grad_errs = lm_grad_check(mx, model, data[:T], data[1:T + 1].reshape(
        (-1,)))
    worst = max(grad_errs, key=grad_errs.get)
    print(f"      one hybridized step without dropout on the trained "
          f"weights and the first batch: the gradients of all "
          f"{len(grad_errs)} parameters on the card against the CPU, "
          f"float32: max relative error {grad_errs[worst]:.3e} ({worst}; "
          f"{time.perf_counter() - t0:.1f} s)")
    check(grad_errs[worst] <= TOL_LM_GRAD,
          f"LM gradients on the card against the CPU: {grad_errs}")
    # stateful greedy decoding at B=1, as the example's tail
    hidden = model.begin_state(batch_size=1, ctx=ctx)
    cur, gen, tok_ms = [float(toks[0])], [], []
    for _ in range(RNN_GEN):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, hidden = model(mx.nd.array([cur], ctx=ctx), hidden)
        nxt = int(torch.argmax(logits[-1]))
        tok_ms.append((time.perf_counter() - t0) * 1e3)
        gen.append(nxt)
        cur = [float(nxt)]
    print(f"      {RNN_GEN} greedy tokens at B=1 carrying the state: "
          f"median {statistics.median(tok_ms[1:]):.2f} ms a token; {gen}")
    check(len(gen) == RNN_GEN and all(0 <= t < RNN_LM["vocab"]
                                      for t in gen), "decode malformed")
    out = {"step_ms": step_ms, "step_min": min(timed),
           "step_max": max(timed), "tokens_s": T * B / step_ms * 1e3,
           "launches": launches if rows else None,
           "busy_ms": busy if rows else None, "loss0": losses[0],
           "loss1": losses[-1], "token_ms": statistics.median(tok_ms[1:]),
           "peak_gib": peak, "grad_err": grad_errs[worst]}
    del model, trainer, data
    return out


def rel_err(got, want):
    """max |got - want| over max |want| (or 1 when that is 0)."""
    import torch
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    scale = float(want.abs().max()) or 1.0
    return float((got - want).abs().max()) / scale


def card_and_cpu(mx, fn, arrays):
    """``fn`` on the card and on the CPU over the same float64 arrays:
    (outputs and input gradients of sum(out * w), for each device)."""
    import numpy as np
    import torch
    res = []
    for ctx in (mx.gpu(0), mx.cpu()):
        xs = [mx.nd.attach_grad(mx.nd.array(a, ctx=ctx, dtype="float64"))
              if a.dtype == np.float64 else mx.nd.array(a, ctx=ctx)
              for a in arrays]
        with mx.autograd.record():
            outs = fn(*xs)
            rs = np.random.RandomState(3)
            head = sum((o * torch.as_tensor(rs.uniform(
                0.5, 1.5, tuple(o.shape)), device=o.device)).sum()
                for o in outs)
        head.backward()
        res.append([o.detach() for o in outs] +
                   [mx.nd.grad(x) for x in xs if x.requires_grad])
    return res


def phase_recurrent_card(mx):
    """(b) the RNN op (lstm, gru) and the CTC loss on the card against the
    port's CPU run of the same function, float64."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.ops.sequence import rnn_param_size
    c = RNN_CHECK
    H, L = c["hidden"], c["layers"]
    errs = {}
    for mode in ("lstm", "gru"):
        rs = np.random.RandomState(18)
        n = rnn_param_size(L, H, H, False, mode)
        arrays = [rs.normal(size=(c["T"], c["B"], H)),
                  rs.uniform(-1, 1, n) / math.sqrt(H),
                  rs.normal(size=(L, c["B"], H)) * 0.5]
        if mode == "lstm":
            arrays.append(rs.normal(size=(L, c["B"], H)) * 0.5)

        def fn(*xs, mode=mode):
            return mx.nd.RNN(*xs, state_size=H, num_layers=L, mode=mode,
                             state_outputs=True)
        t0 = time.perf_counter()
        card, cpu = card_and_cpu(mx, fn, arrays)
        errs[mode] = max(rel_err(a, b) for a, b in zip(card, cpu))
        print(f"  (b) RNN {mode}, T={c['T']}, B={c['B']}, {L}x{H}, float64: "
              f"outputs and the gradients of data, parameters and states, "
              f"card against CPU: max relative error {errs[mode]:.3e} "
              f"({time.perf_counter() - t0:.1f} s)")
    k = CTC_CHECK
    rs = np.random.RandomState(19)
    data_len = rs.randint(48, k["T"] + 1, k["N"]).astype(np.float32)
    label_len = rs.randint(10, k["L"] + 1, k["N"]).astype(np.float32)
    data_len[0], label_len[0] = 20, 30          # an impossible alignment
    label = rs.randint(1, k["C"], (k["N"], k["L"])).astype(np.float32)
    arrays = [rs.normal(size=(k["T"], k["N"], k["C"])), label, data_len,
              label_len]

    def ctc(x, lab, dl, ll):
        return [mx.nd.contrib.ctc_loss(x, lab, dl, ll, use_data_lengths=True,
                                       use_label_lengths=True)]
    card, cpu = card_and_cpu(mx, ctc, arrays)
    errs["ctc"] = max(rel_err(a, b) for a, b in zip(card, cpu))
    print(f"      _contrib_ctc_loss, T={k['T']}, N={k['N']}, C={k['C']}, "
          f"with lengths (row 0 impossible: {float(card[0][0]):.2f}), "
          f"float64: loss and its gradient, card against CPU: max relative "
          f"error {errs['ctc']:.3e}")
    check(max(errs.values()) <= TOL_RECURRENT,
          f"recurrent ops on the card against the CPU: {errs}")
    check(1e5 < float(card[0][0]) < 2e5, "the impossible row's loss")
    # the op's forward and backward in float32, beside torch's ctc_loss on
    # the same inputs: with (b)'s impossible row (torch's kernel and the
    # recursion), then with row 0 made possible (torch's kernel alone),
    # its labels and lengths on the card and on the host
    dev = card[0][0].device
    x = torch.tensor(arrays[0], dtype=torch.float32, device=dev,
                     requires_grad=True)
    fit = [a.copy() for a in arrays[1:]]
    fit[1][0], fit[2][0] = k["T"], 10
    cases = {"odd row": [torch.tensor(a, device=dev) for a in arrays[1:]],
             "card": [torch.tensor(a, device=dev) for a in fit],
             "host": [torch.tensor(a) for a in fit]}

    def op(lab, dl, ll):
        mx.nd.contrib.ctc_loss(x, lab, dl, ll, use_data_lengths=True,
                               use_label_lengths=True).sum().backward()

    def library():
        lab, dl, ll = cases["card"]
        torch.nn.functional.ctc_loss(
            torch.log_softmax(x, -1), lab.long(), dl.long(), ll.long(),
            reduction="none", zero_infinity=True).sum().backward()
    ctc_ms = {name: host_clock_ms(lambda a=a: op(*a))
              for name, a in cases.items()}
    ctc_ms["torch"] = host_clock_ms(library)
    print(f"      CTC forward and backward, float32, host clock "
          f"(synchronized, median of 5): the op {ctc_ms['odd row']:.3f} ms "
          f"with the impossible row (torch's kernel and optax's "
          f"recursion), {ctc_ms['card']:.3f} ms without it (labels on the "
          f"card: one wait to find the odd rows), {ctc_ms['host']:.3f} ms "
          f"with labels and lengths on the host; torch's ctc_loss alone "
          f"{ctc_ms['torch']:.3f} ms")
    cap_err, ctc_ms["captured"] = ctc_capture(mx, arrays)
    print(f"      CTC forward captured in a CUDA graph (optax's recursion "
          f"for every row, float64, (b)'s inputs): each row within "
          f"{cap_err:.3e} of the eager op, a replay "
          f"{ctc_ms['captured']:.3f} ms of device time")
    check(cap_err <= TOL_RECURRENT, f"the captured CTC differs: {cap_err}")
    return errs, ctc_ms


def ctc_capture(mx, arrays):
    """The CTC op's forward captured in a CUDA graph on the card against
    the eager op, row by row: (largest relative error, ms a replay)."""
    import torch
    x, lab, dl, ll = (torch.tensor(a, device="cuda") for a in arrays)

    def fwd():
        return mx.nd.contrib.ctc_loss(x, lab, dl, ll, use_data_lengths=True,
                                      use_label_lengths=True)
    want = fwd()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fwd()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = fwd()
    graph.replay()
    torch.cuda.synchronize()
    err = float(((got - want).abs() / want.abs()).max())
    return err, device_ms(graph.replay)


class KeyedIter:
    """A ``BucketSentenceIter`` that records the bucket of each batch it
    hands out (the fit loop's per-bucket times), and stops after ``limit``
    batches when given."""

    def __init__(self, it, limit=None):
        self.it, self.keys, self.limit, self.count = it, [], limit, 0
        self.provide_data, self.provide_label = it.provide_data, \
            it.provide_label
        self.default_bucket_key = it.default_bucket_key
        self.batch_size = it.batch_size

    def __iter__(self):
        return self

    def reset(self):
        self.it.reset()
        self.count = 0

    def __next__(self):
        if self.limit is not None and self.count >= self.limit:
            raise StopIteration
        b = self.it.next()
        self.count += 1
        self.keys.append(b.bucket_key)
        return b

    next = __next__


def bucket_sym_gen(mx, cell, vocab, fused=False):
    """``example/rnn/lstm_bucketing.py``'s ``sym_gen`` over ``cell``."""
    c = BUCKET_LM

    def sym_gen(seq_len):
        data = mx.sym.Variable("data")
        label = mx.sym.Variable("softmax_label")
        embed = mx.sym.Embedding(data, input_dim=vocab,
                                 output_dim=c["embed"], name="embed")
        cell.reset()
        outputs, _ = cell.unroll(seq_len, inputs=embed, merge_outputs=True)
        pred = mx.sym.Reshape(outputs, shape=(-1, c["hidden"]))
        pred = mx.sym.FullyConnected(pred, num_hidden=vocab, name="pred")
        label = mx.sym.Reshape(label, shape=(-1,))
        pred = mx.sym.SoftmaxOutput(pred, label, name="softmax")
        return pred, ("data",), ("softmax_label",)
    return sym_gen


def phase_bucketing(mx):
    """(c) ``BucketingModule.fit`` at ``lstm_bucketing.py``'s defaults,
    then the same stack as a ``FusedRNNCell`` against its ``unfuse()``."""
    import random
    import numpy as np
    import torch
    from mxnet_tpu_torch.ops.sequence import _unpack_rnn_params
    c = BUCKET_LM
    random.seed(0)
    np.random.seed(0)
    corpus = markov_sentences()
    split = int(0.9 * len(corpus))
    train = mx.rnn.BucketSentenceIter(corpus[:split], c["batch"],
                                      buckets=list(BUCKETS), invalid_label=0)
    val = mx.rnn.BucketSentenceIter(corpus[split:], c["batch"],
                                    buckets=list(BUCKETS), invalid_label=0)
    vocab = max(max(s) for s in corpus) + 1
    vocab = max(vocab, 201)        # the example's len(vocab) + 1
    stack = mx.rnn.SequentialRNNCell()
    for i in range(c["layers"]):
        stack.add(mx.rnn.LSTMCell(num_hidden=c["hidden"],
                                  prefix=f"lstm_l{i}_"))
    mod = mx.mod.BucketingModule(bucket_sym_gen(mx, stack, vocab),
                                 default_bucket_key=train.default_bucket_key,
                                 context=mx.gpu(0))
    mod.bind(train.provide_data, train.provide_label)
    mod.init_params(mx.init.Xavier(factor_type="in", magnitude=2.34))
    ppl0 = dict(mod.score(val, mx.metric.Perplexity(ignore_label=0)))
    keyed = KeyedIter(train)
    marks, per_bucket = [], {}

    def on_batch(param):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        if len(marks) > 1:
            key = keyed.keys[len(marks) - 1]
            per_bucket.setdefault(key, []).append(
                (marks[-1] - marks[-2]) * 1e3)

    t0 = time.perf_counter()
    mod.fit(keyed, eval_metric=mx.metric.Perplexity(ignore_label=0),
            kvstore="local", optimizer="adam",
            optimizer_params={"learning_rate": c["lr"]},
            initializer=mx.init.Xavier(factor_type="in", magnitude=2.34),
            num_epoch=1, batch_end_callback=on_batch)
    t_fit = time.perf_counter() - t0
    ppl1 = dict(mod.score(val, mx.metric.Perplexity(ignore_label=0)))
    bound = sorted(mod._buckets)
    print(f"  (c) BucketingModule.fit, lstm_bucketing.py's defaults (2 "
          f"LSTMCell of {c['hidden']}, embed {c['embed']}, vocab {vocab}, "
          f"B={c['batch']}, Adam lr {c['lr']}): one epoch of "
          f"{len(keyed.keys)} batches in {t_fit:.2f} s; buckets bound "
          f"{bound}")
    print("      ms a batch by bucket (median, host clock, synchronized; "
          "a bucket's first batch binds the next one): " + ", ".join(
              f"{k}: {statistics.median(v):.1f} ({len(v)})"
              for k, v in sorted(per_bucket.items())))
    print(f"      validation perplexity before {ppl0['perplexity']:.2f}, "
          f"after {ppl1['perplexity']:.2f}")
    check(ppl1["perplexity"] < ppl0["perplexity"],
          f"perplexity did not fall: {ppl0} -> {ppl1}")
    # the same stack as one FusedRNNCell, one bucket, a few batches
    random.seed(0)
    np.random.seed(0)
    one = mx.rnn.BucketSentenceIter(corpus[:split], c["batch"],
                                    buckets=[FUSED_BUCKET], invalid_label=0)
    fused = mx.rnn.FusedRNNCell(c["hidden"], num_layers=c["layers"],
                                mode="lstm", prefix="lstm_")
    fmod = mx.mod.BucketingModule(bucket_sym_gen(mx, fused, vocab),
                                  default_bucket_key=FUSED_BUCKET,
                                  context=mx.gpu(0))
    fmod.bind(one.provide_data, one.provide_label)
    rs = np.random.RandomState(20)
    size = mx.ops.sequence.rnn_param_size(c["layers"], c["embed"],
                                          c["hidden"], False, "lstm")
    # the FusedRNN initializer (init None) fails in both packages: draw
    # the packed vector here
    fmod.init_params(mx.init.Xavier(factor_type="in", magnitude=2.34),
                     arg_params={"lstm_parameters": mx.nd.array(
                         rs.uniform(-0.08, 0.08, size).astype(np.float32),
                         ctx=mx.cpu())}, allow_missing=True)
    fmod.fit(KeyedIter(one, FUSED_BATCHES), kvstore="local",
             optimizer="adam", optimizer_params={"learning_rate": c["lr"]},
             eval_metric=mx.metric.Perplexity(ignore_label=0), num_epoch=1)
    args, _ = fmod.get_params()
    one.reset()
    batch = one.next()
    fmod.forward(batch, is_train=False)
    want = fmod.get_outputs()[0]
    unfused = fused.unfuse()
    umod = mx.mod.Module(bucket_sym_gen(mx, unfused, vocab)(FUSED_BUCKET)[0],
                         context=mx.gpu(0))
    umod.bind(one.provide_data, one.provide_label, for_training=False)
    ws, rws, bws, brs = _unpack_rnn_params(
        args["lstm_parameters"], c["layers"], c["embed"], c["hidden"],
        False, "lstm")
    uargs = {k: v for k, v in args.items() if k != "lstm_parameters"}
    for i in range(c["layers"]):
        for name, v in (("i2h_weight", ws[i][0]), ("h2h_weight", rws[i][0]),
                        ("i2h_bias", bws[i][0]), ("h2h_bias", brs[i][0])):
            uargs[f"lstm_l{i}_{name}"] = v.clone()
    umod.set_params(uargs, {})
    umod.forward(batch, is_train=False)
    got = umod.get_outputs()[0]
    err = rel_err(got, want)
    print(f"      FusedRNNCell (2 x {c['hidden']}, one bucket of "
          f"{FUSED_BUCKET}, {FUSED_BATCHES} Adam batches) against its "
          f"unfuse() stack on the trained weights: max relative error "
          f"{err:.3e}")
    check(err <= TOL_UNFUSE, f"unfuse() differs by {err:.3e}")
    return {"batches": len(keyed.keys), "fit_s": t_fit, "buckets": bound,
            "ms": {k: statistics.median(v) for k, v in per_bucket.items()},
            "ppl0": ppl0["perplexity"], "ppl1": ppl1["perplexity"],
            "unfuse_err": err}


def phase_cell_decode(mx):
    """(d) ``DecodeEngine`` over ``CellModel`` of two ``LSTMCell(1500)``:
    staggered requests, each against its solo run."""
    import gc
    import numpy as np
    import torch
    from mxnet_tpu_torch.serving.decode import CellModel, DecodeEngine
    gc.collect()
    torch.cuda.empty_cache()
    d = CELL_DECODE
    stack = mx.rnn.SequentialRNNCell()
    for i in range(2):
        stack.add(mx.rnn.LSTMCell(num_hidden=d["hidden"],
                                  prefix=f"lstm_l{i}_"))
    model = CellModel(stack, vocab=d["vocab"], seed=0)
    params = model.init_params()
    kw = dict(params=params, slots=d["slots"], page_tokens=d["page_tokens"],
              max_pages=d["pages"])
    eng = DecodeEngine(model, warmup=False, name="cell", **kw)
    t0 = time.perf_counter()
    n_keys = eng.warmup()
    t_warm = time.perf_counter() - t0
    rs = np.random.RandomState(21)
    seqs = [([int(t) for t in rs.randint(0, d["vocab"], rs.randint(
        d["prompt"][0], d["prompt"][1] + 1))], d["new"])
        for _ in range(d["seqs"])]
    st0 = eng.stats()
    futs = [eng.submit(*s) for s in seqs[:d["first"]]]
    nxt, k, walls = d["first"], 0, []
    t0 = time.perf_counter()
    while nxt < d["seqs"] or eng.pending():
        ts = time.perf_counter()
        eng.step()
        walls.append((time.perf_counter() - ts) * 1e3)
        k += 1
        if nxt < d["seqs"] and k % d["join"] == 0:
            futs.append(eng.submit(*seqs[nxt]))
            nxt += 1
    t_traffic = time.perf_counter() - t0
    outs = [f.result(timeout=60) for f in futs]
    st = eng.stats()
    steps, replays = st["steps"] - st0["steps"], st["replays"] - st0[
        "replays"]
    tokens = sum(len(o) for o in outs)
    eng.close()
    solo = DecodeEngine(model, warmup=False, name="cell-solo", **kw)
    same = sum(solo.generate(*s) == o for s, o in zip(seqs, outs))
    solo.close()
    print(f"  (d) DecodeEngine(CellModel(2 x LSTMCell({d['hidden']})), vocab "
          f"{d['vocab']}, {d['slots']} slots, pages of {d['page_tokens']}, "
          f"{d['pages']} pages): {n_keys} keys captured in {t_warm:.2f} s; "
          f"{d['seqs']} staggered requests of {d['new']} tokens: {steps} "
          f"steps, {replays} replays, {tokens} tokens, a step's host clock "
          f"median {statistics.median(walls):.3f} ms; tokens equal to the "
          f"solo run for {same} of {d['seqs']}")
    check(replays == steps, f"{replays} replays for {steps} steps")
    check(all(len(o) == d["new"] for o in outs), "a request ended short")
    check(same == d["seqs"], f"{d['seqs'] - same} requests differ from "
          "their solo runs")
    rate = cell_decode_rate(model, params, d["slots"], d["page_tokens"])
    return dict(rate, step_ms=statistics.median(walls), same=same)


def cell_decode_rate(model, params, slots, page_tokens):
    """(d)'s rate: ``CELL_RATE["seqs"]`` sequences queued at once on an
    engine with room for them, so that its slots stay full for seconds
    while sequences leave and join."""
    import collections
    import numpy as np
    from mxnet_tpu_torch.serving.decode import DecodeEngine
    r = CELL_RATE
    eng = DecodeEngine(model, params=params, slots=slots,
                       page_tokens=page_tokens, max_pages=r["pages"],
                       max_queue=r["seqs"], warmup=False, name="cell-rate")
    n_keys = eng.warmup()
    rs = np.random.RandomState(22)
    seqs = [([int(t) for t in rs.randint(0, model.vocab, rs.randint(
        r["prompt"][0], r["prompt"][1] + 1))],
        int(rs.randint(r["new"][0], r["new"][1] + 1))) for _ in range(
            r["seqs"])]
    st0 = eng.stats()
    futs = [eng.submit(*s) for s in seqs]
    walls, live, keys = [], [], collections.Counter()
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        n = eng.step()
        if n == 0:
            break
        walls.append((time.perf_counter() - ts) * 1e3)
        live.append(n)
        keys[eng._key] += 1
    t_traffic = time.perf_counter() - t0
    outs = [f.result(timeout=60) for f in futs]
    st = eng.stats()
    steps, replays = st["steps"] - st0["steps"], st["replays"] - st0[
        "replays"]
    tokens = sum(len(o) for o in outs)
    top = max(keys, key=keys.get)
    dev_ms = device_ms(lambda: eng._compiled[top]["graph"].replay())
    eng.close()
    mean_live = statistics.mean(live)
    print(f"      the rate: {r['seqs']} sequences of {r['new'][0]}-"
          f"{r['new'][1]} new tokens queued at once ({r['pages']} pages, "
          f"{n_keys} keys captured): {steps} steps, {replays} replays, "
          f"{tokens} tokens in {t_traffic:.2f} s ({tokens / t_traffic:.1f} "
          f"tokens/s), {mean_live:.2f} of {slots} slots live a step on "
          f"average; a step's host clock median {statistics.median(walls):.3f}"
          f" ms (p90 {percentile(walls, 90):.3f}); the most used key {top} "
          f"({keys[top]} steps) replays in {dev_ms:.4f} ms of device time")
    check(replays == steps, f"{replays} replays for {steps} steps")
    check(all(len(o) == s[1] for o, s in zip(outs, seqs)),
          "a sequence ended short")
    check(mean_live >= 0.9 * slots, f"the backlog kept {mean_live:.2f} of "
          f"{slots} slots live")
    return {"tokens_s": tokens / t_traffic, "rate_s": t_traffic,
            "rate_tokens": tokens, "live": mean_live,
            "rate_step_ms": statistics.median(walls), "device_ms": dev_ms}


def phase_recurrent(mx):
    """Phase 18: the recurrent slice, every kernel count set to 0 before
    its main path (a), read after it: the path runs no flash kernel."""
    import torch
    card = card_line()
    print(f"  {card}")
    torch.cuda.synchronize()
    reset_counts()
    lm = phase_rnn_lm(mx)
    counts = read_counts()
    print(f"      kernel launches counted on (a)'s path: {counts}")
    check(all(v == 0 for v in counts.values()),
          "the recurrent path launched a counted kernel")
    errs, ctc_ms = phase_recurrent_card(mx)
    bucket = phase_bucketing(mx)
    dec = phase_cell_decode(mx)
    return counts, {"card": card, "lm": lm, "errs": errs,
                    "ctc_ms": ctc_ms, "bucketing": bucket, "decode": dec}


# -- phase 19: detection ---------------------------------------------------
RCNN = dict(height=600, width=1000, classes=21, rois=128, pooled=(7, 7),
            stride=16, scales=(2.0, 4.0, 8.0), ratios=(0.5, 1.0, 2.0),
            steps=8, lr=0.003, box_scale=4, backbone="vgg16")
SSD = dict(classes=3, size=32, batch=16, lr=0.005, batches=20)
# upstream example/ssd's ssd_300 over VGG16-reduced: 6 maps, 8,732 anchors
SSD300 = dict(maps=(38, 19, 10, 5, 3, 1),
              sizes=((.1, .141), (.2, .272), (.37, .447), (.54, .619),
                     (.71, .79), (.88, .961)),
              ratios=((1, 2, .5), (1, 2, .5, 3, 1 / 3), (1, 2, .5, 3, 1 / 3),
                      (1, 2, .5, 3, 1 / 3), (1, 2, .5), (1, 2, .5)),
              steps=(8, 16, 32, 64, 100, 300), batch=32, classes=21,
              gts=8, anchors=8732)
TOL_SSD_CPU = 1e-4      # (b): outputs and gradients, of each one's largest
SSD_BN_FED_BIASES = ("c1_bias", "c2_bias", "c3_bias", "c4_bias")
TOL_BOX_CPU = 1e-6      # (c): decoded boxes and log targets, card vs CPU
TOL_CONTRIB = 1e-5      # (e): the op surface, card vs CPU, float32
IOU_OPS = {"corner": 23, "pixel": 25}   # float operations in one pair IoU


def rcnn_make_batch(rs, n, H, W, classes, scale):
    """``example/rcnn/train_end2end.py``'s ``make_batch`` at H x W: bright
    rectangles on noise, up to 2 an image, the example's widths times
    ``scale``, aspect by class (tall, wide, square)."""
    import numpy as np
    imgs = rs.normal(0, 0.1, (n, 3, H, W)).astype(np.float32)
    gt = np.zeros((n, 2, 5), np.float32)
    for i in range(n):
        for b in range(rs.randint(1, 3)):
            cls = rs.randint(1, classes)
            w = rs.randint(24, 64) * scale
            h = min({0: w * 2, 1: w // 2, 2: w}[cls % 3], H - 2)
            x1 = rs.randint(0, W - w)
            y1 = rs.randint(0, H - h)
            imgs[i, :, y1:y1 + h, x1:x1 + w] += rs.uniform(0.8, 1.2)
            gt[i, b] = [cls, x1, y1, x1 + w - 1, y1 + h - 1]
    return imgs, gt


def rcnn_anchors(fh, fw, stride, scales, ratios):
    """The example's ``gen_anchors``: (fh*fw*A, 4) pixel corners."""
    import numpy as np
    base = []
    ctr = (stride - 1) / 2.0
    for r in ratios:
        for s in scales:
            w = stride * s * np.sqrt(1.0 / r)
            h = stride * s * np.sqrt(r)
            base.append([ctr - 0.5 * (w - 1), ctr - 0.5 * (h - 1),
                         ctr + 0.5 * (w - 1), ctr + 0.5 * (h - 1)])
    base = np.asarray(base, np.float32)
    sxx, syy = np.meshgrid(np.arange(fw) * stride, np.arange(fh) * stride)
    shifts = np.stack([sxx, syy, sxx, syy], -1).reshape(-1, 1, 4)
    return (base[None] + shifts).reshape(-1, 4)


def rcnn_iou(a, b):
    import numpy as np
    iw = np.maximum(np.minimum(a[:, None, 2], b[None, :, 2])
                    - np.maximum(a[:, None, 0], b[None, :, 0]) + 1, 0)
    ih = np.maximum(np.minimum(a[:, None, 3], b[None, :, 3])
                    - np.maximum(a[:, None, 1], b[None, :, 1]) + 1, 0)
    inter = iw * ih
    aa = (a[:, 2] - a[:, 0] + 1) * (a[:, 3] - a[:, 1] + 1)
    bb = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    return inter / np.maximum(aa[:, None] + bb[None] - inter, 1e-9)


def rcnn_bbox_transform(anchors, gt):
    import numpy as np
    aw = anchors[:, 2] - anchors[:, 0] + 1
    ah = anchors[:, 3] - anchors[:, 1] + 1
    acx = anchors[:, 0] + 0.5 * (aw - 1)
    acy = anchors[:, 1] + 0.5 * (ah - 1)
    gw = gt[:, 2] - gt[:, 0] + 1
    gh = gt[:, 3] - gt[:, 1] + 1
    gcx = gt[:, 0] + 0.5 * (gw - 1)
    gcy = gt[:, 1] + 0.5 * (gh - 1)
    return np.stack([(gcx - acx) / aw, (gcy - acy) / ah,
                     np.log(gw / aw), np.log(gh / ah)], -1).astype(np.float32)


def rcnn_anchor_targets(anchors, gt_boxes, H, W, fg_iou=0.5, bg_iou=0.3):
    """The example's ``anchor_targets`` (RPN labels 1/0/-1 and deltas)."""
    import numpy as np
    K = anchors.shape[0]
    labels = -np.ones(K, np.float32)
    targets = np.zeros((K, 4), np.float32)
    inside = ((anchors[:, 0] >= -8) & (anchors[:, 1] >= -8) &
              (anchors[:, 2] < W + 8) & (anchors[:, 3] < H + 8))
    valid = gt_boxes[gt_boxes[:, 0] > 0][:, 1:]
    if len(valid) == 0:
        labels[inside] = 0
        return labels, targets
    iou = rcnn_iou(anchors, valid)
    best, argbest = iou.max(1), iou.argmax(1)
    labels[inside & (best < bg_iou)] = 0
    labels[inside & (best >= fg_iou)] = 1
    labels[iou.argmax(0)] = 1
    fg = labels == 1
    targets[fg] = rcnn_bbox_transform(anchors[fg], valid[argbest[fg]])
    return labels, targets


def rcnn_proposal_targets(rois, gt_boxes, per_img, classes, fg_iou=0.5):
    """The example's ``proposal_targets``: ``per_img`` sampled ROIs, their
    classes and per-class box targets."""
    import numpy as np
    valid = gt_boxes[gt_boxes[:, 0] > 0]
    n = rois.shape[0]
    labels = np.zeros(n, np.float32)
    targets = np.zeros((n, 4 * classes), np.float32)
    weights = np.zeros((n, 4 * classes), np.float32)
    if len(valid):
        iou = rcnn_iou(rois[:, 1:], valid[:, 1:])
        best, arg = iou.max(1), iou.argmax(1)
        fg = best >= fg_iou
        labels[fg] = valid[arg[fg], 0]
        t = rcnn_bbox_transform(rois[fg, 1:], valid[arg[fg], 1:])
        for j, cls in enumerate(labels[fg].astype(int)):
            row = np.where(fg)[0][j]
            targets[row, 4 * cls:4 * cls + 4] = t[j]
            weights[row, 4 * cls:4 * cls + 4] = 1.0
    fg_idx = np.where(labels > 0)[0]
    bg_idx = np.where(labels == 0)[0]
    keep = np.concatenate([fg_idx[:per_img // 2], bg_idx])[:per_img]
    if len(keep) < per_img:
        keep = np.concatenate([keep, np.zeros(per_img - len(keep), np.int64)])
    return keep, labels[keep], targets[keep], weights[keep]


def rcnn_nets(mx, ctx):
    """VGG16's ``features`` up to conv5_3 + ReLU (stride 16), the RPN head
    (a 512-wide 3x3 conv, 2A scores, 4A deltas) and the ROI head (fc 4096,
    4096, classes, 4 x classes), Xavier from seed 0."""
    from mxnet_tpu_torch.gluon import nn
    c = RCNN
    A = len(c["scales"]) * len(c["ratios"])
    mx.random.seed(0)
    vgg = mx.gluon.model_zoo.vision.get_model(c["backbone"])
    backbone = nn.HybridSequential(prefix="backbone_")
    backbone.add(*vgg.features[:30])   # 13 convs, 13 ReLUs, 4 pools
    ph, pw = c["pooled"]
    layers = [backbone,
              nn.Conv2D(512, 3, padding=1, activation="relu",
                        in_channels=512, prefix="rpn_conv_"),
              nn.Conv2D(2 * A, 1, in_channels=512, prefix="rpn_cls_"),
              nn.Conv2D(4 * A, 1, in_channels=512, prefix="rpn_reg_"),
              nn.Dense(4096, activation="relu", in_units=512 * ph * pw,
                       prefix="fc6_"),
              nn.Dense(4096, activation="relu", in_units=4096, prefix="fc7_"),
              nn.Dense(c["classes"], in_units=4096, prefix="cls_"),
              nn.Dense(4 * c["classes"], in_units=4096, prefix="reg_")]
    params = {}
    for blk in layers:
        blk.initialize(mx.init.Xavier(magnitude=2.0), ctx=ctx)
        params.update(blk.collect_params())
    return layers, params


def rcnn_step(mx, layers, trainer, x, gt, anchors, keep):
    """One step of the example's loop at ``RCNN``'s width: returns the
    four losses (tensors) and keeps the Proposal inputs, the feature map
    and the pooled ROIs of the step in ``keep``."""
    import numpy as np
    from mxnet_tpu_torch import autograd
    c = RCNN
    nd, ctx = mx.nd, x.device
    bb, rpn_conv, rpn_cls, rpn_reg, fc6, fc7, hcls, hreg = layers
    B, H, W = x.shape[0], c["height"], c["width"]
    A = len(c["scales"]) * len(c["ratios"])
    pairs = [rcnn_anchor_targets(anchors, gt[i], H, W) for i in range(B)]
    rpn_label = nd.array(np.stack([p[0] for p in pairs]), ctx=ctx)
    rpn_tgt = nd.array(np.stack([p[1] for p in pairs]), ctx=ctx)
    im_info = nd.array(np.tile([H, W, 1.0], (B, 1)).astype(np.float32),
                       ctx=ctx)
    with autograd.record():
        feat = bb(x)
        fh, fw = feat.shape[2], feat.shape[3]
        h = rpn_conv(feat)
        cls_raw, reg_raw = rpn_cls(h), rpn_reg(h)
        cls_sm = nd.reshape(nd.transpose(nd.reshape(
            cls_raw, shape=(B, 2, A, fh, fw)), axes=(0, 3, 4, 2, 1)),
            shape=(B, -1, 2))
        reg = nd.reshape(nd.transpose(nd.reshape(
            reg_raw, shape=(B, A, 4, fh, fw)), axes=(0, 3, 4, 1, 2)),
            shape=(B, -1, 4))
        logp = nd.log_softmax(cls_sm, axis=-1)
        mask_fg = nd.equal(rpn_label, 1)
        mask_val = nd.greater_equal(rpn_label, 0)
        picked = nd.pick(logp, nd.maximum(rpn_label, 0), axis=2)
        rpn_cls_loss = -nd.sum(picked * mask_val) / \
            nd.maximum(nd.sum(mask_val), 1)
        diff = nd.smooth_l1(reg - rpn_tgt, scalar=3.0)
        rpn_reg_loss = nd.sum(nd.sum(diff, axis=2) * mask_fg) / \
            nd.maximum(nd.sum(mask_fg), 1)
        with autograd.pause():
            probs = nd.reshape(nd.softmax(nd.reshape(
                cls_raw, shape=(B, 2, A * fh, fw)), axis=1),
                shape=(B, 2 * A, fh, fw))
            # Proposal at its defaults: 6000 before NMS, 300 after, 0.7
            rois = nd.Proposal(probs, reg_raw, im_info, scales=c["scales"],
                               ratios=c["ratios"], feature_stride=c["stride"])
            rois_np = nd.asnumpy(rois)
            keep_all, lab_l, tgt_l, wt_l = [], [], [], []
            for i in range(B):
                r = rois_np[rois_np[:, 0] == i]
                k, lab, t, w = rcnn_proposal_targets(r, gt[i], c["rois"],
                                                     c["classes"])
                base = np.where(rois_np[:, 0] == i)[0]
                keep_all.append(base[np.minimum(k, len(base) - 1)])
                lab_l.append(lab)
                tgt_l.append(t)
                wt_l.append(w)
            keep_idx = nd.array(np.concatenate(keep_all).astype(np.int32),
                                ctx=ctx)
            roi_label = nd.array(np.concatenate(lab_l), ctx=ctx)
            roi_tgt = nd.array(np.concatenate(tgt_l), ctx=ctx)
            roi_wt = nd.array(np.concatenate(wt_l), ctx=ctx)
            sel_rois = nd.take(rois, keep_idx)
        pooled = nd.ROIPooling(feat, sel_rois, pooled_size=c["pooled"],
                               spatial_scale=1.0 / c["stride"])
        hid = fc7(fc6(pooled))
        cls_pred, reg_pred = hcls(hid), hreg(hid)
        cls_loss = -nd.mean(nd.pick(nd.log_softmax(cls_pred, axis=-1),
                                    roi_label, axis=1))
        reg_loss = nd.sum(nd.smooth_l1(reg_pred - roi_tgt, scalar=1.0)
                          * roi_wt) / nd.maximum(nd.sum(roi_wt) / 4, 1)
        loss = rpn_cls_loss + rpn_reg_loss + cls_loss + reg_loss
    loss.backward()
    trainer.step(B)
    keep.update(probs=probs, reg_raw=reg_raw.detach(), im_info=im_info,
                feat=feat.detach(), sel_rois=sel_rois, n_rois=len(rois_np))
    return rpn_cls_loss, rpn_reg_loss, cls_loss, reg_loss


def phase_rcnn(mx):
    """(a) Faster R-CNN end to end at VGG16's width, 600x1000, B=1."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.kernels import nms as knms
    from mxnet_tpu_torch.kernels import roi_pooling as kroi
    c = RCNN
    ctx = mx.gpu(0)
    layers, params = rcnn_nets(mx, ctx)
    n_params = sum(int(np.prod(p.shape)) for p in params.values())
    trainer = gluon.Trainer(params, "sgd", {"learning_rate": c["lr"],
                                            "momentum": 0.9, "wd": 5e-4})
    rs = np.random.RandomState(0)
    fh, fw = c["height"], c["width"]
    for _ in range(4):           # VGG's four 2x2 pools floor the map
        fh, fw = fh // 2, fw // 2
    anchors = rcnn_anchors(fh, fw, c["stride"], c["scales"], c["ratios"])
    # one resident batch, as phase 10 trains ResNet-50 on one: the loss
    # then falls by what the step learns, not by what the batch holds
    imgs, gt = rcnn_make_batch(rs, 1, c["height"], c["width"], c["classes"],
                               c["box_scale"])
    x = mx.nd.array(imgs, ctx=ctx)
    keep, losses, walls, counts = {}, [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(c["steps"]):
        n0, f0, b0 = knms.LAUNCHES, kroi.FWD_LAUNCHES, kroi.BWD_LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ls = rcnn_step(mx, layers, trainer, x, gt, anchors, keep)
        vals = [float(v.detach()) for v in ls]
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        losses.append(vals)
        counts.append((knms.LAUNCHES - n0, kroi.FWD_LAUNCHES - f0,
                       kroi.BWD_LAUNCHES - b0))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms = statistics.median(walls[1:])
    rows = kernel_rows(lambda: rcnn_step(mx, layers, trainer, x, gt,
                                         anchors, {}))
    busy = sum(r[0] for r in rows)
    totals = [sum(v) for v in losses]
    print(f"  (a) Faster R-CNN, {c['backbone']} features to conv5_3 + ReLU "
          f"(stride 16, map {fh}x{fw}), RPN 512 wide, A={len(anchors) // (fh * fw)}, "
          f"ROI head fc 4096-4096, {c['classes']} classes; "
          f"{n_params / 1e6:.1f} M parameters, float32, TF32 off; "
          f"{c['height']}x{c['width']}, B=1, Proposal 6000 -> 300 at 0.7, "
          f"{c['rois']} ROIs to ROIPooling {c['pooled']} at 1/16, SGD lr "
          f"{c['lr']} momentum 0.9 wd 5e-4: {c['steps']} steps on one "
          f"batch of the example's synthetic boxes ({int((gt[0, :, 0] > 0).sum())} "
          f"ground truths)")
    print(f"      a step (2-{c['steps']}, host clock, synchronized): median "
          f"{step_ms:.2f} ms (min {min(walls[1:]):.2f}, max "
          f"{max(walls[1:]):.2f}); first {walls[0]:.1f} ms; peak "
          f"{peak:.2f} GiB")
    if rows:
        print(f"      one profiled step: {sum(r[1] for r in rows)} kernel "
              f"launches, {busy:.2f} ms of kernels, device idle "
              f"{100 * max(0.0, 1 - busy / step_ms):.1f} % of the median "
              f"step")
        for ms, count, key in rows[:6]:
            print(f"        {ms:8.3f} ms  x{count:<5d} {key[:90]}")
    else:
        print("      idle share not measured: torch.profiler saw no device "
              "time")
    for i, (v, n) in enumerate(zip(losses, counts)):
        print(f"      step {i + 1}: rpn_cls {v[0]:.4f} rpn_reg {v[1]:.4f} "
              f"rcnn_cls {v[2]:.4f} rcnn_reg {v[3]:.4f} total "
              f"{sum(v):.4f}; launches N {n[0]}, R forward {n[1]}, R "
              f"backward {n[2]}")
    check(all(math.isfinite(v) for ls in losses for v in ls),
          "R-CNN losses not finite")
    check(totals[-1] < totals[0], f"R-CNN loss did not fall: {totals}")
    check(all(n == (1, 1, 1) for n in counts),
          f"R-CNN kernel launches per step {counts}: want 1 N, 1 R forward, "
          f"1 R backward")
    check(keep["n_rois"] == 300, f"Proposal gave {keep['n_rois']} ROIs")
    return {"step_ms": step_ms, "step_min": min(walls[1:]),
            "step_max": max(walls[1:]), "first_ms": walls[0],
            "peak_gib": peak, "losses": [losses[0], losses[-1]],
            "busy_ms": busy if rows else None,
            "launches": sum(r[1] for r in rows) if rows else None,
            "idle": (1 - busy / step_ms) if rows else None,
            "n_params": n_params}, keep


def ssd_conv_act(mx, data, num_filter, name, stride=(1, 1)):
    c = mx.sym.Convolution(data, num_filter=num_filter, kernel=(3, 3),
                           stride=stride, pad=(1, 1), name=name)
    b = mx.sym.BatchNorm(c, name=name + "_bn")
    return mx.sym.Activation(b, act_type="relu", name=name + "_relu")


def build_ssd(mx, num_classes, ratios=(1.0, 2.0, 0.5)):
    """``example/ssd/train_ssd.py``'s ``build_ssd``: the 4-conv body,
    heads at 16x16 and 8x8 with priors, ``MultiBoxTarget``, the masked
    losses and ``MultiBoxDetection``."""
    data = mx.sym.Variable("data")
    label = mx.sym.Variable("label")
    body = ssd_conv_act(mx, data, 16, "c1")
    body = ssd_conv_act(mx, body, 32, "c2", stride=(2, 2))
    scale1 = ssd_conv_act(mx, body, 32, "c3")
    scale2 = ssd_conv_act(mx, scale1, 64, "c4", stride=(2, 2))
    cls_preds, loc_preds, anchors = [], [], []
    for i, (feat, sizes) in enumerate([(scale1, (0.2, 0.35)),
                                       (scale2, (0.5, 0.75))]):
        na = len(sizes) + len(ratios) - 1
        cp = mx.sym.Convolution(feat, num_filter=na * (num_classes + 1),
                                kernel=(3, 3), pad=(1, 1), name=f"clspred{i}")
        cp = mx.sym.transpose(cp, axes=(0, 2, 3, 1))
        cls_preds.append(mx.sym.Reshape(cp, shape=(0, -1, num_classes + 1)))
        lp = mx.sym.Convolution(feat, num_filter=na * 4, kernel=(3, 3),
                                pad=(1, 1), name=f"locpred{i}")
        lp = mx.sym.transpose(lp, axes=(0, 2, 3, 1))
        loc_preds.append(mx.sym.Reshape(lp, shape=(0, -1)))
        anchors.append(mx.sym.MultiBoxPrior(feat, sizes=sizes, ratios=ratios,
                                            clip=True))
    cls_pred = mx.sym.transpose(mx.sym.Concat(*cls_preds, dim=1),
                                axes=(0, 2, 1))
    loc_pred = mx.sym.Concat(*loc_preds, dim=1)
    anchor = mx.sym.Concat(*anchors, dim=1)
    loc_t, loc_m, cls_t = mx.sym.MultiBoxTarget(
        anchor, label, cls_pred, overlap_threshold=0.5,
        negative_mining_ratio=3, variances=(0.1, 0.1, 0.2, 0.2))
    cls_prob = mx.sym.SoftmaxOutput(cls_pred, cls_t, multi_output=True,
                                    use_ignore=True, ignore_label=-1,
                                    normalization="valid", name="cls_prob")
    loc_loss = mx.sym.MakeLoss(
        mx.sym.smooth_l1(loc_m * (loc_pred - loc_t), scalar=1.0,
                         name="loc_loss_"),
        grad_scale=1.0, normalization="valid", name="loc_loss")
    cls_label = mx.sym.MakeLoss(cls_t, grad_scale=0, name="cls_label")
    det = mx.sym.MultiBoxDetection(cls_prob, loc_pred, anchor,
                                   name="detection", nms_threshold=0.5)
    det = mx.sym.MakeLoss(det, grad_scale=0, name="det_out")
    return mx.sym.Group([cls_prob, loc_loss, cls_label, det])


def ssd_batch(rs, batch, num_classes, size):
    """The example's ``synthetic_detection_batch``: one bright rectangle
    an image; labels (N, 1, 5) [cls, x1, y1, x2, y2] in [0, 1]."""
    import numpy as np
    imgs = rs.normal(0, 0.1, (batch, 3, size, size)).astype("f")
    labels = np.zeros((batch, 1, 5), "f")
    for i in range(batch):
        cls = rs.randint(num_classes)
        w, h = rs.uniform(0.3, 0.6, 2)
        x1 = rs.uniform(0, 1 - w)
        y1 = rs.uniform(0, 1 - h)
        xi1, yi1 = int(x1 * size), int(y1 * size)
        xi2, yi2 = int((x1 + w) * size), int((y1 + h) * size)
        imgs[i, cls % 3, yi1:yi2, xi1:xi2] += 1.0 + 0.5 * cls
        labels[i, 0] = [cls, x1, y1, x1 + w, y1 + h]
    return imgs, labels


def ssd_module(mx, ctx, arg=None, aux=None):
    c = SSD
    mod = mx.mod.Module(build_ssd(mx, c["classes"]), data_names=("data",),
                        label_names=("label",), context=ctx)
    mod.bind(data_shapes=[("data", (c["batch"], 3, c["size"], c["size"]))],
             label_shapes=[("label", (c["batch"], 1, 5))])
    if arg is None:
        mx.random.seed(0)
        mod.init_params(mx.init.Xavier(magnitude=2))
    else:
        mod.init_params(arg_params=arg, aux_params=aux)
    mod.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": c["lr"]})
    return mod


def matched_nll(cls_prob, cls_t):
    """The example's metric: mean -log p of the matched anchors' class."""
    import numpy as np
    matched = cls_t > 0
    if not matched.any():
        return float("nan")
    idx = np.where(matched)
    probs = cls_prob[idx[0], cls_t[matched].astype(int), idx[1]]
    return float(-np.log(np.maximum(probs, 1e-8)).mean())


def phase_ssd_module(mx):
    """(b) the example's SSD through ``Module`` on the card: one step held
    against the CPU, then ``SSD["batches"]`` counted batches."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.kernels import nms as knms
    c = SSD
    mod = ssd_module(mx, mx.gpu(0))
    arg, aux = mod.get_params()
    cpu = ssd_module(mx, mx.cpu(),
                     {k: mx.nd.array(v, ctx=mx.cpu()) for k, v in arg.items()},
                     {k: mx.nd.array(v, ctx=mx.cpu()) for k, v in aux.items()})
    rs = np.random.RandomState(0)
    imgs, labels = ssd_batch(rs, c["batch"], c["classes"], c["size"])
    for m, ctx in ((mod, mx.gpu(0)), (cpu, mx.cpu())):
        m.forward_backward(mx.io.DataBatch(
            data=[mx.nd.array(imgs, ctx=ctx)],
            label=[mx.nd.array(labels, ctx=ctx)]))
    errs = {}
    for i, (a, b) in enumerate(zip(mod.get_outputs()[:3],
                                   cpu.get_outputs()[:3])):
        errs[f"output {i}"] = rel_err(a, b)
    grads = {n: g for n, g in mod._exec.grad_dict.items() if g is not None}
    top = max(float(g.abs().max()) for g in grads.values())
    for name, g in grads.items():
        want = cpu._exec.grad_dict[name]
        # a convolution's bias in front of BatchNorm has a gradient of 0
        # but for rounding: held against the net's largest gradient
        errs[name] = float((g.cpu() - want).abs().max()) / top \
            if name in SSD_BN_FED_BIASES else rel_err(g, want)
    worst = max(errs, key=errs.get)
    det, det_cpu = (mx.nd.asnumpy(m.get_outputs()[3]) for m in (mod, cpu))
    ids_differ = int((det[..., 0] != det_cpu[..., 0]).sum())
    print(f"  (b) example/ssd's build_ssd ({c['classes']} classes, "
          f"{c['size']}x{c['size']}, B={c['batch']}, Adam lr {c['lr']}) "
          f"through Module: one step on the card against the CPU, float32: "
          f"outputs 0-2 and {len(errs) - 3} gradients, max relative error "
          f"{errs[worst]:.3e} ({worst}; the biases in front of BatchNorm, "
          f"whose gradient is rounding, against the largest gradient: "
          f"{max(errs[n] for n in SSD_BN_FED_BIASES):.3e}); detections: "
          f"{ids_differ} of "
          f"{det.shape[0] * det.shape[1]} rows' class ids differ (inputs "
          f"that differ in the last bits)")
    check(errs[worst] <= TOL_SSD_CPU,
          f"SSD step on the card against the CPU: {errs}")
    del cpu
    mod = ssd_module(mx, mx.gpu(0), arg, aux)
    nlls, walls = [], []
    torch.cuda.synchronize()
    reset_counts()
    for _ in range(c["batches"]):
        imgs, labels = ssd_batch(rs, c["batch"], c["classes"], c["size"])
        batch = mx.io.DataBatch(data=[mx.nd.array(imgs, ctx=mx.gpu(0))],
                                label=[mx.nd.array(labels, ctx=mx.gpu(0))])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mod.forward_backward(batch)
        mod.update()
        outs = mod.get_outputs()
        nlls.append(matched_nll(mx.nd.asnumpy(outs[0]),
                                mx.nd.asnumpy(outs[2])))
        walls.append((time.perf_counter() - t0) * 1e3)
    counts = read_counts()
    step_ms = statistics.median(walls[1:])
    print(f"      {c['batches']} batches on the card: median "
          f"{step_ms:.2f} ms a batch (host clock, synchronized by the "
          f"metric's copy; first {walls[0]:.1f} ms); matched-anchor NLL "
          f"first {nlls[0]:.3f}, last {nlls[-1]:.3f}; N launches "
          f"{counts['nms']} ({counts['nms'] / c['batches']:.0f} a forward)")
    check(all(math.isfinite(v) for v in nlls), f"SSD NLL: {nlls}")
    check(counts["nms"] == c["batches"],
          f"SSD: {counts['nms']} N launches in {c['batches']} forwards")
    return counts, {"step_ms": step_ms, "nll": [nlls[0], nlls[-1]],
                    "card_vs_cpu": errs[worst], "det_ids_differ": ids_differ}


def ssd300_inputs(mx, ctx):
    """SSD-300's anchors (``MultiBoxPrior`` over the six maps), labels of
    1-8 ground truths an image (the rest padded) and random class
    probabilities and offsets at B=32, 21 classes."""
    import numpy as np
    c = SSD300
    priors = []
    for s, sizes, ratios, step in zip(c["maps"], c["sizes"], c["ratios"],
                                      c["steps"]):
        feat = mx.nd.zeros((1, 1, s, s), ctx=ctx)
        priors.append(mx.nd.MultiBoxPrior(feat, sizes=sizes, ratios=ratios,
                                          steps=(step / 300, step / 300)))
    anchor = mx.nd.concat(*priors, dim=1)
    rs = np.random.RandomState(300)
    B, M = c["batch"], c["gts"]
    label = -np.ones((B, M, 5), np.float32)
    for i in range(B):
        for j in range(rs.randint(1, M + 1)):
            x1, y1 = rs.uniform(0, 0.7, 2)
            w, h = rs.uniform(0.05, 0.3, 2)
            label[i, j] = [rs.randint(c["classes"] - 1), x1, y1,
                           x1 + w, y1 + h]
    logits = rs.normal(0, 2, (B, c["classes"], c["anchors"]))
    probs = np.exp(logits - logits.max(1, keepdims=True))
    probs = (probs / probs.sum(1, keepdims=True)).astype(np.float32)
    loc = (rs.normal(0, 0.5, (B, c["anchors"] * 4))).astype(np.float32)
    return anchor, label, probs, loc


def phase_ssd300(mx):
    """(c) the SSD ops at SSD-300's shapes, the card against the CPU."""
    import numpy as np
    import torch
    c = SSD300
    anchor, label, probs, loc = ssd300_inputs(mx, mx.gpu(0))
    anchor_cpu = ssd300_inputs(mx, mx.cpu())[0]
    check(tuple(anchor.shape) == (1, c["anchors"], 4),
          f"SSD-300 anchors {tuple(anchor.shape)}")
    check(torch.equal(anchor.cpu(), anchor_cpu),
          "MultiBoxPrior on the card differs from the CPU")
    g = dict(ctx=mx.gpu(0))
    lab, cls_prob, loc_pred = (mx.nd.array(a, **g) for a in (label, probs,
                                                               loc))
    zeros = mx.nd.zeros(tuple(probs.shape), **g)
    t0 = time.perf_counter()
    tgt = mx.nd.MultiBoxTarget(anchor, lab, zeros)
    det = mx.nd.MultiBoxDetection(cls_prob, loc_pred, anchor)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    tgt_cpu = mx.nd.MultiBoxTarget(anchor_cpu, lab.cpu(), zeros.cpu())
    det_cpu = mx.nd.MultiBoxDetection(cls_prob.cpu(), loc_pred.cpu(),
                                      anchor_cpu)
    t_cpu = time.perf_counter() - t0
    errs = {"loc_target": rel_err(tgt[0], tgt_cpu[0]),
            "boxes": rel_err(det[..., 2:], det_cpu[..., 2:])}
    exact = {"loc_mask": torch.equal(tgt[1].cpu(), tgt_cpu[1]),
             "cls_target": torch.equal(tgt[2].cpu(), tgt_cpu[2]),
             "class ids": torch.equal(det[..., 0].cpu(), det_cpu[..., 0]),
             "scores": torch.equal(det[..., 1].cpu(), det_cpu[..., 1])}
    kept = int((det[..., 0] >= 0).sum())
    matched = int((tgt[2] > 0).sum())
    ops = {
        "MultiBoxPrior": lambda: [
            mx.nd.MultiBoxPrior(mx.nd.zeros((1, 1, s, s), **g), sizes=sz,
                                ratios=r, steps=(st / 300, st / 300))
            for s, sz, r, st in zip(c["maps"], c["sizes"], c["ratios"],
                                    c["steps"])],
        "MultiBoxTarget": lambda: mx.nd.MultiBoxTarget(anchor, lab, zeros),
        "MultiBoxDetection": lambda: mx.nd.MultiBoxDetection(
            cls_prob, loc_pred, anchor)}
    # the ops' kernels by torch.profiler (an op that waits for the card,
    # as MultiBoxPrior's copy of its table does, cannot be queued behind a
    # spin), their call time, and whether a call waits for the card
    times = {k: {"kernels_ms": op_kernel_ms(fn), "call_ms": time_ms(fn),
                 "waits": enqueue_waits(fn)} for k, fn in ops.items()}
    print(f"  (c) SSD-300's ops: MultiBoxPrior over maps {c['maps']} -> "
          f"{anchor.shape[1]} anchors (equal to the CPU's); MultiBoxTarget "
          f"at B={c['batch']}, 1-{c['gts']} ground truths an image "
          f"({matched} anchors matched); MultiBoxDetection at "
          f"B={c['batch']}, {c['classes']} classes ({kept} of "
          f"{c['batch'] * c['anchors']} boxes kept); card against CPU: "
          f"{', '.join(f'{k} equal' if v else f'{k} DIFFER' for k, v in exact.items())}; "
          f"loc targets within {errs['loc_target']:.2e}, boxes within "
          f"{errs['boxes']:.2e} of the largest (log and exp round "
          f"differently on the card); target and detection {t_card:.2f} s "
          f"on the card with the first calls, {t_cpu:.2f} s on the CPU")
    print("      " + "; ".join(
        f"{k}: kernels {fmt_ms(v['kernels_ms'])}, call {v['call_ms']:.4f} ms"
        f"{', waits for the card' if v['waits'] else ''}"
        for k, v in times.items()))
    check(all(exact.values()), f"SSD-300 ops, card against CPU: {exact}")
    check(max(errs.values()) <= TOL_BOX_CPU,
          f"SSD-300 ops, card against CPU: {errs}")
    return {"times": times, "errs": errs, "kept": kept}, \
        (cls_prob, loc_pred, anchor)


def op_kernel_ms(fn):
    """Device time of the kernels of one call of ``fn`` by torch.profiler
    (None when it sees no device time)."""
    rows = kernel_rows(fn)
    return sum(r[0] for r in rows) if rows else None


def fmt_ms(v):
    return "not measured" if v is None else f"{v:.4f} ms"


def enqueue_waits(fn):
    """Whether a call of ``fn`` waits for the card: its host time while
    the stream is held by a 50 ms spin reaches the spin."""
    import torch
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    t0 = time.perf_counter()
    fn()
    waited = time.perf_counter() - t0
    torch.cuda.synchronize()
    return waited > 0.04


def kernel_device_ms(fn):
    """``device_ms`` of a kernel's wrapper, or its kernels' profiled time
    where a call waits for the card and cannot be queued behind a spin."""
    return op_kernel_ms(fn) if enqueue_waits(fn) else device_ms(fn)


def nms_bound_ms(boxes, cls, alive, keep, pixel):
    """(ms, by): the bytes of the boxes, ids and masks, read or written
    once, against the pair IoUs this data needs (each kept box against
    every later live box of its class) at the float32 rate."""
    import torch
    B, K = alive.shape
    nbytes = B * K * (16 + (4 if cls is not None else 0) + 1 + 1)
    pairs = 0
    for s in range(B):
        later_live = torch.flip(torch.cumsum(torch.flip(
            alive[s].int(), [0]), 0), [0]) - alive[s].int()
        if cls is None:
            pairs += int(later_live[keep[s]].sum())
        else:
            for k in torch.unique(cls[s][keep[s]]).tolist():
                m = alive[s] & (cls[s] == k)
                after = torch.flip(torch.cumsum(torch.flip(m.int(), [0]), 0),
                                   [0]) - m.int()
                pairs += int(after[keep[s] & (cls[s] == k)].sum())
    ops = pairs * IOU_OPS["pixel" if pixel else "corner"]
    t_ops, t_bytes = ops / H100_F32_FLOPS * 1e3, nbytes / H100_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else
                                 "bytes"), pairs


def plain_ms(fn, reps=2):
    """Host clock of a plain version (it reads coordinates on the host),
    synchronized, the best of ``reps`` after a warm-up call."""
    import torch
    fn()
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return min(walls)


def phase_detection_kernels(mx, keep, ssd_in):
    """(d) N and R against their plain versions at (a)'s and (c)'s shapes
    on the card: bitwise, repeatable, and timed beside their bounds."""
    import torch
    from mxnet_tpu_torch.kernels import nms as knms
    from mxnet_tpu_torch.kernels import roi_pooling as kroi
    from mxnet_tpu_torch.ops import contrib as oc
    from mxnet_tpu_torch.ops.registry import get_op
    res = {}
    # N at Proposal's shape (a): the last step's 6000 candidates
    c = RCNN
    pp = dict(get_op("Proposal").normalize(dict(
        scales=c["scales"], ratios=c["ratios"], feature_stride=c["stride"])))
    boxes, score = oc.proposal_candidates(pp, keep["probs"], keep["reg_raw"],
                                          keep["im_info"])
    cases = {"Proposal (a)": (boxes.float().contiguous(), None,
                              score > -1.0, pp["threshold"], True)}
    cls_prob, loc_pred, anchor = ssd_in
    pd = dict(get_op("MultiBoxDetection").normalize({}))
    boxes, cls_s, _ = oc.detection_candidates(pd, cls_prob, loc_pred, anchor)
    cases["MultiBoxDetection (c)"] = (boxes.float().contiguous(),
                                      cls_s.contiguous(), cls_s >= 0,
                                      pd["nms_threshold"], False)
    for what, (bx, cl, alive, thr, pixel) in cases.items():
        n0 = knms.LAUNCHES
        got = knms.nms_keep(bx, cl, alive, thr, pixel, cl is not None)
        again = knms.nms_keep(bx, cl, alive, thr, pixel, cl is not None)
        want = knms.nms_reference(bx, cl, alive, thr, pixel, cl is not None)
        torch.cuda.synchronize()
        check(knms.LAUNCHES - n0 == 2, "N launches in the check")
        check(torch.equal(got, want), f"N at {what}: the keep set differs "
              f"from the plain version in "
              f"{int((got != want).sum())} boxes")
        check(torch.equal(got, again), f"N at {what}: two runs differ")
        bound, by, pairs = nms_bound_ms(bx, cl, alive, got, pixel)
        t = {"ms": kernel_device_ms(lambda: knms.nms_keep(
                 bx, cl, alive, thr, pixel, cl is not None)),
             "call_ms": time_ms(lambda: knms.nms_keep(bx, cl, alive, thr,
                                                      pixel, cl is not None)),
             "plain_ms": plain_ms(lambda: knms.nms_reference(
                 bx, cl, alive, thr, pixel, cl is not None), reps=1),
             "bound_ms": bound, "bound_by": by,
             "shape": f"B={alive.shape[0]} K={alive.shape[1]}",
             "max_abs_err": float((got.int() - want.int()).abs().max()),
             "kept": int(got.sum()), "pairs": pairs}
        res[f"nms {what}"] = t
        print(f"  (d) N at {what}, {t['shape']} ({'pixel' if pixel else 'corner'}"
              f" IoU{', per class' if cl is not None else ''}): the keep set "
              f"bitwise the plain version's and the same twice "
              f"({t['kept']} kept); device {fmt_ms(t['ms'])}, call "
              f"{t['call_ms']:.4f} ms, plain {t['plain_ms']:.1f} ms (host "
              f"clock), bound {t['bound_ms']:.4f} ms ({by}: {pairs} pair "
              f"IoUs); library: none")
    # R at (a)'s shape: the last step's map and its 128 ROIs
    feat, rois = keep["feat"], keep["sel_rois"]
    ph, pw = c["pooled"]
    coords = kroi.roi_coords(rois, feat.dtype, 1.0 / c["stride"],
                             feat.shape[0])
    f0, b0 = kroi.FWD_LAUNCHES, kroi.BWD_LAUNCHES
    out, count = kroi.roi_pool_forward(feat, coords, ph, pw)
    out2, count2 = kroi.roi_pool_forward(feat, coords, ph, pw)
    want, want_count = kroi.roi_pool_reference(feat, coords, ph, pw)
    gen = torch.Generator(device=feat.device).manual_seed(19)
    gout = torch.randn(out.shape, generator=gen, device=feat.device)
    g = kroi.roi_pool_backward(feat, coords, out, count, gout)
    g2 = kroi.roi_pool_backward(feat, coords, out, count, gout)
    gwant = kroi.roi_pool_backward_reference(feat, coords, want, want_count,
                                             gout)
    torch.cuda.synchronize()
    check(kroi.FWD_LAUNCHES - f0 == 2 and kroi.BWD_LAUNCHES - b0 == 2,
          "R launches in the check")
    check(torch.equal(out, want) and torch.equal(count, want_count),
          "R forward differs from the plain version")
    check(torch.equal(g, gwant), f"R backward differs from the plain "
          f"version: {rel_err(g, gwant):.3e}")
    check(torch.equal(out, out2) and torch.equal(count, count2)
          and torch.equal(g, g2), "R: two runs differ")
    R, C = rois.shape[0], feat.shape[1]
    nb_f = feat.numel() * 4 + R * 20 + out.numel() * 4
    nb_b = feat.numel() * 4 * 2 + R * 20 + out.numel() * 4
    res["roi_pooling"] = {
        "shape": f"data {tuple(feat.shape)} float32, {R} ROIs, {ph}x{pw}",
        "ms": kernel_device_ms(lambda: kroi.roi_pool_forward(feat, coords,
                                                             ph, pw)),
        "call_ms": time_ms(lambda: kroi.roi_pool_forward(feat, coords, ph,
                                                         pw)),
        "plain_ms": plain_ms(lambda: kroi.roi_pool_reference(feat, coords,
                                                             ph, pw)),
        "bound_ms": nb_f / H100_BYTES * 1e3, "bound_by": "bytes",
        "bwd_ms": kernel_device_ms(lambda: kroi.roi_pool_backward(
            feat, coords, out, count, gout)),
        "bwd_call_ms": time_ms(lambda: kroi.roi_pool_backward(
            feat, coords, out, count, gout)),
        "bwd_plain_ms": plain_ms(lambda: kroi.roi_pool_backward_reference(
            feat, coords, want, want_count, gout)),
        "bwd_bound_ms": nb_b / H100_BYTES * 1e3,
        "max_abs_err": float((out - want).abs().max()),
        "bwd_max_abs_err": float((g - gwant).abs().max()),
        "ties": int((count > 1).sum()), "empty": int((count == 0).sum()),
        "bins": count.numel()}
    t = res["roi_pooling"]
    print(f"  (d) R at (a)'s shape, {t['shape']}: forward (out and tie "
          f"counts) and backward bitwise the plain version's and the same "
          f"twice (no atomics; {t['ties']} of {t['bins']} bins with tied "
          f"maxima, {t['empty']} empty); forward device {fmt_ms(t['ms'])}, "
          f"call {t['call_ms']:.4f}, plain {t['plain_ms']:.1f} (host "
          f"clock), bound {t['bound_ms']:.4f} (bytes); backward device "
          f"{fmt_ms(t['bwd_ms'])}, call {t['bwd_call_ms']:.4f}, plain "
          f"{t['bwd_plain_ms']:.1f}, bound {t['bwd_bound_ms']:.4f} (bytes); "
          f"library: none")
    return res


def contrib_cases(np):
    """(name, arrays, kwargs, input positions with a gradient) of the new
    op surface, float32, at small shapes."""
    rs = np.random.RandomState(21)
    rois = np.array([[0, 1, 2, 30, 20], [1, 5, 4, 50, 60],
                     [1, -8, -8, 20, 9]], np.float32)
    sym = rs.randn(2, 5, 5).astype(np.float32)
    f = np.float32
    return [
        ("fft", [rs.randn(3, 8).astype(f)], {}, (0,)),
        ("ifft", [rs.randn(3, 16).astype(f)], {}, (0,)),
        ("_contrib_quantize", [rs.rand(3, 8).astype(f), np.array([0.1], f),
                               np.array([0.9], f)], {}, ()),
        ("_contrib_count_sketch", [rs.randn(3, 8).astype(f),
                                   np.array([0, 1, 1, 3, 2, 0, 4, 4], f),
                                   np.sign(rs.randn(8)).astype(f)],
         {"out_dim": 5}, (0,)),
        ("khatri_rao", [rs.randn(2, 3).astype(f), rs.randn(4, 3).astype(f)],
         {}, (0, 1)),
        ("PSROIPooling", [rs.randn(2, 18, 8, 9).astype(f), rois],
         {"spatial_scale": 0.125, "output_dim": 2, "pooled_size": 3}, (0,)),
        ("DeformableConvolution", [rs.randn(2, 4, 6, 7).astype(f),
                                   rs.randn(2, 36, 6, 7).astype(f),
                                   rs.randn(6, 2, 3, 3).astype(f),
                                   rs.randn(6).astype(f)],
         {"kernel": (3, 3), "pad": (1, 1), "num_filter": 6, "num_group": 2,
          "num_deformable_group": 2}, (0, 1, 2)),
        ("DeformablePSROIPooling", [rs.randn(2, 18, 8, 9).astype(f), rois,
                                    rs.randn(3, 4, 3, 3).astype(f)],
         {"spatial_scale": 0.125, "output_dim": 2, "pooled_size": 3,
          "group_size": 3, "trans_std": 0.1}, (0, 2)),
        ("ROIPooling", [np.maximum(rs.randn(2, 3, 8, 9), 0).astype(f), rois],
         {"pooled_size": (3, 2), "spatial_scale": 0.125}, (0,)),
        ("BilinearSampler", [rs.randn(2, 3, 6, 7).astype(f),
                             (rs.rand(2, 2, 4, 5) * 2.4 - 1.2).astype(f)],
         {}, (0, 1)),
        ("SpatialTransformer", [rs.randn(2, 3, 6, 7).astype(f),
                                (rs.randn(2, 6) * 0.5).astype(f)],
         {"target_shape": (4, 5)}, (0, 1)),
        ("GridGenerator", [rs.randn(2, 2, 4, 5).astype(f)],
         {"transform_type": "warp"}, (0,)),
        ("Correlation", [rs.randn(2, 3, 6, 7).astype(f),
                         rs.randn(2, 3, 6, 7).astype(f)],
         {"max_displacement": 2, "pad_size": 2}, (0, 1)),
        ("Crop", [rs.randn(2, 3, 6, 7).astype(f)],
         {"num_args": 1, "h_w": (3, 4), "center_crop": True}, (0,)),
        ("_slice_assign", [rs.randn(4, 5).astype(f), rs.randn(2, 2).astype(f)],
         {"begin": (1, None), "end": (3, 4), "step": (None, 2)}, (0, 1)),
        ("_linalg_gelqf", [rs.randn(2, 3, 5).astype(f)], {}, (0,)),
        ("_linalg_syevd", [sym + sym.transpose(0, 2, 1)], {}, (0,)),
        ("IdentityAttachKLSparseReg", [rs.rand(4, 6).astype(f),
                                       np.full(6, 0.3, f)], {}, (0,)),
    ]


def phase_contrib_surface(mx):
    """(e) the slice's op surface on the card against the CPU, float32,
    values and gradients; then ``Custom`` in ``nd`` on the card and
    refused inside the capture of ``Module``'s fused step."""
    import numpy as np
    import torch
    cases = contrib_cases(np)
    worst = (0.0, None)
    for name, arrays, kw, wrt in cases:
        res = []
        for ctx in (mx.gpu(0), mx.cpu()):
            xs = [mx.nd.array(a, ctx=ctx) for a in arrays]
            for i in wrt:
                mx.nd.attach_grad(xs[i])
            with mx.autograd.record():
                outs = getattr(mx.nd, name)(*xs, **kw)
                outs = outs if isinstance(outs, list) else [outs]
                rs = np.random.RandomState(5)
                head = sum((o * torch.as_tensor(rs.uniform(
                    0.5, 1.5, tuple(o.shape)), dtype=o.dtype,
                    device=o.device)).sum() for o in outs
                    if o.dtype.is_floating_point)
            if wrt:
                head.backward()
            res.append([o.detach() for o in outs] +
                       [mx.nd.grad(xs[i]) for i in wrt])
        for a, b in zip(*res):
            if a.dtype.is_floating_point:
                err = rel_err(a, b)
                if err > worst[0]:
                    worst = (err, name)
            else:
                check(torch.equal(a.cpu(), b), f"{name}: integer output "
                      f"differs on the card")
    print(f"  (e) {len(cases)} ops of the slice (compat, contrib, vision) on "
          f"the card against the CPU, float32: outputs and gradients within "
          f"{worst[0]:.3e} of each one's largest (worst: {worst[1]})")
    check(worst[0] <= TOL_CONTRIB, f"op surface card against CPU: {worst}")

    @mx.operator.register("chip_sqr")
    class SqrProp(mx.operator.CustomOpProp):
        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Sqr()

    class Sqr(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] * in_data[0])

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], 2 * in_data[0])

    x = mx.nd.attach_grad(mx.nd.array(np.arange(6, dtype=np.float32)
                                      .reshape(2, 3), ctx=mx.gpu(0)))
    with mx.autograd.record():
        y = mx.nd.Custom(x, mx.nd.zeros((2,), ctx=mx.gpu(0)),
                         op_type="chip_sqr")
    y.sum().backward()
    check(y.device.type == "cuda" and torch.equal(y, x.detach() ** 2)
          and torch.equal(mx.nd.grad(x), 2 * x.detach()),
          "Custom on the card")
    sym = mx.sym.Custom(mx.sym.FullyConnected(mx.sym.Variable("data"),
                                              num_hidden=4, name="fc"),
                        name="sq", op_type="chip_sqr")
    mod = mx.mod.Module(sym, label_names=("sq_label",), context=mx.gpu(0))
    mod.bind(data_shapes=[("data", (8, 16))], label_shapes=[("sq_label", (8,))])
    mx.random.seed(0)
    mod.init_params(mx.init.Xavier())
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.01})
    batch = mx.io.DataBatch(data=[mx.nd.ones((8, 16), ctx=mx.gpu(0))],
                            label=[mx.nd.zeros((8,), ctx=mx.gpu(0))])
    refused = None
    with env_vars(MXNET_FUSED_STEP="1"):
        try:
            for _ in range(3):       # eager, then the capture
                mod.forward_backward(batch)
                mod.update()
        except mx.MXNetError as e:
            refused = str(e)
    torch.cuda.synchronize()
    print(f"      Custom on the card: forward and backward on CUDA tensors; "
          f"under MXNET_FUSED_STEP=1 the capture refused it: "
          f"{(refused or 'NOT REFUSED')[:160]}")
    check(refused is not None and "chip_sqr" in refused,
          f"Custom inside the fused step's capture: {refused}")
    return worst


def phase_detection(mx):
    """Phase 19: the detection slice.  Every kernel count is set to 0
    before each main path, (a) and (b), and read after it."""
    import torch
    card = card_line()
    print(f"  {card}")
    torch.cuda.synchronize()
    reset_counts()
    rcnn, keep = phase_rcnn(mx)
    rcnn_counts = read_counts()
    print(f"      kernel launches counted on (a)'s path: {rcnn_counts}")
    check(rcnn_counts["nms"] == RCNN["steps"] + 1
          and rcnn_counts["roi_pooling.fwd"] == RCNN["steps"] + 1
          and rcnn_counts["roi_pooling.bwd"] == RCNN["steps"] + 1
          and all(v == 0 for k, v in rcnn_counts.items()
                  if not k.startswith(("nms", "roi_pooling"))),
          f"(a)'s launches {rcnn_counts}: want 1 N, 1 R forward and 1 R "
          f"backward a step ({RCNN['steps']} and the profiled one), nothing "
          f"else")
    ssd_counts, ssd = phase_ssd_module(mx)
    ssd300, ssd_in = phase_ssd300(mx)
    kern = phase_detection_kernels(mx, keep, ssd_in)
    del keep, ssd_in
    contrib_err = phase_contrib_surface(mx)
    return {"a": rcnn_counts, "b": ssd_counts}, {
        "card": card, "rcnn": rcnn, "ssd": ssd, "ssd300": ssd300,
        "kernels": kern, "contrib_err": contrib_err[0]}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "mxnet_tpu_torch", "csrc")):
        print("chip_smoke: run it from a checkout of the repository "
              "(mxnet_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    # the flight recorder's dumps (slow-phase anomalies) under build/
    os.environ.setdefault("MXNET_FLIGHT_DIR",
                          os.path.join(ROOT, "build", "flight"))
    import numpy as np
    import mxnet_tpu_torch as mx
    # float32 means IEEE float32 in every comparison below
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    L = CONFIG["num_layers"]
    count_updates(mx)
    try:
        print("== phase 1: setup")
        k0 = phase_setup(mx)
        print("== phase 2: flash kernels vs plain version")
        errs, lse_errs, timings, short_times = phase_kernel(mx)
        print("== phase 3: scoring, float32, flash vs dense")
        flash, dense = build_nets(mx)
        rs = np.random.RandomState(42)
        tokens = mx.nd.array(rs.randint(0, CONFIG["vocab"], (
            SCORE_BATCH, CONFIG["max_len"])).astype(np.float32), ctx=mx.gpu(0))
        prompts = [rs.randint(0, CONFIG["vocab"], n).astype(np.float32)
                   for n in PROMPTS]
        phase_score_f32(mx, flash, dense, tokens, L)
        print("== phase 4: serving, float32, flash vs dense")
        static_tokens = phase_serve_f32(mx, flash, dense, prompts, L)
        print("== phase 5: main path, bfloat16")
        counts, static_times = phase_main(mx, flash, tokens, prompts, L)
        print("== phase 6: where one decode step's time goes")
        phase_profile(mx, flash, prompts[-1])
        print("== phase 7: KV-cache decode")
        del flash, dense
        phase_kv(mx, prompts, static_tokens, static_times)
        print("== phase 8: serving through the symbol graph")
        # the tuner's traffic ring records while decisions are on
        from mxnet_tpu_torch.autotune import decisions, sweep
        from mxnet_tpu_torch.serving import buckets as serving_buckets
        decisions.enable()
        counts = phase_serving(mx, prompts, L)
        serve_obs = {"traffic": serving_buckets.observed_traffic(),
                     "ewma_s": sweep._serve_dispatch_ewma()}
        print("== phase 9: training")
        t_train = time.perf_counter()
        bwd_errs, bwd_f32_errs, bwd_times = phase_train_kernel(mx)
        phase_grad_check(mx)
        train_counts, lm_gluon = phase_train(mx)
        print(f"phase 9: {time.perf_counter() - t_train:.1f} s")
        print("== phase 10: the vision path")
        t_vision = time.perf_counter()
        phase_goldens(mx)
        vnet, vision_gluon = phase_vision_train(mx)
        phase_vision_data(mx, vnet)
        del vnet
        phase_vision_grad(mx)
        print(f"phase 10: {time.perf_counter() - t_vision:.1f} s")
        print("== phase 11: the symbolic path (Module.fit)")
        t_module = time.perf_counter()
        resident = phase_module_resnet(mx, vision_gluon)
        phase_module_vs_gluon(mx)
        module_counts, lm_module = phase_module_lm(mx, lm_gluon)
        print(f"phase 11: {time.perf_counter() - t_module:.1f} s")
        print("== phase 12: the core op surface, MultiHeadAttention, DCGAN")
        t_core = time.perf_counter()
        phase_ops(mx)
        phase_random(mx)
        mha_counts, mha_f32_counts, mha_times = phase_mha(mx)
        phase_dcgan(mx)
        print(f"phase 12: {time.perf_counter() - t_core:.1f} s")
        print("== phase 13: training state (optimizers, checkpoints, "
              "resume, hot reload)")
        t_state = time.perf_counter()
        phase_optimizers(mx)
        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        with tempfile.TemporaryDirectory(
                dir=os.path.join(ROOT, "build")) as root:
            state_counts = phase_resume(mx, root)
            phase_module_checkpoint(mx, root)
        print(f"phase 13: {time.perf_counter() - t_state:.1f} s")
        print("== phase 14: the record-file input path")
        t_rec = time.perf_counter()
        # the record file stays for phase 16's prefetcher
        with tempfile.TemporaryDirectory(
                dir=os.path.join(ROOT, "build")) as root:
            path, first, labels = write_image_rec(mx, root)
            it_rate = phase_rec_iter(mx, path, labels)
            phase_rec_fit(mx, path, resident, it_rate)
            phase_rec_dataset(mx, path, first)
            phase_tensor_rec(mx, root)
            mirror_counts, _ = phase_mirror(mx, lm_gluon, lm_module)
            phase_export(mx, root)
            print(f"phase 14: {time.perf_counter() - t_rec:.1f} s")
            print("== phase 15: the one-program training step (CUDA "
                  "graphs)")
            t_one = time.perf_counter()
            onestep_counts = phase_onestep(mx, lm_gluon, resident,
                                           lm_module, mha_times)
            print(f"phase 15: {time.perf_counter() - t_one:.1f} s")
            print("== phase 16: observability and training resilience")
            t_res = time.perf_counter()
            phase_resilience(mx, path, it_rate)
            print(f"phase 16: {time.perf_counter() - t_res:.1f} s")
        print("== phase 17: the program introspector, the tuner, decode "
              "and the registry")
        t_prog = time.perf_counter()
        registry_counts = phase_programs(mx, serve_obs)
        print(f"phase 17: {time.perf_counter() - t_prog:.1f} s")
        print("== phase 18: RNN and sequences (the fused RNN op, CTC, "
              "gluon.rnn, mx.rnn, BucketingModule, CellModel)")
        t_rnn = time.perf_counter()
        recurrent_counts, recurrent = phase_recurrent(mx)
        print(f"phase 18: {time.perf_counter() - t_rnn:.1f} s")
        print(json.dumps({"recurrent": {
            "card": recurrent["card"],
            "lm_step_ms": recurrent["lm"]["step_ms"],
            "lm_tokens_s": recurrent["lm"]["tokens_s"],
            "lm_launches_a_step": recurrent["lm"]["launches"],
            "lm_loss": [recurrent["lm"]["loss0"], recurrent["lm"]["loss1"]],
            "card_vs_cpu_rel_err": recurrent["errs"],
            "bucketing_ppl": [recurrent["bucketing"]["ppl0"],
                              recurrent["bucketing"]["ppl1"]],
            "lm_grad_card_vs_cpu_rel_err": recurrent["lm"]["grad_err"],
            "ctc_fwd_bwd_ms": recurrent["ctc_ms"],
            "decode_tokens_s": recurrent["decode"]["tokens_s"],
            "decode_live_slots": recurrent["decode"]["live"],
            "decode_rate_s": recurrent["decode"]["rate_s"]}}))
        print("== phase 19: detection (Faster R-CNN at VGG16 width, the "
              "SSD example through Module, SSD-300's ops, kernels N and R, "
              "the op surface and Custom)")
        t_det = time.perf_counter()
        det_counts, det = phase_detection(mx)
        print(f"phase 19: {time.perf_counter() - t_det:.1f} s")
        print(json.dumps({"detection": {
            "card": det["card"],
            "rcnn_step_ms": det["rcnn"]["step_ms"],
            "rcnn_step_range_ms": [det["rcnn"]["step_min"],
                                   det["rcnn"]["step_max"]],
            "rcnn_idle_share": det["rcnn"]["idle"],
            "rcnn_peak_gib": det["rcnn"]["peak_gib"],
            "rcnn_losses_first_last": det["rcnn"]["losses"],
            "ssd_step_ms": det["ssd"]["step_ms"],
            "ssd_nll_first_last": det["ssd"]["nll"],
            "ssd_card_vs_cpu_rel_err": det["ssd"]["card_vs_cpu"],
            "ssd300_device_ms": det["ssd300"]["times"],
            "ssd300_card_vs_cpu": det["ssd300"]["errs"],
            "contrib_card_vs_cpu_rel_err": det["contrib_err"]}}))
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    bf16, f32 = torch.bfloat16, torch.float32

    def flash_entry(name, variant, source, dtype, launches):
        """The kernel at the scoring shape, causal; the decode shape's
        numbers beside it for the bf16 kernel."""
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": "mxnet_tpu/ops/flash_attention.py:179",
                 "replaces_function":
                     "mxnet_tpu/ops/flash_attention.py:_flash_attention",
                 "launches": launches}
        for B in ((4, 1) if dtype == bf16 else (4,)):
            t = timings[(dtype, B, True)]
            err, rel = errs[(variant, dtype, B, 1024, 64, True)]
            nums = {"shape": f"B={B} H=16 T=1024 D=64 {str(dtype)[6:]} "
                             "causal",
                    "max_abs_err": err, "max_rel_err": rel,
                    "ms": t[variant][0], "call_ms": t[variant][1],
                    "plain_ms": t["plain"][0], "bound_ms": t["bound"][0],
                    "bound_by": t["bound"][1], "library_ms": t["sdpa"][0]}
            if B == 4:
                entry.update(nums)
            else:
                entry["decode"] = nums
        entry["max_err_all_shapes"] = max(
            e[0] for key, e in errs.items() if key[0] == variant)
        entry["max_lse_err"] = max(
            e for key, e in lse_errs.items() if key[0] == variant)
        if variant == "f32":
            # the 3xTF32 bound above; the FMA kernels' ceiling beside it;
            # B=8 non-causal, MultiHeadAttention's default shape
            entry["fma_bound_ms"] = timings[(f32, 4, True)]["fma_bound"][0]
            t = timings[(f32, TRAIN_BATCH, False)]
            entry["mha_shape"] = {
                "shape": f"B={TRAIN_BATCH} H=16 T=1024 D=64 float32 "
                         "non-causal",
                "max_abs_err": errs[(variant, f32, TRAIN_BATCH, 1024, 64,
                                     False)][0],
                "ms": t["f32"][0], "plain_ms": t["plain"][0],
                "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
                "fma_bound_ms": t["fma_bound"][0],
                "library_ms": t["sdpa"][0]}
        if variant == "sm90":
            entry["lse_ms"] = timings[(bf16, 4, True)]["sm90_lse"][0]
            entry["short"] = {
                f"B=4 H=16 T={T} D=64 bf16 causal": {
                    "max_abs_err": errs[(variant, bf16, 4, T, 64, True)][0],
                    "ms": t["sm90"], "plain_ms": t["plain"],
                    "bound_ms": bound[0], "bound_by": bound[1],
                    "library_ms": t["sdpa"]}
                for T, (t, bound) in short_times.items()}
        return entry

    def bwd_entry(name, variant, source, dtype):
        """K1b's kernel ``variant`` at the training shape, causal, in
        ``dtype``: bf16 for the sm90 kernel, whose launches are phase 9's
        main path; float32 for the f32 (3xTF32) kernel, with its time on
        the bf16 inputs and non-causal beside it."""
        t = bwd_times[dtype]
        err, rel = bwd_errs[(variant, dtype, TRAIN_BATCH, 1024, 64, True)]
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": "mxnet_tpu/ops/flash_attention.py:224",
                 "replaces_function": "mxnet_tpu/ops/flash_attention.py:"
                                      "_fa_bwd (plain jnp, not Pallas)",
                 "launches": train_counts[f"flash_attention.bwd.{variant}"],
                 "shape": f"B={TRAIN_BATCH} H=16 T=1024 D=64 "
                          f"{str(dtype)[6:]} causal",
                 "max_abs_err": err, "max_rel_err": rel, "ms": t[variant],
                 "plain_ms": t["plain"], "bound_ms": t["bound"][0],
                 "bound_by": t["bound"][1], "library_ms": t["sdpa_bwd"],
                 "max_rel_err_all_shapes": max(
                     e[1] for key, e in bwd_errs.items()
                     if key[0] == variant)}
        entry["floor_ms_14D"] = t["floor"][0]
        if variant == "sm90":
            entry["max_rel_err_vs_f32_kernel"] = max(
                e[1] for e in bwd_f32_errs.values())
        else:
            entry["fma_bound_ms"] = t["fma_bound"][0]
            entry["grad_check_launches"] = GRAD_LAYERS
            entry["bf16_inputs_ms"] = bwd_times[bf16]["f32"]
            nc = bwd_times["f32_noncausal"]
            entry["mha_shape"] = {
                "shape": f"B={TRAIN_BATCH} H=16 T=1024 D=64 float32 "
                         "non-causal",
                "max_rel_err": bwd_errs[(variant, f32, TRAIN_BATCH, 1024, 64,
                                         False)][1],
                "ms": nc["f32"], "plain_ms": nc["plain"],
                "bound_ms": nc["bound"][0], "bound_by": nc["bound"][1],
                "floor_ms_14D": nc["floor"][0],
                "fma_bound_ms": nc["fma_bound"][0],
                "library_ms": nc["sdpa_bwd"]}
        return entry

    kernels_line = {"kernels": [
        {"name": "add_one", "route": "cuda",
         "source": "mxnet_tpu_torch/csrc/add_one.cu",
         "replaces": "experiments/flash_probe.py:40",
         "launches": counts["add_one"], "max_abs_err": 0.0,
         "ms": k0["ms"], "call_ms": k0["call"], "plain_ms": k0["plain_ms"],
         "bound_ms": k0["bound_ms"], "bound_by": "bytes",
         "library_ms": k0["library_ms"]},
        flash_entry("flash_attention_fwd_sm90", "sm90",
                    "mxnet_tpu_torch/csrc/flash_attention_fwd_sm90.cu", bf16,
                    counts["flash_attention.sm90"]),
        flash_entry("flash_attention_fwd", "f32",
                    "mxnet_tpu_torch/csrc/flash_attention_fwd.cu", f32,
                    counts["flash_attention.f32"]),
        bwd_entry("flash_attention_bwd_sm90", "sm90",
                  "mxnet_tpu_torch/csrc/flash_attention_bwd_sm90.cu", bf16),
        bwd_entry("flash_attention_bwd", "f32",
                  "mxnet_tpu_torch/csrc/flash_attention_bwd.cu", f32),
    ]}
    for entry, variant in zip(kernels_line["kernels"][1:3], ("sm90", "f32")):
        entry["training_launches"] = train_counts[f"flash_attention.{variant}"]
        entry["module_launches"] = module_counts[f"flash_attention.{variant}"]
        entry["mha_launches"] = mha_counts[variant]
        entry["mha_f32_launches"] = mha_f32_counts[variant]
        entry["resume_launches"] = state_counts[f"flash_attention.{variant}"]
        entry["mirror_launches"] = mirror_counts[f"flash_attention.{variant}"]
        entry["onestep_launches"] = onestep_counts.get(
            f"flash_attention.{variant}", 0)
        entry["registry_launches"] = registry_counts[
            f"flash_attention.{variant}"]
    # phase 18's recurrent path (a), counted: it runs none of them
    for entry, key in zip(kernels_line["kernels"], (
            "add_one", "flash_attention.sm90", "flash_attention.f32",
            "flash_attention.bwd.sm90", "flash_attention.bwd.f32")):
        entry["recurrent_launches"] = recurrent_counts[key]
    for entry, variant in zip(kernels_line["kernels"][3:5], ("sm90", "f32")):
        entry["module_launches"] = module_counts[
            f"flash_attention.bwd.{variant}"]
        entry["mha_launches"] = mha_counts[f"bwd.{variant}"]
        entry["mha_f32_launches"] = mha_f32_counts[f"bwd.{variant}"]
        entry["resume_launches"] = state_counts[
            f"flash_attention.bwd.{variant}"]
        entry["mirror_launches"] = mirror_counts[
            f"flash_attention.bwd.{variant}"]
        entry["onestep_launches"] = onestep_counts.get(
            f"flash_attention.bwd.{variant}", 0)
    # phase 19's detection paths: (a) R-CNN, (b) the SSD Module, counted;
    # they run none of the kernels above
    for entry, key in zip(kernels_line["kernels"], (
            "add_one", "flash_attention.sm90", "flash_attention.f32",
            "flash_attention.bwd.sm90", "flash_attention.bwd.f32")):
        entry["detection_launches"] = det_counts["a"][key] + \
            det_counts["b"][key]
    kd = det["kernels"]
    nms_a, nms_c = kd["nms Proposal (a)"], kd["nms MultiBoxDetection (c)"]
    kernels_line["kernels"].append({
        "name": "nms", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/nms.cu",
        "replaces": "mxnet_tpu/ops/contrib.py:289",
        "replaces_function": "mxnet_tpu/ops/contrib.py:_multibox_detection "
                             "(:277-289) and _proposal (:370-389), "
                             "lax.fori_loop, not Pallas",
        "launches": det_counts["a"]["nms"],
        "ssd_launches": det_counts["b"]["nms"],
        "shape": nms_a["shape"] + " pixel IoU, class-blind (Proposal)",
        "max_abs_err": nms_a["max_abs_err"], "ms": nms_a["ms"],
        "call_ms": nms_a["call_ms"],
        "plain_ms": nms_a["plain_ms"], "bound_ms": nms_a["bound_ms"],
        "bound_by": nms_a["bound_by"], "library_ms": None,
        "multibox": {"shape": nms_c["shape"] + " corner IoU, per class "
                     "(MultiBoxDetection, SSD-300)",
                     "max_abs_err": nms_c["max_abs_err"],
                     "ms": nms_c["ms"], "call_ms": nms_c["call_ms"],
                     "plain_ms": nms_c["plain_ms"],
                     "bound_ms": nms_c["bound_ms"],
                     "bound_by": nms_c["bound_by"], "library_ms": None}})
    r = kd["roi_pooling"]
    kernels_line["kernels"].append({
        "name": "roi_pooling", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/roi_pooling.cu",
        "replaces": "mxnet_tpu/ops/vision.py:21",
        "replaces_function": "mxnet_tpu/ops/vision.py:_roi_pooling and its "
                             "VJP (plain jnp, not Pallas)",
        "launches": det_counts["a"]["roi_pooling.fwd"],
        "bwd_launches": det_counts["a"]["roi_pooling.bwd"],
        "shape": r["shape"], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "call_ms": r["call_ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": None, "bwd_max_abs_err": r["bwd_max_abs_err"],
        "bwd_ms": r["bwd_ms"],
        "bwd_call_ms": r["bwd_call_ms"], "bwd_plain_ms": r["bwd_plain_ms"],
        "bwd_bound_ms": r["bwd_bound_ms"], "bwd_bound_by": "bytes"})
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
