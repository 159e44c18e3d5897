#!/usr/bin/env python3
"""Build the port's CUDA kernels, drive its main path on one card, and check
both.

    python3 chip_smoke.py [--profile OUT.json] [--deadline SECONDS]

Phases, each printed as one JSON line:
  card     the card's name and power limit (nvidia-smi), torch and CUDA
           versions, compute capability;
  build    nvcc of every `mxnet_tpu_torch/ops/csrc/*.cu`, one process each,
           ptxas's register report, and the count of tensor-core (HGMMA)
           instructions in each library's SASS where `cuobjdump` exists;
  train    slice 1's path: 3 Adam steps of `TransformerLM` at the default
           `TransformerLMConfig` width (bf16, 4 layers, d_model 512, 8 heads,
           vocab 32768) on one batch of 8 x 2048 tokens; then the same path
           on a small fp32 input on the card and on the CPU;
  ring     slice 3's path: the same model, weights and batch trained 3 steps
           with a 4-way `sp` mesh whose positions all sit on cuda:0, so
           attention is ring attention: per layer and step 4 x 4 K2 hops
           and their streaming combine, the backward through the ring; then
           the small fp32 input with sp = 4 on the card and on the CPU;
  trainer  slice 2's path: the same model and batch trained 3 steps by
           `gluon.Trainer` (multi-precision Adam) through a `dist_sync`
           kvstore with 2-bit gradient compression, in a one-rank NCCL
           process group opened on a free localhost port: per parameter a
           K3 quantize, an all-gather of the packed words, a dequantize and
           a pull; the group is destroyed at the end of the phase. With
           telemetry on for the steps (slice 11): the ``dist.*_bytes``
           counters must equal the bytes of the 32-bit words K3 packs
           (4 x ceil(n / 16) a parameter of n values, a step) and
           ``kvstore.push_bytes`` / ``pull_bytes`` the dense gradients';
  generate slice 5's path, run before the trainer: `GenerationEngine` over
           the default model (weights from seed 0) with a 32 x 2048 KV slab
           (512 MiB) and the prefill ladder 8, 16, ..., 2048, served by its
           worker thread. Warm-up captures 10 CUDA graphs (9 prefill, 1
           decode), a second warm-up none; a burst of 64 sessions (prompts
           of 16-1024 tokens, 128 new tokens each), half of them queued;
           one 512-token stream for flatness (the median gap of its last
           third over its first third). Checks, each raising: (a) steady
           state builds and captures nothing; (b) 8 burst sessions rerun
           alone give the same tokens; (c) one replayed decode tick against
           an eager `decode_step` on a copy of the slab (equal greedy
           tokens, logits within 2e-2); (d) the small fp32 model served on
           the card and on the CPU (equal streams over 8 sessions, prefill
           and decode logits within 1e-4); (e) no kernel launched. Prints
           tokens/s, TTFT p50 and p99, the median tick, the decode graph's
           time against its bound (the slab and the weights read once a
           tick), each prefill bucket's graph time, peak memory, and the
           card's name and power limit;
  generate_spec, generate_prefix, generate_swap, generate_router
           slice 10's lanes, right after the generate phase, over its model
           and a 32 x 2048 slab each (`generate_lanes`). spec: the burst
           through `spec_k=4` with `NgramDraft` (bench.py's), then with a
           `CheckpointDraft` that is the target itself (max_len 2056),
           saved by `save_draft` and loaded through
           ``MXNET_GENERATION_DRAFT``; both runs' streams must equal the
           plain burst's; prints tokens/s, accepted tokens a verify
           slot-tick, the share of slot-ticks that commit all k + 1, the
           verify graph against 5 x the decode graph, the draft step, the
           wall against the plain burst's. prefix: 64 sessions sharing a
           1024-token system prompt (tails of 16-256 tokens), submitted one
           at a time, then as a burst; fork + suffix prefill against the
           full prefill at three splits (logits within 2e-2, equal argmax),
           a hit ratio of at least 63/64; prints the TTFT of hits against
           the cold one, the fork graph against its byte bound, each suffix
           bucket's graph, the burst's tokens/s. swap: the burst's prompts
           from 16 closed-loop clients, `swap_weights` to seed-99 weights
           and back at 30 % and 65 % of the completions; every stream must
           equal its prompt's under the version it was admitted under, some
           tick must replay two cohorts, the old version's prefix entries
           must be gone; prints each swap's ms under the tick lock. router:
           two 16-slot engines behind a `GenerationRouter`, two 1024-token
           system prompts; each prompt's later sessions must land on the
           engine caching it, 16 unrelated prompts split evenly. Every lane:
           no capture after warm-up, no kernel launched; check (d) also
           runs the lanes on the small model, card against CPU;
  generate_qos, generate_fleet
           slice 12's lanes, after those. qos (`bench.py:1511-1627` at full
           width): a 32 x 2048 engine, the 8-session `latency` trickle
           (prompts of 16-64 tokens, 16 new) alone, then behind a 64-session
           `bulk` flood (64-512 tokens, 256 new) that has filled the slab,
           QoS off (FIFO), then the same under the registry
           ``latency:interactive;bulk:batch`` with 8 park rows (a 40-row
           slab). Checks: (a) QoS off, no park row in the keys and flood
           streams equal to their prompts run alone; (b) at least one
           preemption, no capture after warm-up; (c) every preempted
           stream equal to its prompt run alone on the same 40-row engine,
           every latency stream to its own; (d) a tenant at ``rps=1``
           refused its second submit inside a second. Prints TTFT p50 and
           maximum of each phase (8 sessions: a p99 would be the maximum),
           both degradations (maximum over maximum), preemptions and
           resumes, the
           fork graph, the slab's bytes. fleet: two 16-slot engines over the
           one model, QoS on, 4 park rows each, behind a `GenerationRouter`:
           class placement, a flood forced onto engine 0 then
           `rebalance_parked` (each migrated stream equal to a fresh submit
           of its context), `rolling_swap` to seed-99 weights under 16
           clients (both flipped, no capture, every stream equal to its
           version's on engines of the same slab; each engine's ms under
           its tick lock), a second roll with an objective breached and
           gate 0 rolled back;
  nd       slice 6's path, after the trainer: `resnet50_v1_nd`, a ResNet-50
           v1 train step written only with `mx.nd` ops and `mx.autograd`
           (the same function the CPU test runs on the JAX package), at full
           width (batch 32 at 224 x 224, 1000 classes, weights Xavier from
           seed 0) in fp32 with TF32 off and in bf16: 2 warm-up steps and 5
           timed, SGD with momentum through `nd.sgd_mom_update`. Prints the
           median step, img/s, the host's enqueue time, the step's FLOP
           bound (its convolutions and FullyConnected, forward x 3) and its
           share, peak memory and the card line. Checks, each raising: (a)
           finite loss and gradients, every BatchNorm moving stat moved;
           (b) a small fp32 version (`ND_SMALL`) stepped twice on the card
           and on the CPU agrees (losses, gradients, weights, momenta and
           moving stats); (c) every case of the op table (`op_cases`, one or
           more for each name the port registers) forward and backward on
           the card against the CPU (the random ops' by shape and dtype),
           Dropout's training statistics, and the random ops' draws on the
           card and on the CPU (`random_draw_checks`: each distribution's
           mean and variance from 10^6 draws within 5 standard errors of
           the closed form, multinomial frequencies and log-probabilities,
           ``shuffle`` a permutation, zipfian draws distinct with the
           CPU's tries, ``randint`` in range), and every random op inside
           a hybridized block's captured graph drawing anew at each
           replay (`random_in_graph`); (d) no kernel launched;
  gluon    slice 7's path, after nd: `gluon_train` (`bench.py:584-652`'s
           `_measure_framework` loop, the same function the CPU test runs
           on the JAX package) on the model zoo's `resnet50_v1(classes=1000)`
           at batch 32 x 224², fp32 (TF32 off) and bf16: Xavier weights,
           hybridized (forward and backward captured as CUDA graphs), a
           hybridized `SoftmaxCrossEntropyLoss`, `NDArrayIter` over 4
           batches, the SGD `Trainer` (multi-precision in bf16, the fused
           multi-tensor update); one warm-up epoch (the captures), then two
           timed, each step paced by reading an updated weight. Prints
           img/s, the median step, the host's enqueue time, the capture
           seconds, programs and graphs captured, the FLOP bound and its
           share, peak memory and the card line. Checks, each raising: (a)
           finite losses and gradients, every BatchNorm moving stat moved;
           (b) a small ResNet v1 (`GLUON_SMALL`) stepped twice on the card
           and on the CPU, and hybridized and eager on the card, agrees
           (losses, weights, momenta, moving stats); (c) one epoch of it
           with `MXNET_FUSED_STEP=0` (the aggregated `multi_sgd_mom_update`
           ops) gives the fused update's weights and momenta within rtol
           1e-6 / atol 1e-6; (d) no capture after the warm-up epoch; (e)
           `mx.metric.Accuracy` of the small model's predictions equal on
           the card and on the CPU; (f) no kernel launched; and a
           hybridized Dropout's replays draw new masks at the right rate.
           Then `SGD.fused_update`'s float form (the Trainer's) against
           its device-tensor form (the Module step's) on the fp32 run's
           parameters: equal within rtol 1e-6 / atol 1e-6, and each
           one's time;
  module   slice 8's path, after gluon: `module_train` (`bench.py:684-768`'s
           `_measure_module` loop, the same function the CPU test runs on
           the JAX package) on `resnet50_symbol(1000, (3, 224, 224))` at
           batch 32 x 224², fp32 (TF32 off): `mx.mod.Module` on an
           `NDArrayIter` over 4 batches, Xavier weights, SGD (lr 0.1,
           momentum 0.9, wd 1e-4); each step `Module.fused_step` (forward,
           backward and the update captured as ONE CUDA graph, replayed),
           then the same with `MXNET_FUSED_STEP=0` (the eager
           forward_backward() + update()); one warm-up epoch and two timed,
           each step paced by reading an updated weight. Prints img/s of
           both, the median step, the host's enqueue time, the capture
           seconds, the steps captured in each epoch, the FLOP bound (the
           symbol's convolutions and FullyConnected through `infer_shape`,
           forward x 3) and its share, peak memory and the card line.
           Checks, each raising: (a) finite outputs, every array moved but
           the fixed gammas; (b) the small symbolic ResNet (`MODULE_SMALL`)
           two steps on the card and on the CPU agree within 1e-4 (outputs,
           weights, momenta, moving stats); (c) five captured steps against
           five eager ones on the card, at rtol 3e-5 / atol 3e-6, with SGD
           and (slice 13) with Adam on `bench.py`'s MLP, whose five steps
           are one capture and four replays; (d) the same under a `FactorScheduler`; (e) no capture after the warm-up
           epoch, and short last batches pad into the graph there is; (f)
           `save_checkpoint` on the card, `Module.load` on the CPU: the
           same symbol text and one forward within 1e-4; (g) no kernel
           launched; and a Dropout in the captured step draws new masks.
           (c) and (d) run with cuDNN's deterministic algorithms, the rest
           with its default ones. Then a reading (`module_noise`): at six
           more initial weights, (d)'s epoch with the default algorithms
           captured once and eager twice, how far capture and how far
           the algorithms' run-to-run noise part the results; with the
           deterministic ones, captured and eager must agree;
  serve    slice 9's path, after module: `serving_probe`
           (`bench.py:1132-1302`'s `_measure_serving` loop, the same
           function the CPU test runs on the JAX package) over the model
           zoo's `resnet50_v1(classes=1000)` (Xavier from seed 0,
           hybridized, exported, its BatchNorm moving stats drawn from seed
           0: means on [-0.1, 0.1), variances on [0.5, 1.5)) served by
           `Predictor.load` at the default ladder 1, 2, 4, 8, 16, 32 in
           fp32 (TF32 off) with its 53 Convolution -> BatchNorm chains
           folded (``TPU_FUSE``), each bucket's forward one CUDA graph: 4
           closed-loop clients of 200 requests (1, 2, 3, 5, 8, 11 rows)
           through a `DynamicBatcher(max_wait_ms=1.0)`, the same loop with
           two live `swap_weights` (to Xavier weights after seed 99 at 30 %
           of the completions, back at 65 %), and the same clients calling
           `Predictor.predict` directly; then the same on `bench.py`'s own
           64 -> 128 -> 8 MLP through `Module.as_predictor(buckets=(2, 4,
           8, 16))`. Prints req/s, img/s, p50/p99, direct req/s, capture
           seconds and counts, the fill ratio, the swap dip, each bucket's
           graph time against its FLOP bound and beside the same
           checkpoint's graph served unfused
           (``MXNET_SUBGRAPH_BACKEND=NONE``), peak memory and the card
           line. Checks, each raising: (a) warm-up captures one graph a
           bucket, the three loops none; (b) every batcher response equals
           the same request direct within rtol 1e-5 / atol 1e-6, and the
           direct ones the unfused symbol's eager forward on the card
           within 1e-4; (c) after each swap a fixed probe request is
           bit-equal to a fresh Predictor's over that weight set, and
           `weights_version` ends at 2; (d) the MLP and a small ResNet v1
           (``TPU_FUSE``) served on the card and on the CPU agree within
           1e-5 and 1e-4, the small ResNet's stats drawn as above; the
           outputs of (b) and (d) must spread (standard deviation at least
           1e-2); (e) four threads hitting an unwarmed predictor at once
           make one capture a bucket; (f) no kernel launched;
  observe  slice 11's observability planes, after serve (`observe_phase`),
           with telemetry, tracing, health and the observatory on over the
           full-width models of the earlier phases, in short windows:
           generate (the default model, a 32 x 2048 slab: a 16-session
           burst with the planes off, then on, equal streams; the tokens
           counter equals the tokens streamed, the census's kv_cache is
           exactly the 512 MiB slab and at most what the allocator holds,
           no capture after warm-up, the tick beacon's median gap within
           2x of the median tick; then 16 prefix sessions and a spec burst
           with the n-gram draft, whose prefix.* / spec.* counters equal
           the engines' counts), serve (the serve phase's ResNet-50 v1
           checkpoint: 200 requests through the batcher off, then on;
           200 requests counted, one complete span tree each; the bucket-32
           program's counted FLOPs within 3 % of the phase's bound),
           module (`Module.fit` of the symbolic ResNet-50 over two batches:
           the step.* histograms count 2, the fit.step beacon moved twice,
           the step program's FLOPs within 3 % of its bound) and the peak
           probes (bf16 and fp32 matmul, a device copy, each below 1.05 x
           the data sheet). Prints the roofline rows of the step,
           bucket-32 and tick programs, the peaks, tokens/s and req/s with
           the planes off and on, and the telemetry snapshot's path;
  overlap  slice 12's overlap lane (`bench.py:1630-1850`), after observe:
           three planes, each with ``MXNET_OVERLAP=0`` then ``=1`` and the
           observatory on for its host gap (wall minus the device time
           between the CUDA events around the step, bucket or tick
           program, medians over the same steps). train: `bench.py`'s MLP
           (512 -> 512 -> 8, batch 256, 8 batches of float64 sources)
           through `Module.fit`, SGD, fed by an `NDArrayIter` that copies
           its batches to the card (nothing to stage), and by one that
           hands them over on the host, at 0.5 MiB (below the staged
           feed's size) and 16 MiB batches (staged on every step with
           overlap on), in 10, 4 and 2 off/on pairs, alternating which
           runs first, with each pair's ratio and their median: final
           params bit-equal across modes and runs, no capture after the
           cold epoch, the rates of both modes printed; serving: the serve
           phase's full-width ResNet-50 v1 checkpoint behind the batcher,
           probe outputs bit-equal; generation: the full-width engine and
           the generate phase's burst, streams equal across modes and to
           the generate phase's. No kernel launched;
  gan      slice 13's path, after overlap (`gan_phase`): the published
           DCGAN (`dcgan_nets` at 64 x 64 x 3: nz 100, ngf = ndf = 64,
           batch 64; two `Trainer`s on Adam, lr 2e-4, beta1 0.5; both nets
           hybridized; fp32, TF32 off) trained by `example/gluon/
           dcgan.py`'s loop on its synthetic blob images with
           `mx.nd.random.normal` noise: 3 warm-up iterations and 20 timed.
           Prints the median iteration, img/s, the host's enqueue time,
           the iteration's FLOP bound (its convolutions and transposed
           convolutions, 9 D and 4 G forwards) against the observatory's
           measured fp32 peak and its share, the instances captured per
           net and signature, host launch calls and the idle share of one
           more iteration under torch.profiler, peak memory and the card
           line; then `example/gluon/dcgan.py` itself at its defaults with
           only its imports changed, and its two figures. Checks, each
           raising: (a) finite losses, every BatchNorm moving stat moved;
           (b) the small DCGAN (`GAN_SMALL`) stepped twice on the card and
           on the CPU from numpy weights and noise, under cuDNN's
           deterministic algorithms, agrees within 1e-4 (losses, weights,
           both Adam moments, moving stats); (c) no capture after the
           warm-up, and netD's recorded signature whose data needs no
           gradient holds two instances; the example's
           ``d-real-minus-fake`` above 0.15; (e) no kernel launched.
           ((d), the new ops on the card, runs in the nd phase's check
           (c).);
  lstm_lm  slice 14's recurrent path, after gan (`lstm_lm_phase`):
           `example/gluon/word_language_model.py`'s `RNNModel` at the
           "large" LSTM LM of Zaremba, Sutskever and Vinyals 2014 (2 x
           1500, embed 1500, dropout 0.65, bptt 35; WikiText-2's 33,278
           words; batch 32, untied), ``model.rnn`` hybridized (the fused
           `RNN` op on cuDNN, one capture), the example's loop (truncated
           BPTT, SGD at its rate 2.0 with the elementwise clip 0.25), fp32
           with TF32 off, over 4 bptt windows of its synthetic corpus: 3
           warm-up iterations and 20 timed. Prints the median iteration,
           tokens/s, the host's enqueue time, the FLOP bound (the gates'
           and the decoder's products, x 3) against the observatory's fp32
           peak and its share, the captures, the RNN op's calls on each
           route, peak memory (and above what earlier phases still hold),
           and host launch calls and the idle share of
           one more iteration under torch.profiler; then the bucketed LM of
           `example/rnn/lstm_bucketing.py`'s ``sym_gen`` through
           `BucketingModule` (2 x 200, embed 200, vocab 10,000, buckets
           10-60, batch 32, SGD; each batch one fused step): captures per
           bucket and steps/s; then the repo's two examples through the
           port with their imports changed (the word LM at ``--vocab 100``,
           the vocabulary its test takes; the bucketing one at its
           defaults, its module's context made the card's). Checks, each
           raising: (a) finite losses, the perplexity of the last 4 timed
           iterations under that of the first 4; (b) the small LSTM LM
           (`LM_SMALL`) from numpy weights, two steps on the card and on
           the CPU, within 1e-4 (losses, every weight, the final states);
           (c) at full width the op's cuDNN route against its step route
           (``cudnn_off``): output, final states and the gradients within
           `ROUTE_TOL` of the scale, with each route's time and the repack
           of the flat vector into cuDNN's layout; (d) no capture after the
           warm-up, one captured step a bucket; (e) the examples'
           perplexities under vocab / 4 and under 20; (f) no kernel
           launched;
  sparse   slice 15's sparse storage path, after lstm_lm (`sparse_phase`),
           fp32, data from seed 0: (1) ``linear``, the repo example
           `example/sparse/linear_classification.py`'s `SparseLinear` (a
           `SparseEmbedding(N, 1)` summed over the active features) at
           Avazu's width as MXNet 1.5's `example/sparse/
           linear_classification/train.py` defines it (N = 1,000,001
           features, batch 8,192, 32 active features a row; labels from the
           example's hidden weight), SGD with ``lazy_update`` at 0.5; (2)
           ``mf``, `example/recommenders/matrix_fact.py`'s `MFNet` at
           MovieLens-10M's id ranges as `example/sparse/
           matrix_factorization` defines them (71,569 users, 65,135 items,
           factor 128, batch 128: 66.75 MiB of `Embedding(sparse_grad=True)`
           tables), ratings from the example's low-rank generator, lazy SGD
           at its rate 1.0, trained through ``kvstore="device"`` and again
           from the same weights through ``dist_sync`` in a one-rank NCCL
           group (destroyed after); each 3 warm-up steps and 20 timed over
           4 batches cycled. Prints for each run the median step, steps/s
           and samples/s, rows touched a step, host syncs a step
           (``set_sync_debug_mode("warn")``), host launch calls and the idle
           share of one more step under torch.profiler, a dense SGD update
           of the same tables (what the lazy update avoids) beside the lazy
           one, the byte bound ((rows gathered + updated + written) x width
           x 4 B at the observatory's measured copy rate), peak memory (the
           phase's own and above what earlier phases hold) and the card
           line; then the repo's two sparse examples through the port with
           only their imports changed (`linear_classification.py` at its
           defaults, `matrix_fact.py --epochs 25`). Checks, each raising:
           (a) every step's gradients are `RowSparseNDArray`s never
           densified through backward, `trainer.step` and `zero_grad`, rows
           no batch touched are bit-equal to their initial values, the loss
           of the last 4 timed steps under that of the first 4; (b) both
           models at `SPARSE_SMALL` with SGD (momentum) and with Adam, two
           steps on the card and on the CPU from numpy weights: weights,
           momenta and moments within 1e-5 relative, every gradient's
           indices equal; (c) lazy SGD and Adam against the dense update
           of the same gradient, on the touched rows within 1e-6 relative,
           the other rows of weight and states bit-equal; (d) ``dist_sync``
           against ``device``: weights within 1e-6, ``kvstore.push_bytes``
           the pushed rows and indices only; (e) the linear example's
           accuracy above 0.9 (its own assert), the matrix factorization
           one's gradients row_sparse and its RMSE under half the RMSE of
           predicting zero (`MF_EXAMPLE_RMSE`: the JAX package's 0.6 rests
           on its initializer's numpy stream, which the example's data
           share); (f) no kernel launched;
  vision   slice 16's image input pipeline and vision model zoo, after
           sparse (`vision_phase`), fp32 with TF32 off: (a) BASELINE.json's
           second configuration (example/image-classification's ResNet-50
           on ImageNet, Gluon, hybridized, ``kvstore="device"``) fed from
           records: 512 images of 256 x 320 x 3 uint8 from seed 0 with
           label-keyed blobs (`example/image-classification/common/
           fit.py`), written as raw pixels by `recordio.pack` into an
           indexed ``.rec`` (120 MiB) in a temporary directory, read by
           `RecordFileDataset` (each record unpacked to a CPU uint8 HWC
           array), `transform_first` of gluon-cv's ImageNet training chain
           (RandomResizedCrop(224), RandomFlipLeftRight, RandomColorJitter
           (0.4, 0.4, 0.4), RandomLighting(0.1), ToTensor, Normalize), a
           `DataLoader` (batch 32, shuffle, last_batch "discard",
           pin_memory, min(16, cpu_count - 2) workers), into
           `resnet50_v1(classes=1000)` trained by `gluon.Trainer` (SGD, lr
           0.05, momentum 0.9, wd 1e-4), 3 warm-up and 20 timed
           iterations (the loss read each; the timed ones from a fresh
           epoch, img/s over their whole wall and, steady, from the median
           iteration), with threads, then worker processes, then the same
           net from device-resident batches (the ceiling). Prints for each
           the median iteration, img/s, the wait
           on the loader, the loader alone (a fresh epoch's first batch
           and its batches a second), the idle share under
           torch.profiler of a second window made like the timed one (a
           fresh epoch, 20 iterations), the bytes copied to the card a
           batch, peak memory, captures after warm-up (0). (b) alexnet, vgg16,
           squeezenet1.1, mobilenet1.0, mobilenetv2_1.0 and densenet121 at
           224², inceptionv3 at 299², 1000 classes, batch 32 from
           device-resident batches, hybridized, SGD, 3 warm-up and 10
           timed steps: the median step, img/s, the step's FLOPs counted
           by FlopCounterMode (one eager step) against the observatory's
           measured fp32 peak, the parameter count (the JAX package's
           pinned counts), captures after warm-up (0). Checks, each
           raising: (c) each family's small model and the record-fed step
           (the gluon phase's small ResNet on 8 small records) one SGD step
           on the card (cuDNN deterministic) and on the CPU from one
           weight file within 1e-4, in predict mode for a net with
           Dropout; the mobilenets train, in float64 on the card against
           the CPU within 1e-4 (gradients too), and in fp32 against the
           CPU's float64 step, the output and loss within 1e-4 of their
           scale and each gradient within 0.5 of its scale (one element
           across a ReLU kink moves one by up to 0.18); the pipeline's
           deterministic image ops and transforms on the card against the
           CPU; `example/gluon/
           image_classification.py` (mobilenetv2_1.0, 3 x 224², batch 8,
           2 batches, 1 epoch) and `example/image-classification/
           train_imagenet.py` (densenet121, ``--benchmark 1``, batch 8, 2
           batches) through the port with only their imports changed; no
           kernel launched;
  kernels  each kernel against its plain PyTorch version on the card, at the
           shapes the main path gives it and at extra cases (every head dim
           and dtype variant of K1 and K2), with times (`cuda_ms`: many calls
           back to back between one pair of CUDA events, queued behind a
           sleep on the card so that it never waits on the host; `call_ms`:
           one call between two events, host time of the wrapper included),
           the plain version's, one PyTorch library call's as a yardstick
           where one exists, the least time the card could take (`bound_ms`,
           H100 SXM peaks), its share of `ms`, and the achieved TFLOP/s;
  profiler ``mx.profiler`` (slice 11), last of all: one full-width train
           step between `profiler.start` and `dump`; the dumped trace must
           hold its 4 K1 launches by the kernel's name, a telemetry counter
           event and the step's span;
and last the card's name and power limit, then {"ok": true, "device":
{...}}. Every kernel's launch count is set
to 0 just before each path and read just after; each path must launch its
own kernels and no other. Any failed check raises, so the script exits
non-zero and prints no last line; so does a machine without a CUDA card.
`--profile` also writes a torch.profiler breakdown of one more step of each
training path (the nd and gluon paths at both dtypes, the module path
fused and eager, taken before its small-model checks, too), of one call
of each form of the fused update, with the host's launch calls, of 20
decode ticks over a full slab, of a window of the serve phase's
full-width batcher traffic (before its small checks), and of the gan and
lstm_lm phases' one more iteration (taken in every run, for their host
launch calls), by kernel, to OUT.json; each profile must hold every launch of
the port's kernels that its step made. A run not over after `--deadline` seconds (default 1100)
dumps every thread's stack and exits 1.
"""
from __future__ import annotations

import argparse
import contextlib
import faulthandler
import hashlib
import json
import math
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3 and FLOP/s by
# input type (bf16 on the tensor cores, fp32 on the FMA pipes)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

TRAIN_STEPS = 3
TRAIN_BATCH, TRAIN_LEN = 8, 2048
COMPRESSION = {"type": "2bit", "threshold": 0.5}  # MXNet's default threshold
RING_SP = 4
# the ring's first loss against the train path's: the same weights and
# tokens, attention rounded to bf16 at other places (K2 hops and the combine
# against K1), over 4 layers
RING_FIRST_LOSS_TOL = 2e-2


def emit(**obj):
    print(json.dumps(obj), flush=True)


def progress(phase):
    """A phase's end on stderr: where a run that is cut stopped."""
    print(f"chip_smoke: {phase} done", file=sys.stderr, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def kernel_wrappers():
    """{kernel name: its wrapper}, each wrapper counting its launches."""
    from mxnet_tpu_torch import gradient_compression as gcm
    from mxnet_tpu_torch.ops import flash_attention as fa

    return {"flash_attention_fwd": fa.flash_attention_fwd_kernel,
            "flash_block_partials": fa.flash_block_partials_kernel,
            "quantize_2bit": gcm.quantize_2bit_kernel}


def reset_launches():
    for fn in kernel_wrappers().values():
        fn.launches = 0


def read_launches():
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def call_ms(fn, reps=20, warmup=3):
    """Median time of one fn() call between two CUDA events: the kernel and
    whatever host time of the wrapper the card waits for."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


SM_HZ = 1.98e9  # H100 SXM boost clock, to size the sleep in cycles


def cuda_ms(fn, reps=5, warmup=3, batch_ms=20.0):
    """Device time of one fn() call: n calls back to back between one pair
    of CUDA events, queued behind `torch.cuda._sleep` long enough to cover
    the host's enqueueing of all n, so the card never waits on the host;
    the median over `reps` batches of the elapsed time over n."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    n = max(1, min(200, int(batch_ms / max(call_ms(fn, reps=3), 1e-3))))
    t0 = time.perf_counter()
    fn()  # the host's time to enqueue one call
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    sleep_cycles = int(min(1e9, max(1e6, 2 * n * host_s * SM_HZ)))
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def rates(ms, bound_ms, flop):
    """The share of the bound that `ms` reaches and the achieved TFLOP/s."""
    return {"bound_share": bound_ms / ms, "tflops": flop / (ms * 1e-3) / 1e12}


def attention_bound(b, lq, lk, h, d, dtype, causal, bias=False,
                    stats=False):
    """(ms, "bytes" | "operations", FLOP): the least time for one attention
    call and the operations it counts,
    counting q, k, v read once and o written once, and the 2*2*d FLOP of
    QK^T and PV for each (query, key) pair the causal mask keeps (every
    pair when `causal` is false: a bias is data, and K2 computes every
    tile). `bias` adds the read of one (lq, lk) fp32 bias, `stats` the
    writes of the fp32 row max and sum-exp ([b, h, lq] each)."""
    elt = 2 if dtype == "bfloat16" else 4
    nbytes = elt * h * d * b * (2 * lq + 2 * lk)
    nbytes += 4 * lq * lk * bias + 2 * 4 * b * h * lq * stats
    pairs = b * h * (lq * (lq + 1) // 2 if causal else lq * lk)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = 4 * d * pairs / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes > t_ops else "operations", 4 * d * pairs)


def default_model_and_batch(torch, mesh=None):
    """The default `TransformerLM` on cuda from seed 0 and one batch of
    tokens and targets drawn after its weights: the same weights and tokens
    for every path."""
    from mxnet_tpu_torch.models import TransformerLM, TransformerLMConfig

    cfg = TransformerLMConfig()
    gen = torch.Generator(device="cuda").manual_seed(0)
    lm = TransformerLM(cfg, device="cuda", generator=gen, mesh=mesh)
    shape = (TRAIN_BATCH, TRAIN_LEN)
    tokens = torch.randint(0, cfg.vocab_size, shape, generator=gen,
                           device="cuda")
    targets = torch.randint(0, cfg.vocab_size, shape, generator=gen,
                            device="cuda")
    return cfg, lm, tokens, targets


def train_phase(torch, mesh=None):
    """3 Adam steps of the default model (`make_train_step`); with a mesh
    whose sp axis is above 1, attention is ring attention over it (slice
    3), else the local flash-attention forward (slice 1)."""
    from mxnet_tpu_torch.parallel import axis_size

    held = torch.cuda.memory_allocated() / 1e9  # by earlier phases
    cfg, lm, tokens, targets = default_model_and_batch(torch, mesh)
    sp = axis_size(mesh, "sp")
    n_params = sum(p.numel() for p in lm.parameters())
    step, init_opt = lm.make_train_step(lr=1e-3)
    state = init_opt()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_launches()
    losses, seconds = [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss = step(state, tokens, targets, i)
        losses.append(float(loss))  # waits for the step
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    launches = read_launches()

    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    # one batch repeated: three Adam steps must bring its loss down
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(all(bool(torch.isfinite(p).all()) for p in lm.parameters()),
          "non-finite parameter after training")
    attention = TRAIN_STEPS * cfg.n_layers
    want = {"flash_attention_fwd": attention if sp == 1 else 0,
            # every position against every K/V block, in every layer
            "flash_block_partials": attention * sp * sp if sp > 1 else 0,
            "quantize_2bit": 0}
    check(launches == want, f"path launched {launches}, want {want}")
    tail = statistics.median(seconds[1:])
    result = {
        "config": "TransformerLMConfig() defaults", "params": n_params,
        "batch": TRAIN_BATCH, "seq_len": TRAIN_LEN, "steps": TRAIN_STEPS,
        "losses": losses, "step_s": seconds,
        "tokens_per_s": TRAIN_BATCH * TRAIN_LEN / tail,
        "tokens_per_s_from": "median of steps 2..3",
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "held_before_gb": held, "kernel_launches": launches,
    }
    if mesh is not None:
        result["mesh"] = {"shape": mesh.shape,
                          "positions": [str(d) for d in mesh.devices]}
    return result, (lm, step, state, tokens, targets)


def ring_phase(torch, train):
    """Slice 3's path: the train phase's model, weights and batch with a
    4-way sp mesh whose positions all sit on cuda:0. Its first loss must be
    the train phase's, up to bf16 rounding: the same function, with
    attention through K2 and the combine instead of K1."""
    from mxnet_tpu_torch.parallel import create_mesh

    mesh = create_mesh(devices=[torch.device("cuda", 0)] * RING_SP,
                       sp=RING_SP)
    ring, ring_state = train_phase(torch, mesh)
    diff = abs(ring["losses"][0] - train["losses"][0])
    check(diff <= RING_FIRST_LOSS_TOL,
          f"ring first loss {ring['losses'][0]} vs the train path's "
          f"{train['losses'][0]}: {diff} > {RING_FIRST_LOSS_TOL}")
    ring.update(first_loss_vs_train=diff,
                first_loss_tol=RING_FIRST_LOSS_TOL)
    return ring, ring_state


def small_reference_phase(torch, sp=1):
    """The main path on a small fp32 input, on the card (through the
    kernels) and on the CPU (through the plain versions), from the same
    weights; with `sp` > 1, ring attention over that many positions, on
    cuda:0 and on the CPU."""
    from mxnet_tpu_torch.models import TransformerLM, TransformerLMConfig
    from mxnet_tpu_torch.parallel import create_mesh

    cfg = TransformerLMConfig(vocab_size=512, d_model=128, n_heads=2,
                              d_ff=256, n_layers=2, max_len=256,
                              dtype="float32")

    def mesh(device):
        return create_mesh(devices=[device] * sp, sp=sp) if sp > 1 else None

    gen = torch.Generator().manual_seed(1)
    cpu = TransformerLM(cfg, device="cpu", generator=gen, mesh=mesh("cpu"))
    gpu = TransformerLM(cfg, device="cuda", mesh=mesh("cuda:0"))
    gpu.load_state_dict(cpu.state_dict())
    tokens = torch.randint(0, cfg.vocab_size, (2, 200), generator=gen)
    targets = torch.randint(0, cfg.vocab_size, (2, 200), generator=gen)
    with torch.no_grad():
        want = cpu(tokens)
        got = gpu(tokens.cuda()).cpu()
        loss_cpu = float(cpu.loss(tokens, targets))
        loss_gpu = float(gpu.loss(tokens.cuda(), targets.cuda()))
    check(got.shape == (2, 200, cfg.vocab_size), f"logits shape {got.shape}")
    err = float((got - want).abs().max())
    tol = 1e-4  # fp32 on both, sums in another order: a few ulp per layer
    check(err <= tol, f"small fp32 logits card vs CPU: max err {err} > {tol}")
    check(abs(loss_gpu - loss_cpu) <= tol,
          f"small fp32 loss card {loss_gpu} vs CPU {loss_cpu}")
    return {"shape": [2, 200], "config": "vocab 512, d_model 128, 2 heads, "
            "2 layers, fp32", "sp": sp, "logits_max_abs_err": err, "tol": tol,
            "loss_card": loss_gpu, "loss_cpu": loss_cpu}


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def env_scope(env):
    """The environment variables ``env`` (name -> value) set for the
    block, restored on exit."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield env
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def one_rank_group_env():
    """The environment of a one-rank process group on a free localhost port,
    restored on exit."""
    return env_scope({"MXNET_COORDINATOR": f"127.0.0.1:{free_port()}",
                      "MXNET_NUM_PROCESSES": "1", "MXNET_PROCESS_ID": "0"})


def nonzero_code_share(packs, n_values):
    """Share of the n_values whose 2-bit code is not 0, over packed words."""
    import torch

    shifts = torch.arange(16, dtype=torch.int32, device=packs[0].device) * 2
    nonzero = sum(int((((p.unsqueeze(-1) >> shifts) & 3) != 0).sum())
                  for p in packs)
    return nonzero / n_values


def trainer_phase(torch, profile=False):
    """Slice 2's path: `gluon.Trainer` over a compressed `dist_sync` store in
    a one-rank NCCL group, at the default config. Returns the result and,
    when `profile`, the profile of one more step (else None)."""
    import torch.distributed as dist

    from mxnet_tpu_torch import gradient_compression as gcm
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.parallel import KVStoreDistTPUSync

    held = torch.cuda.memory_allocated() / 1e9  # by earlier phases
    cfg, lm, tokens, targets = default_model_and_batch(torch)
    n_tokens = TRAIN_BATCH * TRAIN_LEN
    n_keys = len(list(lm.parameters()))  # the tied head is embed itself
    n_values = sum(p.numel() for p in lm.parameters())

    # observe the packed words the store hands to the all-gather, to count
    # the codes that fired; the launches still go through the kernel wrapper
    packs = []
    real_quantize = gcm.GradientCompression.quantize

    def observed(self, key, grad):
        packed = real_quantize(self, key, grad)
        packs.append(packed)
        return packed

    def one_step(trainer):
        from torch.profiler import record_function

        with record_function("forward_backward"):
            loss = lm.loss(tokens, targets) * n_tokens  # sum of token NLLs
            loss.backward()
        with record_function("trainer.step"):
            trainer.step(n_tokens)  # rescale_grad = 1/batch, after the push
        return loss

    with one_rank_group_env() as env:
        try:
            trainer = Trainer(dict(lm.named_parameters()), "adam",
                              {"learning_rate": 1e-3,
                               "multi_precision": True},
                              kvstore="dist_sync",
                              compression_params=COMPRESSION)
            gcm.GradientCompression.quantize = observed
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            # MXNET_TELEMETRY=1 for the steps: the dist.* and kvstore.*
            # series of the path
            tele_was = telemetry.enabled()
            telemetry.reset()
            telemetry.enable()
            reset_launches()
            losses, seconds, shares = [], [], []
            for _ in range(TRAIN_STEPS):
                t0 = time.perf_counter()
                loss = one_step(trainer)
                losses.append(float(loss.detach()) / n_tokens)
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
                shares.append(nonzero_code_share(packs, n_values))
                packs.clear()
            launches = read_launches()
            snap = telemetry.snapshot()
            telemetry.enable(tele_was)
            telemetry.reset()
            gcm.GradientCompression.quantize = real_quantize
            kv = trainer._kvstore
            check(isinstance(kv, KVStoreDistTPUSync) and kv.num_workers == 1
                  and dist.get_backend() == "nccl",
                  "the trainer's store is not a one-rank NCCL dist store")
            check(not trainer._update_on_kvstore,
                  "a dist store must update on the worker")
            peak = torch.cuda.max_memory_allocated() / 1e9
            check(all(math.isfinite(x) for x in losses),
                  f"non-finite trainer loss {losses}")
            check(losses[-1] < losses[0], f"trainer loss did not fall: "
                  f"{losses} (nonzero code shares {shares})")
            check(all(bool(torch.isfinite(p).all())
                      for p in lm.parameters()),
                  "non-finite parameter after trainer steps")
            want = {"quantize_2bit": n_keys * TRAIN_STEPS,
                    "flash_attention_fwd": cfg.n_layers * TRAIN_STEPS,
                    "flash_block_partials": 0}
            check(launches == want,
                  f"trainer path launched {launches}, want {want}")
            series = trainer_series(snap, lm)
            profiled = profile_step(
                torch, lambda: one_step(trainer),
                must_run=("K1 flash_attention_fwd", "K3 quantize_2bit")) \
                if profile else None
        finally:
            gcm.GradientCompression.quantize = real_quantize
            if dist.is_initialized():
                dist.destroy_process_group()
    tail = statistics.median(seconds[1:])
    return {
        "config": "TransformerLMConfig() defaults", "params": n_values,
        "keys": n_keys, "batch": TRAIN_BATCH, "seq_len": TRAIN_LEN,
        "steps": TRAIN_STEPS, "optimizer": "adam, lr 1e-3, multi_precision",
        "kvstore": "dist_sync, one rank, NCCL",
        "coordinator": env["MXNET_COORDINATOR"],
        "compression": COMPRESSION,
        "losses_are": "mean token NLL (the summed loss over B*L)",
        "losses": losses, "step_s": seconds,
        "tokens_per_s": n_tokens / tail,
        "tokens_per_s_from": "median of steps 2..3",
        "nonzero_code_share": shares,
        "peak_mem_gb": peak, "held_before_gb": held,
        "kernel_launches": launches, "telemetry": series,
    }, profiled


def trainer_series(snap, lm):
    """Check the trainer's telemetry over its steps: the ``dist.*_bytes``
    counters are the bytes of the 32-bit words K3 packs (4 x ceil(n / 16)
    for a parameter of n values, each step), and ``kvstore.push_bytes`` /
    ``pull_bytes`` the dense gradients'. Returns the series read."""
    counters = snap["counters"]
    dist_bytes = {k: v for k, v in counters.items()
                  if k.startswith("dist.") and k.endswith("_bytes")}
    packed = TRAIN_STEPS * sum(4 * -(-p.numel() // 16)
                               for p in lm.parameters())
    dense = TRAIN_STEPS * sum(p.numel() * p.element_size()
                              for p in lm.parameters())
    check(sum(dist_bytes.values()) == packed,
          f"trainer: dist.*_bytes {dist_bytes}, want K3's packed {packed}")
    for name in ("kvstore.push_bytes", "kvstore.pull_bytes"):
        check(counters.get(name) == dense,
              f"trainer: {name} {counters.get(name)}, want the dense "
              f"{dense}")
    n_keys = TRAIN_STEPS * len(list(lm.parameters()))
    check(counters.get("dist.allgather_calls") == n_keys,
          f"trainer: {counters.get('dist.allgather_calls')} all-gathers, "
          f"want {n_keys}")
    hist = snap["histograms"].get("dist.allgather_us", {})
    return {"dist_bytes": dist_bytes, "k3_packed_bytes": packed,
            "kvstore_push_bytes": counters["kvstore.push_bytes"],
            "kvstore_pull_bytes": counters["kvstore.pull_bytes"],
            "dense_bytes": dense,
            "allgather_calls": counters["dist.allgather_calls"],
            "allgather_host_us_p50": hist.get("p50"),
            "push_collectives": counters.get("dist.push_collectives")}


GEN_SLOTS, GEN_MAX_LEN = 32, 2048          # docs/faq/perf.md:495
GEN_BURST, GEN_NEW = 64, 128
GEN_PROMPT_LENS = (16, 1024)               # uniform, RandomState(0)
GEN_RERUN = 8
FLAT_PROMPT, FLAT_NEW = 4, 512
GEN_LOGIT_TOL = 2e-2  # bf16 logits of a graph replay vs an eager call
GEN_PROFILE_TICKS = 20


def percentile_ms(values, q):
    import numpy as np

    return float(np.percentile(values, q)) * 1e3


def decode_bound(lm, eng):
    """(ms, "bytes" | "operations", bytes): the least time of one decode
    tick, reading the slab and every weight once (of `pos_embed` only the
    slots' rows), and doing 2 FLOP a weight and slot plus QK^T and PV over
    every slab row, at the bf16 tensor-core rate."""
    cfg = lm.cfg
    weights = sum(p.nbytes for p in lm.parameters())
    weights -= lm.pos_embed.nbytes - GEN_SLOTS * lm.pos_embed[0].nbytes
    nbytes = eng.kv_slab_bytes() + weights
    params = sum(p.numel() for p in lm.parameters()) - lm.pos_embed.numel()
    flop = 2 * params * GEN_SLOTS + \
        4 * GEN_SLOTS * cfg.n_layers * cfg.d_model * GEN_MAX_LEN
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flop / PEAK_FLOPS[cfg.dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes > t_ops else "operations", nbytes)


def graph_vs_eager(torch, lm, eng, rng):
    """Check (c): one graph-replayed decode tick against an eager
    `decode_step` on a copy of the same slab and inputs. The engine must be
    idle; every slot is written at a random row, as garbage a later
    session's prefill and decode overwrite before reading."""
    prog = eng._decode_fn()
    tokens = rng.randint(0, lm.cfg.vocab_size, GEN_SLOTS)
    positions = rng.randint(0, GEN_MAX_LEN, GEN_SLOTS)
    ck, cv = eng._ck.clone(), eng._cv.clone()
    got = prog(tokens, positions)
    graph_logits = prog.outputs[1].clone()
    eager, _, _ = lm.decode_step(ck, cv, torch.from_numpy(tokens).cuda(),
                                 torch.from_numpy(positions).cuda())
    del ck, cv
    diff = float((eager - graph_logits).abs().max())
    same = bool((eager.argmax(-1).cpu().numpy() == got).all())
    check(same, "graph-replayed decode's greedy tokens differ from eager "
          "decode_step's")
    check(diff <= GEN_LOGIT_TOL, f"graph-replayed decode logits differ from "
          f"eager decode_step's by {diff} > {GEN_LOGIT_TOL}")
    return {"tokens_equal": same, "max_abs_logit_diff": diff,
            "tol": GEN_LOGIT_TOL}


def profile_ticks(torch, eng, prompts):
    """A profile of GEN_PROFILE_TICKS ticks over a full slab, all run by
    this thread with the tick lock held from before the sessions are
    admitted until after the profiler stops: on an H100 with torch 2.11,
    stopping the profiler while the worker thread replayed a graph
    deadlocked, and the worker, which retakes the lock at once after each
    tick, kept this thread from taking it for a whole session."""
    with eng._tick_lock:
        streams = [eng.submit(p[:16], max_new_tokens=4 * GEN_PROFILE_TICKS)
                   for p in prompts[:GEN_SLOTS]]
        while eng.live_slots < GEN_SLOTS:   # each tick admits >= 1
            eng._tick()

        def window():
            for _ in range(GEN_PROFILE_TICKS):
                eng._tick()
            check(eng.live_slots == GEN_SLOTS,
                  "a profiled session ended inside the window")

        prof = profile_step(torch, window, must_run=("matmul",))
    for s in streams:
        s.result(timeout=300)
    return prof


def generate_phase(torch, card, profile=False):
    """Slice 5's path: `GenerationEngine` over the default model with a
    32 x 2048 slab, served by its worker thread. Returns the result, when
    `profile` a profile of 20 decode ticks (else None), and the model, the
    burst's prompts and its streams, which the lanes of slice 10 reuse."""
    import numpy as np

    from mxnet_tpu_torch.models import TransformerLM, TransformerLMConfig
    from mxnet_tpu_torch.serving import warmup
    from mxnet_tpu_torch.serving.generation import GenerationEngine

    held = torch.cuda.memory_allocated() / 1e9  # by earlier phases
    cfg = TransformerLMConfig()
    lm = TransformerLM(cfg, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.RandomState(0)
    lens = rng.randint(GEN_PROMPT_LENS[0], GEN_PROMPT_LENS[1] + 1, GEN_BURST)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in lens]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_launches()
    eng = GenerationEngine(lm, max_slots=GEN_SLOTS, max_len=GEN_MAX_LEN)
    try:
        ticks = []  # wall seconds of every tick the engine runs
        real_tick = eng._tick

        def timed_tick():
            t0 = time.perf_counter()
            real_tick()
            ticks.append(time.perf_counter() - t0)

        eng._tick = timed_tick
        n_programs = len(eng.prefill_buckets) + 1
        warm = [warmup(eng), warmup(eng)]
        check(len(eng.prefill_buckets) == 9, f"prefill ladder "
              f"{eng.prefill_buckets}, want 8, 16, ..., 2048")
        check(warm[0]["compiles"] == warm[0]["captures"] == n_programs,
              f"first warm-up {warm[0]}: want {n_programs} captures")
        check(warm[1]["compiles"] == warm[1]["captures"] == 0,
              f"second warm-up {warm[1]}: want no capture")
        misses0, captures0 = eng.cache.misses, eng.captures

        ticks.clear()
        t0 = time.perf_counter()
        streams = [eng.submit(p, max_new_tokens=GEN_NEW) for p in prompts]
        outs = [s.result(timeout=600) for s in streams]
        wall = time.perf_counter() - t0
        burst_ticks = list(ticks)
        check(all(len(o) == GEN_NEW for o in outs),
              "a burst session ended early")
        ttft = [s.first_token_at - s.submitted_at for s in streams]

        # O(1) flatness: one long stream alone, inter-token gap late / early
        gaps, t_prev = [], time.perf_counter()
        for _ in eng.submit(prompts[0][:FLAT_PROMPT],
                            max_new_tokens=FLAT_NEW):
            now = time.perf_counter()
            gaps.append(now - t_prev)
            t_prev = now
        check(len(gaps) == FLAT_NEW, f"flatness stream gave {len(gaps)}")
        third = len(gaps) // 3
        flatness = (statistics.median(gaps[-third:])
                    / statistics.median(gaps[1:1 + third]))

        # (b) sessions of both admission waves rerun alone, bit for bit
        rerun = list(range(0, GEN_BURST, GEN_BURST // GEN_RERUN))
        for i in rerun:
            alone = eng.generate(prompts[i], max_new_tokens=GEN_NEW)
            check(alone == outs[i], f"burst session {i} rerun alone gave "
                  f"other tokens")
        # (a) steady state captured and built nothing
        steady = {"misses": eng.cache.misses - misses0,
                  "captures": eng.captures - captures0}
        check(steady == {"misses": 0, "captures": 0},
              f"steady-state traffic built programs: {steady}")

        with eng._tick_lock:
            check(eng.live_slots == 0 and eng.queue_depth == 0,
                  "engine not idle before the graph checks")
            exact = graph_vs_eager(torch, lm, eng, rng)  # (c)
            decode = eng._decode_fn()
            decode_ms = cuda_ms(decode.graph.replay)
            prefill_ms = {b: cuda_ms(eng._prefill_fn(b).graph.replay)
                          for b in eng.prefill_buckets}
        peak = torch.cuda.max_memory_allocated() / 1e9
        profiled = profile_ticks(torch, eng, prompts) if profile else None
        launches = read_launches()
        # (e) no TPU kernel lies on this path
        check(not any(launches.values()),
              f"generate path launched {launches}, want none")
        kv_bytes = eng.kv_slab_bytes()
        keys = sorted(map(repr, eng.cache.keys()))
    finally:
        eng.close(timeout=60)
    bound_ms, bound_by, nbytes = decode_bound(lm, eng)
    n_tokens = sum(len(o) for o in outs)
    return {
        "config": "TransformerLMConfig() defaults",
        "params": sum(p.numel() for p in lm.parameters()),
        "slots": GEN_SLOTS, "max_len": GEN_MAX_LEN,
        "buckets": list(eng.prefill_buckets), "kv_slab_bytes": kv_bytes,
        "card": card, "warm": warm,
        "burst": {"sessions": GEN_BURST, "prompt_lens": "uniform "
                  f"{GEN_PROMPT_LENS[0]}-{GEN_PROMPT_LENS[1]}, "
                  "RandomState(0)", "max_new_tokens": GEN_NEW,
                  "tokens": n_tokens, "wall_s": wall,
                  "tokens_per_s": n_tokens / wall,
                  "ttft_ms_p50": percentile_ms(ttft, 50),
                  "ttft_ms_p99": percentile_ms(ttft, 99),
                  "ticks": len(burst_ticks),
                  "tick_ms_median": statistics.median(burst_ticks) * 1e3},
        "steady_state_builds": steady, "rerun_bit_equal": rerun,
        "graph_keys": keys, "streams_sha256": hashlib.sha256(
            json.dumps(outs).encode()).hexdigest(),
        "graph_vs_eager": exact,
        "decode_graph_ms": decode_ms, "decode_bound_ms": bound_ms,
        "decode_bound_by": bound_by, "decode_bytes": nbytes,
        "decode_bound_share": bound_ms / decode_ms,
        "scores": "bmm with out_dtype=float32 on bf16 operands",
        "prefill_graph_ms": prefill_ms,
        "flatness": flatness, "flatness_stream": f"{FLAT_PROMPT}-token "
        f"prompt, {FLAT_NEW} tokens, median gap of the last third / the "
        "first third",
        "peak_mem_gb": peak, "held_before_gb": held,
        "kernel_launches": launches,
    }, profiled, {"lm": lm, "prompts": prompts, "outs": outs,
                  "decode_graph_ms": decode_ms, "wall_s": wall}


def explain_mismatch(torch, cpu, prompts, card_streams, cpu_streams, what):
    """Raise on the first session whose card and CPU streams differ,
    with the CPU model's top-2 logit gap where they part (a near tie is
    rounding, not a fault)."""
    for i, (a, b) in enumerate(zip(card_streams, cpu_streams)):
        if a != b:
            k = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
            seq = torch.tensor([list(prompts[i]) + b[:k]])
            with torch.no_grad():
                top = cpu(seq)[0, -1].float().topk(2).values
            check(False, f"{what} session {i}: card and CPU streams differ "
                  f"at token {k} ({a[k]} vs {b[k]}); CPU top-2 logit gap "
                  f"{float(top[0] - top[1])}")


def small_lanes(torch, gpu, cpu, kw):
    """Check (d) of slice 10: the small model's speculative (n-gram, k =
    3), prefix-cache and weight-swap lanes on the card and on the CPU give
    equal streams; the verify step's and the suffix prefill's logits
    agree within 1e-4."""
    import numpy as np

    from mxnet_tpu_torch.models import TransformerLM
    from mxnet_tpu_torch.serving.generation import (GenerationEngine,
                                                    NgramDraft)

    cfg = cpu.cfg
    rng = np.random.RandomState(3)
    system = rng.randint(0, cfg.vocab_size, 24)
    shared = [np.concatenate([system, rng.randint(0, cfg.vocab_size, n)])
              for n in rng.randint(1, 20, 6)]
    plain = [rng.randint(0, cfg.vocab_size, n)
             for n in rng.randint(2, 60, 6)]
    other = TransformerLM(cfg, device="cpu", generator=torch.Generator()
                          .manual_seed(2)).state_dict()
    streams = {}
    for name, model in (("card", gpu), ("cpu", cpu)):
        out = streams[name] = {}
        with GenerationEngine(model, spec_k=3, draft=NgramDraft(),
                              **kw) as eng:
            out["spec"] = [eng.generate(p, max_new_tokens=16) for p in plain]
        with GenerationEngine(model, prefix_cache=True, prefix_min_tokens=4,
                              **kw) as eng:
            out["prefix"] = [eng.generate(p, max_new_tokens=16)
                             for p in shared]
            out["prefix_hits"] = eng.prefix_hits
        eng = GenerationEngine(model, start=False, **kw)
        first = eng.submit(plain[0], max_new_tokens=16)
        for _ in range(4):
            eng._tick_once()
        eng.swap_weights(other)
        second = eng.submit(plain[1], max_new_tokens=16)
        while not (first.done and second.done):
            eng._tick_once()
        out["swap"] = [first.result(), second.result()]
        eng.close()
    for lane, prompts in (("spec", plain), ("prefix", shared),
                          ("swap", plain[:2])):
        explain_mismatch(torch, cpu, prompts, streams["card"][lane],
                         streams["cpu"][lane], f"small {lane}")
    check(streams["card"]["prefix_hits"] == len(shared) - 1,
          f"small prefix lane: {streams['card']['prefix_hits']} hits")

    tol = 1e-4  # fp32 on both, sums in another order: a few ulp per layer
    toks = rng.randint(0, cfg.vocab_size, 64)
    block = rng.randint(0, cfg.vocab_size, (4, 4))
    logits = {}
    for name, model in (("card", gpu), ("cpu", cpu)):
        dev = model.device
        ck, cv = model.init_cache(4, cfg.max_len)
        model.prefill(ck, cv, torch.from_numpy(toks[:32]).to(dev), 24, 0)
        for t in (ck, cv):
            t[1].copy_(t[0])
        sfx, _, _ = model.prefill_at(ck, cv, torch.from_numpy(
            toks[24:40]).to(dev), 16, 1, 24)
        ver, _, _ = model.verify_step(
            ck, cv, torch.from_numpy(block).to(dev),
            torch.tensor([24, 40, 0, 0], device=dev))
        logits[name] = (sfx.cpu(), ver.cpu())
    errs = [float((a - b).abs().max())
            for a, b in zip(logits["card"], logits["cpu"])]
    check(max(errs) <= tol, f"small fp32 suffix prefill / verify logits "
          f"card vs CPU: max err {errs} > {tol}")
    return {"lanes": ["spec k=3 n-gram", "prefix cache", "swap"],
            "streams_equal": True,
            "tokens": sum(len(x) for lane in ("spec", "prefix", "swap")
                          for x in streams["card"][lane]),
            "prefix_hits": streams["card"]["prefix_hits"],
            "suffix_prefill_verify_logits_max_abs_err": errs, "tol": tol}


def small_generate_phase(torch):
    """Check (d): the small fp32 model of `small_reference_phase` with the
    same weights served on the card (through captured graphs) and on the
    CPU (eager): equal greedy streams over 8 ragged sessions, and prefill
    and decode logits within 1e-4; then the same for the lanes of slice 10
    (`small_lanes`)."""
    import numpy as np

    from mxnet_tpu_torch.models import TransformerLM, TransformerLMConfig
    from mxnet_tpu_torch.serving.generation import GenerationEngine

    cfg = TransformerLMConfig(vocab_size=512, d_model=128, n_heads=2,
                              d_ff=256, n_layers=2, max_len=256,
                              dtype="float32")
    cpu = TransformerLM(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(1))
    gpu = TransformerLM(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, cfg.vocab_size, n)
               for n in rng.randint(2, 60, 8)]
    news = [16 + 8 * (i % 3) for i in range(len(prompts))]
    kw = dict(max_slots=4, max_len=cfg.max_len, buckets=(8, 16, 32, 64))
    streams = {}
    for name, model in (("card", gpu), ("cpu", cpu)):
        with GenerationEngine(model, **kw) as eng:
            streams[name] = [s.result(timeout=300) for s in
                             [eng.submit(p, max_new_tokens=n)
                              for p, n in zip(prompts, news)]]
            if name == "card":
                captures = eng.captures
    explain_mismatch(torch, cpu, prompts, streams["card"], streams["cpu"],
                     "small plain")

    tol = 1e-4  # fp32 on both, sums in another order: a few ulp per layer
    toks = np.zeros(64, np.int64)
    toks[:len(prompts[0])] = prompts[0]
    positions = np.full(4, cfg.max_len - 1)
    logits = {}
    for name, model in (("card", gpu), ("cpu", cpu)):
        dev = model.device
        ck, cv = model.init_cache(4, cfg.max_len)
        pre, _, _ = model.prefill(ck, cv, torch.from_numpy(toks).to(dev),
                                  len(prompts[0]), 2)
        steps = [pre.cpu()]
        tokens = np.zeros(4, np.int64)
        tok, pos = int(pre.argmax()), len(prompts[0])
        for _ in range(3):
            tokens[2], positions[2] = tok, pos
            out, _, _ = model.decode_step(
                ck, cv, torch.from_numpy(tokens).to(dev),
                torch.from_numpy(positions).to(dev))
            steps.append(out.cpu())
            tok, pos = int(out[2].argmax()), pos + 1
        logits[name] = steps
    errs = [float((a - b).abs().max())
            for a, b in zip(logits["card"], logits["cpu"])]
    check(max(errs) <= tol, f"small fp32 prefill/decode logits card vs CPU: "
          f"max err {errs} > {tol}")
    return {"config": "vocab 512, d_model 128, 2 heads, 2 layers, fp32",
            "sessions": len(prompts), "streams_equal": True,
            "tokens": sum(len(s) for s in streams["card"]),
            "card_captures": captures,
            "prefill_decode_logits_max_abs_err": errs, "tol": tol,
            "lanes": small_lanes(torch, gpu, cpu, kw)}


# --- the generation lanes (slice 10): prefix cache, speculative, swap -----

SPEC_K = 4                          # bench.py:1418-1424, with NgramDraft
PREFIX_SYSTEM, PREFIX_TAILS = 1024, (16, 256)   # uniform, RandomState(1)
PREFIX_MIN = 8                      # bench.py:1464
# split points of the fork check: each suffix's bucket fits past its split
PREFIX_SPLITS = (256, 768, PREFIX_SYSTEM)
ROUTER_SLOTS, ROUTER_SESSIONS, ROUTER_SPREAD = 16, 24, 16
SWAP_CLIENTS = 16                   # closed-loop clients of the swap lane


class HeldTimer:
    """A lock that records how long each thread last held it: the tick
    lock of an engine, wrapped before its first tick, so a swap's time
    under the lock can be read."""

    def __init__(self, lock):
        import threading

        self._lock = lock
        self._since = {}
        self.held_s = {}
        self._ident = threading.get_ident

    def acquire(self, blocking=True, timeout=-1):
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            self._since[self._ident()] = time.perf_counter()
        return ok

    def release(self):
        me = self._ident()
        self.held_s[me] = time.perf_counter() - self._since.pop(me)
        self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()


def lane_engine(lm, **kw):
    """An engine over `lm` at the generate phase's slab (32 x 2048),
    warmed twice: the first warm-up's captures, and none in the second.
    Returns the engine and the first warm-up's report."""
    from mxnet_tpu_torch.serving import warmup
    from mxnet_tpu_torch.serving.generation import GenerationEngine

    eng = GenerationEngine(lm, **{"max_slots": GEN_SLOTS,
                                  "max_len": GEN_MAX_LEN, **kw})
    warm = [warmup(eng), warmup(eng)]
    check(warm[0]["compiles"] == warm[0]["captures"] > 0,
          f"lane warm-up {warm[0]}: every build must be one capture")
    check(warm[1]["compiles"] == warm[1]["captures"] == 0,
          f"lane second warm-up {warm[1]}: want no capture")
    return eng, warm[0]


def burst(eng, prompts):
    """Every prompt submitted at once for `GEN_NEW` tokens; (streams'
    tokens, the streams, wall seconds)."""
    t0 = time.perf_counter()
    streams = [eng.submit(p, max_new_tokens=GEN_NEW) for p in prompts]
    outs = [s.result(timeout=600) for s in streams]
    return outs, streams, time.perf_counter() - t0


def self_draft_file(torch, lm, path):
    """`save_draft` of a draft that is the target itself: the target's
    config with max_len 2048 + 2k, its weights, positional rows 0-2047
    copied (the rest from seed 1, never read at these lengths)."""
    import dataclasses

    from mxnet_tpu_torch.models import TransformerLM
    from mxnet_tpu_torch.serving.generation import save_draft

    cfg = dataclasses.replace(lm.cfg, max_len=GEN_MAX_LEN + 2 * SPEC_K)
    draft = TransformerLM(cfg, device=lm.device, generator=torch.Generator(
        device=lm.device).manual_seed(1))
    params = dict(draft.named_parameters())
    with torch.no_grad():
        for name, p in lm.named_parameters():
            params[name][:p.shape[0]].copy_(p)
    save_draft(path, draft)
    return cfg


def generate_spec(torch, card, state):
    """The speculative lane: the generate phase's burst through `spec_k=4`
    with the n-gram draft (bench.py's), then with a `CheckpointDraft`
    that is the target itself, loaded through ``MXNET_GENERATION_DRAFT``
    (every proposal right but for rounding: the accept-all commit path).
    Checks: both runs' streams equal the plain burst's; no capture after
    warm-up; no kernel launched."""
    from mxnet_tpu_torch.serving.generation import (CheckpointDraft,
                                                    NgramDraft)

    lm, prompts, outs = state["lm"], state["prompts"], state["outs"]
    reset_launches()
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "draft.npz")
        draft_cfg = self_draft_file(torch, lm, path)
        for name in ("ngram", "self_draft"):
            env = {"MXNET_GENERATION_DRAFT": path} if name != "ngram" else {}
            with env_scope(env):
                eng, warm = lane_engine(
                    lm, spec_k=SPEC_K,
                    draft=NgramDraft() if name == "ngram" else None)
            try:
                check(isinstance(eng.draft, CheckpointDraft) == (
                    name != "ngram"), f"spec {name}: draft {eng.draft}")
                full = []
                if name != "ngram":
                    real = eng.draft.on_commit

                    def on_commit(slot, committed, real=real):
                        full.append(len(committed) == SPEC_K + 1)
                        real(slot, committed)

                    eng.draft.on_commit = on_commit
                captures0 = eng.captures
                got, _, wall = burst(eng, prompts)
                bad = [i for i, (a, b) in enumerate(zip(got, outs)) if a != b]
                check(not bad, f"spec {name}: sessions {bad} differ from "
                      "the plain burst")
                check(eng.captures == captures0,
                      f"spec {name}: captured after warm-up")
                with eng._tick_lock:
                    check(eng.live_slots == 0, "spec engine not idle")
                    verify_ms = cuda_ms(eng._verify_fn().graph.replay)
                    step_ms = (cuda_ms(eng.draft._step_fn(SPEC_K)
                                       .graph.replay)
                               if name != "ngram" else None)
                n_tokens = sum(len(o) for o in got)
                runs[name] = {
                    "warm_captures": warm["captures"],
                    "buckets": list(eng.prefill_buckets),
                    "max_len": eng.max_len, "tokens": n_tokens,
                    "wall_s": wall, "tokens_per_s": n_tokens / wall,
                    "spec_to_plain_wall": wall / state["wall_s"],
                    "verified_slot_ticks": eng.spec_verified_slots,
                    "committed": eng.spec_committed,
                    "accepted_tokens_per_slot_tick":
                        eng.spec_committed / eng.spec_verified_slots,
                    "verify_graph_ms": verify_ms,
                    "decode_graph_ms_x5": 5 * state["decode_graph_ms"],
                    "draft_step_ms": step_ms,
                    "streams_equal_plain": True}
                if full:
                    runs[name]["full_commit_share"] = sum(full) / len(full)
            finally:
                eng.close(timeout=60)
    launches = read_launches()
    check(not any(launches.values()),
          f"the spec lane launched kernels: {launches}")
    check(runs["self_draft"]["full_commit_share"] > 0.5,
          f"the self-draft committed k + 1 tokens on "
          f"{runs['self_draft']['full_commit_share']} of its slot-ticks")
    return {"card": card, "spec_k": SPEC_K, "draft_config":
            f"the target's with max_len {draft_cfg.max_len}", **runs,
            "kernel_launches": launches}


def prefix_prompts(vocab):
    """One `PREFIX_SYSTEM`-token system prompt shared by `GEN_BURST`
    sessions, each with a tail of `PREFIX_TAILS` tokens."""
    import numpy as np

    rng = np.random.RandomState(1)
    system = rng.randint(0, vocab, PREFIX_SYSTEM)
    tails = rng.randint(PREFIX_TAILS[0], PREFIX_TAILS[1] + 1, GEN_BURST)
    return [np.concatenate([system, rng.randint(0, vocab, n)])
            for n in tails]


def fork_vs_full(eng, prompt):
    """Fork + suffix prefill against the full prefill, through the
    engine's graphs on free slots, at each of `PREFIX_SPLITS`: the logits
    within `GEN_LOGIT_TOL`, the same argmax."""
    import numpy as np

    a, b, c = eng._free_slots()[:3]
    n = len(prompt)

    def prefill(tokens, slot):
        prog = eng._prefill_fn(eng.bucket_for(len(tokens)))
        padded = np.zeros(eng.bucket_for(len(tokens)), np.int64)
        padded[:len(tokens)] = tokens
        prog(padded, len(tokens), slot)
        return prog.outputs[1].float().cpu()

    full = prefill(prompt, a)
    errs = {}
    for split in PREFIX_SPLITS:
        prefill(prompt[:split], b)
        eng._fork_fn()(b, c)
        bucket = eng.bucket_for(n - split)
        check(split + bucket <= eng._slab_len,
              f"prefix split {split}: bucket {bucket} overhangs the slab")
        padded = np.zeros(bucket, np.int64)
        padded[:n - split] = prompt[split:]
        prog = eng._suffix_prefill_fn(bucket)
        prog(padded, n - split, c, split)
        got = prog.outputs[1].float().cpu()
        errs[split] = float((got - full).abs().max())
        check(int(got.argmax()) == int(full.argmax()),
              f"prefix split {split}: fork + suffix argmax differs")
        check(errs[split] <= GEN_LOGIT_TOL, f"prefix split {split}: fork + "
              f"suffix logits {errs[split]} from the full prefill's")
    return {"splits": list(PREFIX_SPLITS), "max_abs_logit_diff": errs,
            "tol": GEN_LOGIT_TOL, "argmax_equal": True}


def fork_bound(eng):
    """(ms, bytes): one slot row of K and V read and written."""
    row = (eng._ck.nbytes + eng._cv.nbytes) // eng.total_slots
    return 2 * row / PEAK_BYTES_PER_S * 1e3, 2 * row


def generate_prefix(torch, card, state):
    """The prefix lane: 64 sessions sharing one 1024-token system prompt
    (tails of 16-256 tokens, 128 new tokens each) through an engine with
    the prefix cache, submitted one at a time as bench.py does (the first
    token of each read before the next is submitted), then as one burst.
    Checks: fork + suffix against the full prefill (`fork_vs_full`); a
    hit ratio of at least 63/64 in the sequential pass; no capture after
    warm-up; no kernel launched."""
    lm = state["lm"]
    prompts = prefix_prompts(lm.cfg.vocab_size)
    reset_launches()
    eng, warm = lane_engine(lm, prefix_cache=True,
                            prefix_min_tokens=PREFIX_MIN)
    try:
        with eng._tick_lock:
            logits = fork_vs_full(eng, prompts[0])
        captures0 = eng.captures
        ttft = []
        for p in prompts:
            t0 = time.perf_counter()
            stream = eng.submit(p, max_new_tokens=GEN_NEW)
            next(stream)
            ttft.append(time.perf_counter() - t0)
            stream.result(timeout=600)
        hits, misses = eng.prefix_hits, eng.prefix_misses
        check(hits / (hits + misses) >= (GEN_BURST - 1) / GEN_BURST,
              f"prefix sequential pass: {hits} hits, {misses} misses")
        got, streams, wall = burst(eng, prompts)
        check(all(len(o) == GEN_NEW for o in got),
              "a prefix burst session ended early")
        check(eng.captures == captures0, "prefix lane captured after "
              "warm-up")
        with eng._tick_lock:
            check(eng.live_slots == 0, "prefix engine not idle")
            fork_ms = cuda_ms(eng._fork_fn().graph.replay)
            suffix_ms = {b: cuda_ms(eng._suffix_prefill_fn(b).graph.replay)
                         for b in eng.prefill_buckets}
        bound_ms, nbytes = fork_bound(eng)
        burst_hits = sum(s.cached_prefix_len > 0 for s in streams)
        n_tokens = sum(len(o) for o in got)
        out = {"card": card, "system_prompt": PREFIX_SYSTEM,
               "tails": f"uniform {PREFIX_TAILS[0]}-{PREFIX_TAILS[1]}, "
               "RandomState(1)", "sessions": GEN_BURST,
               "max_new_tokens": GEN_NEW, "prefix_min_tokens": PREFIX_MIN,
               "warm_captures": warm["captures"],
               "sequential": {"hits": hits, "misses": misses,
                              "hit_ratio": hits / (hits + misses),
                              "ttft_ms_cold": ttft[0] * 1e3,
                              "ttft_ms_hits_p50": percentile_ms(ttft[1:],
                                                                50),
                              "ttft_ms_hits_p99": percentile_ms(ttft[1:],
                                                                99)},
               "burst": {"tokens": n_tokens, "wall_s": wall,
                         "tokens_per_s": n_tokens / wall,
                         "hits": burst_hits,
                         "ttft_ms_p50": percentile_ms(
                             [s.first_token_at - s.submitted_at
                              for s in streams], 50)},
               "fork_vs_full": logits, "fork_graph_ms": fork_ms,
               "fork_bound_ms": bound_ms, "fork_bytes": nbytes,
               "fork_bound_by": "bytes", "suffix_graph_ms": suffix_ms}
    finally:
        eng.close(timeout=60)
    launches = read_launches()
    check(not any(launches.values()),
          f"the prefix lane launched kernels: {launches}")
    return {**out, "kernel_launches": launches}


def swap_new_tokens(i):
    """Session i's length in the swap lane: 128, 112, 96 or 80 tokens, so
    that the clients' sessions end at different ticks and a swap finds
    sessions of the old weights still live beside new ones."""
    return GEN_NEW - GEN_NEW // 8 * (i % 4)


def generate_swap(torch, card, state):
    """The swap lane: the burst's 64 prompts from 16 closed-loop clients
    (each submits its next prompt when its last stream ends;
    `swap_new_tokens`) through an engine with the prefix cache; at 30 %
    and 65 % of the completions (`SERVE_SWAP_AT`) `swap_weights` flips to
    weights from seed 99 and back to the first weights. Checks: every
    session's stream equals its prompt's under the version it was
    admitted under (the head of the plain burst's stream for the first
    weights, which check (b) holds to sessions run alone; a run alone on
    an engine over the seed-99 model for those); some tick replayed two
    cohorts; the prompts cached before a swap no longer match after it;
    no capture after warm-up; no kernel launched."""
    import threading

    from mxnet_tpu_torch.models import TransformerLM
    from mxnet_tpu_torch.serving.generation import GenerationEngine

    lm, prompts, outs = state["lm"], state["prompts"], state["outs"]
    other = TransformerLM(lm.cfg, device=lm.device,
                          generator=torch.Generator(
                              device=lm.device).manual_seed(99))
    weights = {"seed 99": dict(other.named_parameters()),
               "seed 0": {k: v.detach().clone()
                          for k, v in lm.named_parameters()}}
    reset_launches()
    eng, warm = lane_engine(lm, prefix_cache=True,
                            prefix_min_tokens=PREFIX_MIN)
    lock = eng._tick_lock = HeldTimer(eng._tick_lock)
    cohorts, mixed = eng._cohorts, []

    def counted():
        out = cohorts()
        mixed.append(len(out) > 1)
        return out

    eng._cohorts = counted
    captures0 = eng.captures
    streams = [None] * len(prompts)
    errors = []

    def client(k):
        try:
            for i in range(k, len(prompts), SWAP_CLIENTS):
                streams[i] = eng.submit(prompts[i],
                                        max_new_tokens=swap_new_tokens(i))
                streams[i].result(timeout=600)
        except Exception as e:  # noqa: BLE001 - raised below
            errors.append(e)

    swaps = []
    try:
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(SWAP_CLIENTS)]
        for th in threads:
            th.start()
        for share, name in zip(SERVE_SWAP_AT, weights):
            while sum(s is not None and s.done for s in streams) < \
                    share * len(prompts) and not errors:
                time.sleep(0.001)
            cached = [i for i, s in enumerate(streams)
                      if s is not None and s.done
                      and eng.prefix_match_len(prompts[i])]
            t0 = time.perf_counter()
            version = eng.swap_weights(weights[name])
            call_s = time.perf_counter() - t0
            stale = [i for i in cached if eng.prefix_match_len(prompts[i])]
            check(not stale, f"swap to {name}: prompts {stale} still match "
                  "entries of the old weights")
            swaps.append({"to": name, "version": version,
                          "at_completed": sum(s is not None and s.done
                                              for s in streams),
                          "ms_under_tick_lock":
                              lock.held_s[threading.get_ident()] * 1e3,
                          "call_ms": call_s * 1e3,
                          "old_entries_evicted": len(cached)})
        for th in threads:
            th.join(timeout=600)
        if errors:
            raise errors[0]
        check(eng.captures == captures0, "swap lane captured after warm-up")
        versions = [s.weights_version for s in streams]
    finally:
        eng.close(timeout=60)
    check(any(mixed), "no tick replayed two weight cohorts")
    check(set(versions) == {0, 1, 2}, f"sessions' versions {versions}")
    on_99 = [i for i, v in enumerate(versions) if v == 1]
    with GenerationEngine(other, max_slots=GEN_SLOTS,
                          max_len=GEN_MAX_LEN) as alone:
        want = {i: alone.generate(prompts[i],
                                  max_new_tokens=swap_new_tokens(i))
                for i in on_99}
    bad = [i for i, s in enumerate(streams) if s.result() != want.get(
        i, outs[i][:swap_new_tokens(i)])]
    check(not bad, f"swap: sessions {bad} differ from their version's "
          "stream")
    launches = read_launches()
    check(not any(launches.values()),
          f"the swap lane launched kernels: {launches}")
    return {"card": card, "clients": SWAP_CLIENTS, "sessions": len(prompts),
            "swaps": swaps, "warm_captures": warm["captures"],
            "sessions_by_version": {v: versions.count(v) for v in (0, 1, 2)},
            "mixed_ticks": sum(mixed), "ticks": len(mixed),
            "streams_equal_their_version": True,
            "kernel_launches": launches}


def generate_router(torch, card, state):
    """The router lane: two 16-slot engines over the one model, both with
    prefix caches, behind a `GenerationRouter`. Two 1024-token system
    prompts: one session of each first (their caches fill), then 24 of
    them interleaved, then 16 prompts no cache holds, all at once. Checks:
    the two first sessions go to different engines; every later session
    of a system prompt forks it (lands on the engine that caches it); the
    unrelated ones split evenly; no capture after warm-up; no kernel
    launched."""
    import numpy as np

    from mxnet_tpu_torch.serving import warmup
    from mxnet_tpu_torch.serving.generation import (GenerationEngine,
                                                    GenerationRouter)

    lm = state["lm"]
    vocab = lm.cfg.vocab_size
    rng = np.random.RandomState(2)
    systems = [rng.randint(0, vocab, PREFIX_SYSTEM) for _ in range(2)]

    def prompt(k):
        tail = rng.randint(PREFIX_TAILS[0], PREFIX_TAILS[1] + 1)
        return np.concatenate([systems[k], rng.randint(0, vocab, tail)])

    reset_launches()
    engines = [GenerationEngine(lm, max_slots=ROUTER_SLOTS,
                                max_len=GEN_MAX_LEN, prefix_cache=True,
                                prefix_min_tokens=PREFIX_MIN)
               for _ in range(2)]
    with GenerationRouter(engines) as router:
        warm = warmup(router)
        captures0 = sum(e.captures for e in engines)
        firsts = [router.submit(prompt(k), max_new_tokens=GEN_NEW)
                  for k in (0, 1)]
        for s in firsts:
            next(s)
        check([e.sessions_submitted for e in engines] == [1, 1],
              "the two first sessions went to one engine")
        before = [e.sessions_submitted for e in engines]
        t0 = time.perf_counter()
        later = [(k % 2, router.submit(prompt(k % 2),
                                       max_new_tokens=GEN_NEW))
                 for k in range(ROUTER_SESSIONS)]
        got = [s.result(timeout=600) for _, s in later]
        wall = time.perf_counter() - t0
        missed = [i for i, (_, s) in enumerate(later)
                  if s.cached_prefix_len < PREFIX_SYSTEM]
        check(not missed, f"router: sessions {missed} did not land on the "
              "engine caching their system prompt")
        placed = [b - a for a, b in zip(
            before, [e.sessions_submitted for e in engines])]
        check(placed == [ROUTER_SESSIONS // 2] * 2,
              f"router affinity split {placed}")
        before = [e.sessions_submitted for e in engines]
        spread = [router.submit(rng.randint(0, vocab, PREFIX_TAILS[1]),
                                max_new_tokens=GEN_NEW)
                  for _ in range(ROUTER_SPREAD)]
        for s in spread + firsts:
            s.result(timeout=600)
        split = [b - a for a, b in zip(
            before, [e.sessions_submitted for e in engines])]
        check(max(split) - min(split) <= 2, f"router load split {split}")
        check(sum(e.captures for e in engines) == captures0,
              "router lane captured after warm-up")
        stats = router.stats()
    launches = read_launches()
    check(not any(launches.values()),
          f"the router lane launched kernels: {launches}")
    n_tokens = sum(len(o) for o in got)
    return {"card": card, "engines": 2, "slots": ROUTER_SLOTS,
            "warm_captures": warm["captures"],
            "affinity_sessions": ROUTER_SESSIONS,
            "affinity_split": placed, "affinity_tokens_per_s":
                n_tokens / wall, "load_split": split,
            "prefix_hits": [e["prefix_hits"] for e in stats["engines"]],
            "kernel_launches": launches}


# slice 12's QoS lane (`bench.py:1511-1627`'s three phases at full width)
QOS_SPEC = "latency:interactive;bulk:batch"
QOS_PARK = 8                             # MXNET_QOS_PARK_SLOTS: 40 rows
QOS_FLOOD, QOS_FLOOD_NEW = 2 * GEN_SLOTS, 256
QOS_FLOOD_LENS = (64, 512)               # uniform, RandomState(0)
QOS_TRICKLE, QOS_TRICKLE_NEW = 8, 16
QOS_TRICKLE_LENS = (16, 64)              # uniform, RandomState(1)
QOS_FIFO_RERUN = 4                       # flood sessions rerun alone, (a)
# the fleet lane: two 16-slot engines over the one model, 4 park rows each
FLEET_SLOTS, FLEET_PARK, FLEET_CLIENTS = 16, 4, 16
FLEET_FLOOD_NEW, FLEET_LATENCY_NEW = 128, 16


def qos_prompts(vocab, n, lens, seed):
    """``n`` prompts of uniform lengths in ``lens`` from RandomState(seed)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    sizes = rng.randint(lens[0], lens[1] + 1, n)
    return [rng.randint(0, vocab, k) for k in sizes]


def trickle(eng, prompts, tenant=None):
    """The interactive trickle, one session after another: (TTFT seconds
    of each, their streams' tokens)."""
    ttfts, outs = [], []
    for p in prompts:
        t0 = time.perf_counter()
        stream = eng.submit(p, max_new_tokens=QOS_TRICKLE_NEW, tenant=tenant)
        next(stream)
        ttfts.append(time.perf_counter() - t0)
        outs.append(stream.result(timeout=600))
    return ttfts, outs


def wait_full(eng, timeout=120):
    """Wait until every session slot of `eng` is live (the flood has
    filled the slab, so an interactive arrival finds no free slot)."""
    t_end = time.perf_counter() + timeout
    while eng.live_slots < eng.max_slots:
        check(time.perf_counter() < t_end, "the flood never filled the slab")
        time.sleep(0.0005)


def ttft_fields(ttfts):
    """The trickle's TTFT: median and maximum (over 8 sessions a p99 is
    the slowest session's)."""
    return {"ttft_ms_p50": percentile_ms(ttfts, 50),
            "ttft_ms_max": max(ttfts) * 1e3, "sessions": len(ttfts)}


def spy_preemptions(eng):
    """Record the stream of every session `eng` parks and resumes (its
    `_preempt_for_priority` and `_resume_into` wrapped); returns the two
    lists they fill."""
    victims, resumed = [], []
    preempt, resume = eng._preempt_for_priority, eng._resume_into

    def spy_preempt():
        slot = preempt()
        if slot is not None:
            rec = max(eng._parked.values(), key=lambda r: r["parked_at"])
            victims.append(rec["sess"].stream)
        return slot

    def spy_resume(slot):
        resume(slot)
        resumed.append(eng._sessions[slot].stream)

    eng._preempt_for_priority = spy_preempt
    eng._resume_into = spy_resume
    return victims, resumed


def seed0_params(torch, state):
    """Host copies of the generate phase's weights (the default model from
    seed 0), made once: engines built on them serve those values whatever
    set an earlier engine left in the shared model's parameters."""
    from mxnet_tpu_torch.models import TransformerLM

    if "seed0" not in state:
        lm = state["lm"]
        fresh = TransformerLM(lm.cfg, device=lm.device,
                              generator=torch.Generator(
                                  device=lm.device).manual_seed(0))
        state["seed0"] = {k: v.detach().float().cpu().numpy()
                          for k, v in fresh.named_parameters()}
    return state["seed0"]


@contextlib.contextmanager
def qos_registry(spec, park):
    """A QoS registry installed (as ``MXNET_QOS_SPEC`` would) with
    ``park`` park rows a engine for the block; off again after, so later
    phases build QoS-free servers."""
    from mxnet_tpu_torch.serving import qos

    with env_scope({"MXNET_QOS_PARK_SLOTS": str(park)}):
        reg = qos.install(qos.TenantRegistry(qos.parse_spec(spec)))
        try:
            yield reg
        finally:
            qos.clear()


def generate_qos(torch, card, state):
    """The QoS lane (`bench.py:1511-1627` at full width): the generate
    phase's model and a 32 x 2048 engine, three phases. Unloaded: the
    8-session `latency` trickle alone (QoS off). FIFO flood (QoS off): 64
    `bulk` sessions (prompts of 64-512 tokens, 256 new each) submitted at
    once, then, once they fill the slab, the trickle. QoS flood: the same
    under the registry ``latency:interactive;bulk:batch`` with 8 park
    rows (a 40-row slab).
    Checks: (a) QoS off, the keys carry no park row and the flood's
    streams (`tenant=` passed and ignored) equal the same prompts rerun
    alone; (b) at least one preemption, no capture after warm-up; (c)
    every preempted `bulk` stream equals its prompt rerun alone on the
    same 40-row engine, and every `latency` stream its own run alone
    there; (d) a tenant at ``rps=1`` gets `QuotaExceededError` on its
    second submit inside a second. No kernel launched."""
    from mxnet_tpu_torch.serving import QuotaExceededError, qos
    from mxnet_tpu_torch.serving.generation import GenerationEngine

    lm = state["lm"]
    params = seed0_params(torch, state)
    vocab = lm.cfg.vocab_size
    flood = qos_prompts(vocab, QOS_FLOOD, QOS_FLOOD_LENS, 0)
    lat = qos_prompts(vocab, QOS_TRICKLE, QOS_TRICKLE_LENS, 1)
    reset_launches()
    qos.install(None)
    try:
        eng, warm_off = lane_engine(lm, params=params)
    finally:
        qos.clear()
    try:
        keys = sorted(eng.cache.keys(), key=repr)
        check(eng.total_slots == GEN_SLOTS and ("decode", GEN_SLOTS,
              GEN_MAX_LEN) in keys and not any(
                  k[-2] != GEN_SLOTS for k in keys),
              f"QoS off: keys {keys} carry park rows")
        base_ttft, base_outs = trickle(eng, lat)
        streams = [eng.submit(p, max_new_tokens=QOS_FLOOD_NEW,
                              tenant="bulk") for p in flood]
        wait_full(eng)
        fifo_ttft, _ = trickle(eng, lat)
        fifo_outs = [s.result(timeout=600) for s in streams]
        rerun = list(range(0, QOS_FLOOD, QOS_FLOOD // QOS_FIFO_RERUN))
        for i in rerun:                                           # (a)
            alone = eng.generate(flood[i], max_new_tokens=QOS_FLOOD_NEW)
            check(alone == fifo_outs[i], f"QoS off: flood session {i} "
                  "differs from its prompt run alone")
    finally:
        eng.close(timeout=60)
    del eng

    with qos_registry(QOS_SPEC, QOS_PARK):
        eng, warm = lane_engine(lm, params=params)
        try:
            check(eng.total_slots == GEN_SLOTS + QOS_PARK
                  and ("fork", GEN_SLOTS + QOS_PARK, GEN_MAX_LEN)
                  in eng.cache.keys(), "QoS on: no 40-row fork graph")
            captures0 = eng.captures
            victims, resumed = spy_preemptions(eng)
            streams = [eng.submit(p, max_new_tokens=QOS_FLOOD_NEW,
                                  tenant="bulk") for p in flood]
            wait_full(eng)
            qos_ttft, qos_outs = trickle(eng, lat, tenant="latency")
            flood_outs = [s.result(timeout=600) for s in streams]
            check(eng.parked_count == 0, "QoS on: sessions left parked")
            check(victims, "QoS on: the trickle preempted nothing")  # (b)
            check(eng.captures == captures0,
                  "QoS on: captured after warm-up")
            # (c) on the same 40-row slab, each alone
            preempted = [streams.index(v) for v in victims]
            for i in sorted(set(preempted)):
                alone = eng.generate(flood[i], max_new_tokens=QOS_FLOOD_NEW)
                check(alone == flood_outs[i], f"QoS on: preempted session "
                      f"{i} differs from its run alone")
            for i, p in enumerate(lat):
                alone = eng.generate(p, max_new_tokens=QOS_TRICKLE_NEW)
                check(alone == qos_outs[i], f"QoS on: latency session {i} "
                      "differs from its run alone")
            check(eng.captures == captures0,
                  "QoS on: the reruns captured")
            with eng._exclusive():
                fork_ms = cuda_ms(eng._fork_fn().graph.replay)
            kv_bytes = eng.kv_slab_bytes()
            fork_bound_ms, fork_bytes = fork_bound(eng)
        finally:
            eng.close(timeout=60)
        del eng
    with qos_registry("capped:interactive:rps=1", 1):               # (d)
        small = GenerationEngine(lm, max_slots=1, max_len=64,
                                 buckets=(16,), start=False)
        try:
            small.submit(lat[0][:8], max_new_tokens=2, tenant="capped")
            try:
                small.submit(lat[0][:8], max_new_tokens=2, tenant="capped")
                check(False, "quota: a second submit inside a second "
                      "was admitted at rps=1")
            except QuotaExceededError:
                pass
        finally:
            small.close(timeout=10)
    launches = read_launches()
    check(not any(launches.values()),
          f"the QoS lane launched kernels: {launches}")
    base, fifo, loaded = (ttft_fields(t) for t in
                          (base_ttft, fifo_ttft, qos_ttft))
    return {"card": card, "spec": QOS_SPEC, "park_slots": QOS_PARK,
            "slots": GEN_SLOTS, "flood": {
                "sessions": QOS_FLOOD, "prompt_lens": "uniform "
                f"{QOS_FLOOD_LENS[0]}-{QOS_FLOOD_LENS[1]}, RandomState(0)",
                "max_new_tokens": QOS_FLOOD_NEW},
            "trickle": {"sessions": QOS_TRICKLE, "prompt_lens": "uniform "
                        f"{QOS_TRICKLE_LENS[0]}-{QOS_TRICKLE_LENS[1]}, "
                        "RandomState(1)",
                        "max_new_tokens": QOS_TRICKLE_NEW},
            "unloaded": base, "fifo_flood": fifo, "qos_flood": loaded,
            "ttft_degradation": loaded["ttft_ms_max"] / base["ttft_ms_max"],
            "fifo_ttft_degradation":
                fifo["ttft_ms_max"] / base["ttft_ms_max"],
            "preemptions": len(victims), "resumes": len(resumed),
            "preempted_sessions": sorted(set(preempted)),
            "fork_graph_ms": fork_ms, "fork_bound_ms": fork_bound_ms,
            "fork_bytes": fork_bytes, "kv_slab_bytes": kv_bytes,
            "warm_captures": {"qos_off": warm_off["captures"],
                              "qos_on": warm["captures"]},
            "captures_after_warmup": 0,
            "checks": ["a", "b", "c", "d"],
            "fifo_rerun_bit_equal": rerun,
            "unloaded_streams_equal_qos": base_outs == qos_outs,
            "kernel_launches": launches}


def generate_fleet(torch, card, state):
    """The fleet lane: two 16-slot engines over the generate phase's model
    behind a `GenerationRouter`, QoS on (``latency:interactive;
    bulk:batch``, 4 park rows each). A `latency` session placed by class
    (away from the engine running batch work); a `bulk` flood forced onto
    engine 0 and `latency` arrivals there until its park rows fill, then
    `rebalance_parked`: every migrated stream must equal a fresh submit of
    its whole context on the receiving engine. Then `rolling_swap` to
    seed-99 weights while 16 closed-loop clients generate: both replicas
    flip, no capture, each session's stream equals its prompt's on its
    version (a burst on engines of the same 20-row slab); a second roll
    with an SLO objective breached and gate 0 rolls back, every replica
    on the previous version. No kernel launched."""
    import threading

    from mxnet_tpu_torch import health, telemetry
    from mxnet_tpu_torch.models import TransformerLM
    from mxnet_tpu_torch.serving import warmup
    from mxnet_tpu_torch.serving.generation import (GenerationEngine,
                                                    GenerationRouter)

    import numpy as np

    lm, prompts = state["lm"], state["prompts"]
    params = seed0_params(torch, state)
    vocab = lm.cfg.vocab_size
    other = TransformerLM(lm.cfg, device=lm.device, generator=torch.Generator(
        device=lm.device).manual_seed(99))
    host = {k: v.detach().float().cpu().numpy()
            for k, v in other.named_parameters()}
    flood = qos_prompts(vocab, FLEET_SLOTS + 2 * FLEET_PARK,
                        QOS_FLOOD_LENS, 3)
    lat = qos_prompts(vocab, 2 * FLEET_PARK, QOS_TRICKLE_LENS, 4)
    reset_launches()
    with qos_registry(QOS_SPEC, FLEET_PARK):
        engines = [GenerationEngine(lm, params, max_slots=FLEET_SLOTS,
                                    max_len=GEN_MAX_LEN) for _ in range(2)]
        locks = []
        for e in engines:
            e._tick_lock = HeldTimer(e._tick_lock)
            locks.append(e._tick_lock)
        router = GenerationRouter(engines)
        try:
            warm = warmup(router)
            captures0 = sum(e.captures for e in engines)
            # class placement: batch work on engine 0, the latency
            # session must go to engine 1
            first = engines[0].submit(flood[0], max_new_tokens=32,
                                      tenant="bulk")
            next(first)
            placed = router.submit(lat[0], max_new_tokens=QOS_TRICKLE_NEW,
                                   tenant="latency")
            check(placed._engine is engines[1], "fleet: the latency "
                  "session went to the engine running batch work")
            placed.result(timeout=600)
            first.result(timeout=600)
            # force a flood onto engine 0 and fill its park rows
            e0, e1 = engines
            bulk = [e0.submit(p, max_new_tokens=FLEET_FLOOD_NEW,
                              tenant="bulk") for p in flood[:FLEET_SLOTS]]
            for s in bulk:
                next(s)
            # the arrivals preempt one bulk session a tick; the parked stay
            # parked until a bulk session ends, ~FLEET_FLOOD_NEW ticks on
            arrivals = [e0.submit(p, max_new_tokens=FLEET_FLOOD_NEW,
                                  tenant="latency")
                        for p in lat[:FLEET_PARK]]
            t_end = time.perf_counter() + 60
            while e0.parked_count < FLEET_PARK and \
                    time.perf_counter() < t_end:
                time.sleep(0.0005)
            with e0._exclusive():
                parked = {id(r["sess"].stream): (
                    r["sess"].prompt, list(r["sess"].stream.tokens),
                    r["sess"].max_new_tokens)
                    for r in e0._parked.values()}
            check(len(parked) == FLEET_PARK, f"fleet: {len(parked)} "
                  f"sessions parked on engine 0, want {FLEET_PARK}")
            moved = router.rebalance_parked()
            check(moved == FLEET_PARK, f"fleet: {moved} migrated, want "
                  f"{FLEET_PARK}")
            migrated = [s for s in bulk if id(s) in parked]
            check(all(s._engine is e1 for s in migrated),
                  "fleet: a migrated stream is not on engine 1")
            for s in bulk + arrivals:
                s.result(timeout=600)
            for s in migrated:                                  # fresh
                prompt, before, budget = parked[id(s)]
                ctx = np.concatenate([prompt, np.asarray(before,
                                                         np.int32)])
                fresh = e1.generate(ctx, max_new_tokens=budget - len(before))
                check(s.result() == before + fresh, "fleet: a migrated "
                      "stream differs from a fresh submit of its context")
            check(sum(e.captures for e in engines) == captures0,
                  "fleet: migration captured")
            # the roll under 16 closed-loop clients
            streams = [None] * len(prompts)
            errors = []

            def client(k):
                try:
                    for i in range(k, len(prompts), FLEET_CLIENTS):
                        streams[i] = router.submit(prompts[i],
                                                   max_new_tokens=GEN_NEW)
                        streams[i].result(timeout=600)
                except Exception as e:  # noqa: BLE001 - raised below
                    errors.append(e)

            threads = [threading.Thread(target=client, args=(k,))
                       for k in range(FLEET_CLIENTS)]
            for th in threads:
                th.start()
            while sum(s is not None and s.done for s in streams) < \
                    len(prompts) // 3 and not errors:
                time.sleep(0.001)
            t0 = time.perf_counter()
            roll = router.rolling_swap(host, version=1, observe_s=0)
            roll_ms = (time.perf_counter() - t0) * 1e3
            held_ms = [lk.held_s.get(threading.get_ident(), 0.0) * 1e3
                       for lk in locks]
            for th in threads:
                th.join(timeout=600)
            if errors:
                raise errors[0]
            check(roll["swapped"] == 2 and [e.weights_version for e in
                                            engines] == [1, 1],
                  f"fleet: the roll {roll}")
            check(sum(e.captures for e in engines) == captures0,
                  "fleet: the roll captured")
            versions = [s.weights_version for s in streams]
            # the gated roll: an objective breached, gate 0
            with env_scope({"MXNET_SLO_SPEC": "fleet_probe.errors:value<=0",
                            "MXNET_SLO_GRACE_S": "0"}):
                health.reset()
                health.enable()
                try:
                    telemetry.gauge("fleet_probe.errors").set(1)
                    gated = router.rolling_swap(params, version=2,
                                                observe_s=0, gate=0.0)
                finally:
                    telemetry.gauge("fleet_probe.errors").set(0)
                    health.disable()
                    health.reset()
            check(gated["rolled_back"] and [e.weights_version for e in
                                            engines] == [1, 1],
                  f"fleet: the gated roll {gated} did not roll back")
            check(sum(e.captures for e in engines) == captures0,
                  "fleet: the rollback captured")
        finally:
            router.close(timeout=60)
        del router, engines
        # each version's streams, as bursts on engines of the same slab
        want = {}
        for version, model, weights in ((0, lm, params), (1, other, None)):
            idx = [i for i, v in enumerate(versions) if v == version]
            with GenerationEngine(model, weights, max_slots=FLEET_SLOTS,
                                  max_len=GEN_MAX_LEN) as ref:
                outs, _, _ = burst(ref, [prompts[i] for i in idx])
            want.update(zip(idx, outs))
    bad = [i for i, s in enumerate(streams) if s.result() != want[i]]
    check(not bad, f"fleet: sessions {bad} differ from their version's "
          "stream")
    launches = read_launches()
    check(not any(launches.values()),
          f"the fleet lane launched kernels: {launches}")
    return {"card": card, "engines": 2, "slots": FLEET_SLOTS,
            "park_slots": FLEET_PARK, "warm_captures": warm["captures"],
            "class_placement": "latency to engine 1 beside batch on 0",
            "migrated": moved, "migrated_equal_fresh_context": True,
            "roll": roll, "roll_ms": roll_ms,
            "roll_ms_under_tick_lock": held_ms,
            "sessions_by_version": {v: versions.count(v) for v in (0, 1)},
            "streams_equal_their_version": True,
            "gated_roll": gated, "captures_after_warmup": 0,
            "kernel_launches": launches}


def generate_lanes(torch, card, state):
    """Slice 10's and slice 12's lanes after the generate phase, each on
    its own engines, closed before the next lane."""
    out = {}
    for name, lane in (("generate_spec", generate_spec),
                       ("generate_prefix", generate_prefix),
                       ("generate_swap", generate_swap),
                       ("generate_router", generate_router),
                       ("generate_qos", generate_qos),
                       ("generate_fleet", generate_fleet)):
        out[name] = lane(torch, card, state)
        progress(name)
    return out


# --- the nd phase (slice 6): mx.nd, autograd and the op registry ----------

# ResNet-50 v1 (`mxnet_tpu/gluon/model_zoo/vision/resnet.py`): bottleneck
# units per stage, and the stem's then each stage's output channels
RESNET50_UNITS = (3, 4, 6, 3)
RESNET50_WIDTHS = (64, 256, 512, 1024, 2048)
ND_BATCH, ND_SIZE, ND_CLASSES = 32, 224, 1000  # bench.py raw_shapes(on_tpu)
ND_WARMUP, ND_STEPS = 2, 5
ND_LR, ND_MOMENTUM, ND_WD = 0.1, 0.9, 1e-4  # bench.py build_raw_step
# the small fp32 version of checks (b) and of the CPU test: two stages of
# one unit each, batch 4 at 32 x 32, 10 classes
ND_SMALL = {"units": (1, 1), "widths": (8, 16, 32), "classes": 10,
            "batch": 4, "size": 32}
# fp32 on the card (TF32 off) against the CPU: the same function, sums in
# another order, two SGD steps through 13 BatchNorms
ND_SMALL_TOL = {"rtol": 1e-4, "atol": 1e-5}
# check (c): one op on the card against the CPU, fp32 (and 1e-3 for fp16
# results, whose ulp is 2^-10)
OP_TOL = {"float32": (1e-4, 1e-5), "float16": (1e-3, 1e-3)}


def resnet50_v1_units(units, widths):
    """(name prefix, input channels, output channels, stride, downsample)
    of each bottleneck unit, in order: stride 2 on the first unit of every
    stage but the first, and a downsampling shortcut where the channels
    change."""
    out = []
    for i, n in enumerate(units):
        for j in range(n):
            cin = widths[i] if j == 0 else widths[i + 1]
            stride = 2 if i > 0 and j == 0 else 1
            out.append((f"stage{i + 1}_unit{j + 1}_", cin, widths[i + 1],
                        stride, cin != widths[i + 1]))
    return out


def resnet50_v1_shapes(units=RESNET50_UNITS, widths=RESNET50_WIDTHS,
                       classes=ND_CLASSES, in_channels=3):
    """{name: shape} of the parameters, and of the BatchNorm moving stats,
    of `resnet50_v1_nd`."""
    params, aux = {}, {}

    def conv(name, cout, cin, k, bias=False):
        params[name + "_weight"] = (cout, cin, k, k)
        if bias:
            params[name + "_bias"] = (cout,)

    def bn(name, c):
        params[name + "_gamma"] = params[name + "_beta"] = (c,)
        aux[name + "_running_mean"] = aux[name + "_running_var"] = (c,)

    conv("conv0", widths[0], in_channels, 7)
    bn("bn0", widths[0])
    for prefix, cin, cout, _, down in resnet50_v1_units(units, widths):
        mid = cout // 4
        conv(prefix + "conv1", mid, cin, 1, bias=True)
        bn(prefix + "bn1", mid)
        conv(prefix + "conv2", mid, mid, 3)
        bn(prefix + "bn2", mid)
        conv(prefix + "conv3", cout, mid, 1, bias=True)
        bn(prefix + "bn3", cout)
        if down:
            conv(prefix + "down", cout, cin, 1)
            bn(prefix + "downbn", cout)
    params["fc_weight"] = (classes, widths[-1])
    params["fc_bias"] = (classes,)
    return params, aux


def resnet50_v1_init(seed, **arch):
    """numpy parameters and moving stats: weights Xavier uniform at
    magnitude 3 over the average of fan-in and fan-out (`mx.init.Xavier`'s
    defaults), biases and betas 0, gammas 1, moving means 0 and moving
    variances 1."""
    import numpy as np

    rng = np.random.RandomState(seed)
    shapes, aux_shapes = resnet50_v1_shapes(**arch)
    params = {}
    for name, shape in shapes.items():
        if name.endswith("_weight"):
            hw = int(np.prod(shape[2:]))
            scale = math.sqrt(3.0 / ((shape[0] + shape[1]) * hw / 2.0))
            params[name] = rng.uniform(-scale, scale, shape).astype(
                np.float32)
        else:
            fill = 1.0 if name.endswith("_gamma") else 0.0
            params[name] = np.full(shape, fill, np.float32)
    aux = {name: np.full(shape, 1.0 if name.endswith("_var") else 0.0,
                         np.float32) for name, shape in aux_shapes.items()}
    return params, aux


def resnet50_v1_nd(mx, params, aux, x, label, units=RESNET50_UNITS,
                   widths=RESNET50_WIDTHS, flop=None):
    """The loss of ResNet-50 v1 on (x, label), written only against the
    package `mx` it is given (`mxnet_tpu` or `mxnet_tpu_torch`): `mx.nd`
    ops on NDArrays. The stem is a 7x7/2 convolution, BatchNorm, ReLU and
    a 3x3/2 max pool; each bottleneck unit (`BottleneckV1`) is 1x1 (with
    the stride) → 3x3 → 1x1, each followed by BatchNorm, with a 1x1
    convolution and BatchNorm as the downsampling shortcut and ReLU after
    the sum; the head is a global average pool and a FullyConnected. The
    loss is -mean(pick(log_softmax(out), label)) (`bench.py:510-513`).
    BatchNorms are gluon's (eps 1e-5, momentum 0.9, gamma trained); in
    training they move the stats in ``aux``. `flop`, a list, receives the
    multiply-adds x 2 of every convolution and of the FullyConnected."""
    nd = mx.nd

    def conv(y, name, stride=1, pad=0):
        w = params[name + "_weight"]
        k = w.shape[2]
        bias = params.get(name + "_bias")
        args = (y, w) if bias is None else (y, w, bias)
        out = nd.Convolution(*args, kernel=(k, k), stride=(stride, stride),
                             pad=(pad, pad), num_filter=w.shape[0],
                             no_bias=bias is None)
        if flop is not None:
            flop.append(2 * out.size * w.shape[1] * k * k)
        return out

    def bn(y, name):
        return nd.BatchNorm(y, params[name + "_gamma"],
                            params[name + "_beta"],
                            aux[name + "_running_mean"],
                            aux[name + "_running_var"], eps=1e-5,
                            momentum=0.9, fix_gamma=False)

    def relu(y):
        return nd.Activation(y, act_type="relu")

    y = relu(bn(conv(x, "conv0", 2, 3), "bn0"))
    y = nd.Pooling(y, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                   pool_type="max")
    for prefix, _, _, stride, down in resnet50_v1_units(units, widths):
        h = relu(bn(conv(y, prefix + "conv1", stride), prefix + "bn1"))
        h = relu(bn(conv(h, prefix + "conv2", 1, 1), prefix + "bn2"))
        h = bn(conv(h, prefix + "conv3"), prefix + "bn3")
        if down:
            y = bn(conv(y, prefix + "down", stride), prefix + "downbn")
        y = relu(h + y)
    y = nd.Pooling(y, kernel=(1, 1), global_pool=True, pool_type="avg")
    w = params["fc_weight"]
    out = nd.FullyConnected(y, w, params["fc_bias"], num_hidden=w.shape[0])
    if flop is not None:
        flop.append(2 * out.size * w.shape[1])
    return -nd.mean(nd.pick(nd.log_softmax(out), label))


def resnet50_v1_nd_step(mx, params, moms, aux, x, label, **arch):
    """One training step: the loss recorded, its backward, and
    `nd.sgd_mom_update` (lr 0.1, momentum 0.9, wd 1e-4) written over every
    parameter. Returns the loss."""
    with mx.autograd.record():
        loss = resnet50_v1_nd(mx, params, aux, x, label, **arch)
    loss.backward()
    for name, w in params.items():
        mx.nd.sgd_mom_update(w, w.grad, moms[name], lr=ND_LR,
                             momentum=ND_MOMENTUM, wd=ND_WD, out=w)
    return loss


def resnet50_v1_batch(seed, batch, size, classes):
    """numpy images uniform in [-1, 1) and labels (as float32 indices)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (batch, 3, size, size)).astype(np.float32)
    label = rng.randint(0, classes, (batch,)).astype(np.float32)
    return x, label


def resnet50_v1_arrays(mx, ctx, params, aux, x, label, dtype="float32"):
    """NDArrays on ctx: parameters (marked for backward) and momenta in
    `dtype`, moving stats in fp32, the images in `dtype`."""
    ps = {k: mx.nd.array(v, ctx=ctx).astype(dtype) for k, v in params.items()}
    for p in ps.values():
        p.attach_grad()
    moms = {k: mx.nd.zeros(v.shape, ctx=ctx, dtype=dtype)
            for k, v in params.items()}
    auxs = {k: mx.nd.array(v, ctx=ctx) for k, v in aux.items()}
    return (ps, moms, auxs, mx.nd.array(x, ctx=ctx).astype(dtype),
            mx.nd.array(label, ctx=ctx))


# -- check (c)'s case table: every op of the port's registry ---------------
# An input is ("u", shape, lo, hi, dtype): uniform; ("i", shape, lo, hi,
# dtype): integers, as MXNet passes indices; or ("c", value, dtype): a
# constant. `grad` is True (every "u" input), False, or the inputs' indices.

def _u(*shape, lo=-1.0, hi=1.0, dtype="float32"):
    return ("u", shape, lo, hi, dtype)


def _i(*shape, lo=0, hi=3, dtype="float32"):
    return ("i", shape, lo, hi, dtype)


def _c(value, dtype="float32"):
    return ("c", value, dtype)


_POS = {"lo": 0.5, "hi": 2.0}
_UNIT = {"lo": -0.9, "hi": 0.9}
_UNARY_CASES = {
    "abs": {}, "sign": {}, "rint": {}, "ceil": {}, "floor": {}, "trunc": {},
    "fix": {}, "round": {}, "exp": {}, "expm1": {}, "log": _POS,
    "log10": _POS, "log2": _POS, "log1p": {"lo": -0.5, "hi": 1.0},
    "sqrt": _POS, "cbrt": _POS, "square": {}, "reciprocal": _POS,
    "rsqrt": _POS, "rcbrt": _POS, "sin": {}, "cos": {}, "tan": {},
    "arcsin": _UNIT, "arccos": _UNIT, "arctan": {}, "sinh": {}, "cosh": {},
    "tanh": {}, "arcsinh": {}, "arccosh": {"lo": 1.1, "hi": 3.0},
    "arctanh": _UNIT, "degrees": {}, "radians": {}, "sigmoid": {},
    "softsign": {}, "relu": {}, "gamma": {"lo": 0.5, "hi": 3.0},
    "gammaln": {"lo": 0.5, "hi": 3.0}, "erf": {}, "erfinv": _UNIT,
    "negative _np_negative": {}, "identity _copy stop_gradient_identity": {},
    "make_loss": {}, "_copyto": {},
}
_BINARY_CASES = {
    "elemwise_add _plus _add _Plus _grad_add": {}, "_maximum": {},
    "elemwise_sub _sub _minus": {}, "elemwise_mul _mul": {},
    "_minimum": {}, "_hypot": {},
}
_SCALAR_CASES = {
    "_plus_scalar": 0.7, "_minus_scalar": 0.7, "_rminus_scalar": 0.7,
    "_mul_scalar": -1.3, "_div_scalar": 1.7, "_maximum_scalar": 0.1,
    "_minimum_scalar": 0.1, "_hypot_scalar": 0.6,
    "_scatter_plus_scalar": 0.4, "_scatter_minus_scalar": 0.4,
}
_CMP = ("_equal _not_equal _greater _greater_equal _lesser _lesser_equal "
        "_logical_and _logical_or _logical_xor").split()
_BCAST = ("add sub mul maximum minimum hypot plus minus").split()
_BCMP = ("equal not_equal greater greater_equal lesser lesser_equal "
         "logical_and logical_or logical_xor").split()
_SEQ = [_u(4, 2, 3), _c([2.0, 4.0])]
_BN_INPUTS = [_u(2, 3, 4, 4), _u(3, lo=0.5, hi=1.5), _u(3), _u(3),
            _u(3, lo=0.5, hi=1.5)]


_MULTI = {"lrs": (0.1, 0.05), "wds": (0.01, 0.0), "num_weights": 2}
_FUSED_INPUTS = [_u(2, 3, 6, 6), _u(4, 3, 3, 3), _u(4), _u(4, lo=0.5, hi=1.5),
                 _u(4), _u(4), _u(4, lo=0.5, hi=1.5)]
# the region relu(x * w) as the opaque node's Symbol JSON
_SUBGRAPH_JSON = json.dumps({
    "nodes": [{"op": "null", "name": "x", "inputs": []},
              {"op": "null", "name": "w", "inputs": []},
              {"op": "broadcast_mul", "name": "m",
               "inputs": [[0, 0, 0], [1, 0, 0]]},
              {"op": "relu", "name": "r", "inputs": [[2, 0, 0]]}],
    "arg_nodes": [0, 1], "node_row_ptr": [0, 1, 2, 3, 4],
    "heads": [[3, 0, 0]], "attrs": {"mxnet_version": ["int", 10500]}})


def _op_case_groups():
    """[(names, inputs, attrs, grad)]: names is one op's names separated by
    spaces (aliases share the case), with ":variant" for a second case."""
    cases = [(n, [_u(3, 4, **r)], {}, True) for n, r in _UNARY_CASES.items()]
    cases += [(n, [_u(3, 4), _u(3, 4)], {}, True)
              for n in _BINARY_CASES]
    cases += [(n, [_u(3, 4)], {"scalar": s}, True)
              for n, s in _SCALAR_CASES.items()]
    cases += [(n, [_i(3, 4), _i(3, 4)], {}, False) for n in _CMP]
    cases += [(n + "_scalar", [_i(3, 4)], {"scalar": 1.0}, False)
              for n in _CMP]
    cases += [("broadcast_" + n, [_u(3, 4), _u(1, 4)], {}, True)
              for n in _BCAST]
    cases += [("broadcast_" + n, [_i(3, 4), _i(3, 1)], {}, False)
              for n in _BCMP]
    cases += [
        # elementwise
        ("elemwise_div _div _scatter_elemwise_div",
         [_u(3, 4), _u(3, 4, **_POS)], {}, True),
        ("_power", [_u(3, 4, **_POS), _u(3, 4)], {}, True),
        ("_mod", [_u(3, 4, lo=-3, hi=3), _u(3, 4, **_POS)], {}, True),
        ("_rdiv_scalar", [_u(3, 4, **_POS)], {"scalar": 1.7}, True),
        ("_mod_scalar", [_u(3, 4, lo=-3, hi=3)], {"scalar": 0.7}, True),
        ("_rmod_scalar", [_u(3, 4, **_POS)], {"scalar": 3.3}, True),
        ("_power_scalar", [_u(3, 4, **_POS)], {"scalar": 1.7}, True),
        ("_rpower_scalar", [_u(3, 4)], {"scalar": 1.7}, True),
        ("logical_not", [_i(3, 4, hi=2)], {}, False),
        ("BlockGrad stop_gradient", [_u(3, 4)], {}, False),
        ("zeros_like", [_u(3, 4)], {}, False),
        ("ones_like", [_u(3, 4)], {}, False),
        ("shape_array", [_u(3, 4)], {}, False),
        ("size_array", [_u(3, 4)], {}, False),
        ("Cast cast", [_u(3, 4)], {"dtype": "float16"}, True),
        ("amp_cast", [_u(3, 4)], {"dtype": "float16"}, True),
        ("amp_multicast", [_u(3, 4), _i(3, 4, dtype="int32")],
         {"num_outputs": 2}, False),
        ("clip", [_u(3, 4)], {"a_min": -0.5, "a_max": 0.5}, True),
        ("hard_sigmoid", [_u(3, 4, lo=-4, hi=4)], {}, True),
        ("add_n ElementWiseSum _sum", [_u(3, 4)] * 3, {}, True),
        ("smooth_l1", [_u(3, 4, lo=-2, hi=2)], {"scalar": 1.0}, True),
        ("_identity_with_attr_like_rhs", [_u(3, 4), _u(3, 4)], {}, True),
        ("_zeros_without_dtype", [], {"shape": (2, 3)}, False),
        ("_contrib_quadratic contrib_quadratic", [_u(3, 4)],
         {"a": 0.5, "b": -1.0, "c": 2.0}, True),
        ("_contrib_gradientmultiplier contrib_gradientmultiplier",
         [_u(3, 4)], {"scalar": -0.5}, True),
        # broadcast
        ("broadcast_div", [_u(3, 4), _u(1, 4, **_POS)], {}, True),
        ("broadcast_mod", [_u(3, 4, lo=-3, hi=3), _u(3, 1, **_POS)], {},
         True),
        ("broadcast_power", [_u(3, 4, **_POS), _u(1, 4)], {}, True),
        ("broadcast_to", [_u(1, 4)], {"shape": (3, 4)}, True),
        ("broadcast_axis broadcast_axes", [_u(3, 1)],
         {"axis": 1, "size": 4}, True),
        ("broadcast_like", [_u(1, 4), _u(3, 4)], {}, True),
        # reductions and ordering
        ("sum sum_axis", [_u(2, 3, 4)], {"axis": 1}, True),
        ("sum:exclude", [_u(2, 3, 4)], {"axis": 1, "exclude": True}, True),
        ("sum:int", [_i(2, 3, 4, hi=9, dtype="int32")], {"axis": 1}, False),
        ("mean", [_u(2, 3, 4)], {"axis": (0, 2), "keepdims": True}, True),
        ("mean:int", [_i(2, 3, 4, hi=9, dtype="int32")], {}, False),
        ("prod", [_u(2, 3, 4, lo=0.5, hi=1.5)], {"axis": 2}, True),
        ("nansum", [_u(2, 3, 4)], {"axis": 0}, True),
        ("nanprod", [_u(2, 3, 4, lo=0.5, hi=1.5)], {}, True),
        ("max max_axis", [_u(2, 3, 4)], {"axis": 1}, True),
        ("min min_axis", [_u(2, 3, 4)], {"axis": (0, 1)}, True),
        ("max:bool", [_i(2, 3, hi=2, dtype="bool")], {"axis": 1}, False),
        ("norm", [_u(2, 3, 4)], {"ord": 2, "axis": 1}, True),
        ("norm:l1", [_u(2, 3, 4)], {"ord": 1}, True),
        ("argmax", [_u(2, 3, 4)], {"axis": 1}, False),
        ("argmin", [_u(2, 3, 4)], {"axis": 2, "keepdims": True}, False),
        ("argmax_channel", [_u(3, 4)], {}, False),
        ("topk", [_u(3, 5)], {"k": 2, "ret_typ": "both"}, True),
        ("topk:mask", [_u(3, 5)], {"k": 2, "ret_typ": "mask",
                                    "is_ascend": True}, False),
        ("sort", [_u(3, 5)], {"axis": 1, "is_ascend": False}, True),
        ("argsort", [_u(3, 5)], {"axis": 0}, False),
        ("cumsum", [_u(3, 5)], {"axis": 1}, True),
        ("_histogram", [_u(20)], {"bins": 5}, False),
        ("L2Normalization", [_u(2, 3, 4)], {"mode": "channel"}, True),
        # shapes
        ("Reshape reshape", [_u(2, 3, 4)], {"shape": (-4, 1, 2, -2)}, True),
        ("Reshape:reverse", [_u(2, 3, 4)],
         {"shape": (-1, 0), "reverse": True}, True),
        ("Flatten flatten", [_u(2, 3, 4)], {}, True),
        ("transpose", [_u(2, 3, 4)], {"axes": (2, 0, 1)}, True),
        ("expand_dims", [_u(2, 3)], {"axis": -1}, True),
        ("squeeze", [_u(2, 1, 4)], {"axis": 1}, True),
        ("Concat concat", [_u(2, 3), _u(2, 2)],
         {"dim": 1, "num_args": 2}, True),
        ("stack", [_u(2, 3), _u(2, 3)], {"axis": 1, "num_args": 2}, True),
        ("SliceChannel split", [_u(2, 3, 4)],
         {"num_outputs": 2, "axis": 2}, True),
        ("split_v2", [_u(2, 3, 4)], {"indices": (1,), "axis": 1}, True),
        ("_split_v2", [_u(2, 3, 4)],
         {"sections": 2, "axis": 2, "squeeze_axis": False}, True),
        ("slice crop", [_u(3, 4)], {"begin": (0, 1), "end": (2, 4)}, True),
        ("slice:step", [_u(4, 5)],
         {"begin": (3, 0), "end": (0, 5), "step": (-1, 2)}, True),
        ("slice_axis", [_u(2, 5)], {"axis": 1, "begin": 1, "end": 3}, True),
        ("slice_like", [_u(3, 4), _u(2, 3)], {}, True),
        ("reverse flip", [_u(3, 4)], {"axis": 1}, True),
        ("tile", [_u(2, 3)], {"reps": (2, 1)}, True),
        ("repeat", [_u(2, 3)], {"repeats": 2, "axis": 1}, True),
        ("Pad pad", [_u(1, 2, 3, 3)],
         {"mode": "constant", "pad_width": (0, 0, 0, 0, 1, 2, 2, 1),
          "constant_value": 0.5}, True),
        ("Pad:edge", [_u(1, 2, 3, 3)],
         {"mode": "edge", "pad_width": (0, 0, 0, 0, 1, 1, 2, 2)}, True),
        ("depth_to_space", [_u(1, 4, 2, 3)], {"block_size": 2}, True),
        ("space_to_depth", [_u(1, 1, 4, 6)], {"block_size": 2}, True),
        ("SwapAxis swapaxes", [_u(2, 3, 4)], {"dim1": 0, "dim2": 2}, True),
        ("diag", [_u(3, 4)], {"k": 1}, True),
        ("_arange_like contrib_arange_like", [_u(2, 3)],
         {"start": 1.0, "step": 0.5}, False),
        ("_slice_assign _crop_assign", [_u(3, 4), _u(2, 2)],
         {"begin": (0, 1), "end": (2, 3)}, True),
        ("_slice_assign_scalar _crop_assign_scalar", [_u(3, 4)],
         {"begin": (1,), "end": (3,), "scalar": 2.5}, True),
        ("reshape_like", [_u(2, 6), _u(3, 4)], {}, True),
        # indexing
        ("take", [_u(5, 3), _i(2, 2, lo=-2, hi=7)], {"mode": "wrap"}, (0,)),
        ("take:clip", [_u(5, 3), _i(4, lo=-2, hi=7)],
         {"axis": 0, "mode": "clip"}, (0,)),
        ("Embedding", [_i(2, 3, hi=5), _u(5, 4)],
         {"input_dim": 5, "output_dim": 4}, (1,)),
        ("_contrib_SparseEmbedding contrib_SparseEmbedding",
         [_i(2, 3, hi=5), _u(5, 4)], {"input_dim": 5, "output_dim": 4},
         (1,)),
        ("one_hot", [_i(2, 3, hi=4)], {"depth": 4}, False),
        ("pick choose_element_0index", [_u(3, 4), _i(3, hi=4)], {}, (0,)),
        ("pick:keepdims", [_u(3, 4), _i(4, hi=3)],
         {"axis": 0, "keepdims": True}, (0,)),
        ("batch_take", [_u(3, 4), _i(3, hi=4)], {}, (0,)),
        ("gather_nd", [_u(3, 4), _c([[0, 2, 1], [1, 3, 0]])], {}, (0,)),
        ("scatter_nd", [_u(3), _c([[0, 2, 1], [1, 3, 0]])],
         {"shape": (3, 4)}, (0,)),
        ("_scatter_set_nd", [_u(3), _c([[0, 2, 1], [1, 3, 0]])],
         {"shape": (3, 4)}, (0,)),
        ("where", [_i(3, 4, hi=2), _u(3, 4), _u(3, 4)], {}, (1, 2)),
        ("_contrib_boolean_mask contrib_boolean_mask",
         [_u(4, 3), _c([1.0, 0.0, 1.0, 1.0])], {}, (0,)),
        ("ravel_multi_index _ravel_multi_index",
         [_c([[0, 1, 2], [1, 3, 0]])], {"shape": (3, 4)}, False),
        ("unravel_index _unravel_index", [_c([0.0, 5.0, 11.0])],
         {"shape": (3, 4)}, False),
        ("_contrib_index_copy", [_u(5, 3), _c([0.0, 3.0]), _u(2, 3)], {},
         (0, 2)),
        ("_contrib_index_array", [_u(2, 3)], {}, False),
        ("SequenceMask", _SEQ, {"use_sequence_length": True, "value": -1.0},
         (0,)),
        ("SequenceLast", _SEQ, {"use_sequence_length": True}, (0,)),
        ("SequenceReverse", _SEQ, {"use_sequence_length": True}, (0,)),
        ("cast_storage", [_u(3, 4)], {"stype": "default"}, True),
        ("_sparse_retain sparse_retain", [_u(4, 3), _c([0.0, 2.0])], {},
         (0,)),
        ("_square_sum square_sum", [_u(3, 4)], {"axis": 1}, True),
        ("_ag_getitem", [_u(3, 4)], {"key": ((slice(None), 1),)}, True),
        # creation
        ("_zeros zeros", [], {"shape": (2, 3)}, False),
        ("_ones ones", [], {"shape": (2, 3), "dtype": "int32"}, False),
        ("_full full", [], {"shape": (2, 3), "value": 1.5}, False),
        ("_eye eye", [], {"N": 3, "M": 4, "k": 1}, False),
        ("_arange arange", [], {"start": 1.0, "stop": 4.0, "step": 0.5,
                                "repeat": 2}, False),
        ("_linspace linspace", [], {"start": 0.0, "stop": 1.0, "num": 5},
         False),
        ("full_like", [_u(2, 3)], {"fill_value": 2.0}, False),
        # products
        ("dot", [_u(3, 4), _u(4, 2)], {}, True),
        ("dot:transpose", [_u(4, 3), _u(2, 4)],
         {"transpose_a": True, "transpose_b": True}, True),
        ("batch_dot", [_u(2, 3, 4), _u(2, 4, 5)], {}, True),
        # nn
        ("FullyConnected", [_u(2, 3, 2), _u(5, 6), _u(5)],
         {"num_hidden": 5}, True),
        ("FullyConnected:no_flatten", [_u(2, 3, 6), _u(5, 6)],
         {"num_hidden": 5, "no_bias": True, "flatten": False}, True),
        ("Convolution Convolution_v1", [_u(2, 3, 6, 6), _u(4, 3, 3, 3), _u(4)],
         {"kernel": (3, 3), "stride": (2, 1), "pad": (1, 1),
          "num_filter": 4}, True),
        ("Convolution:group", [_u(2, 4, 5, 5), _u(4, 2, 3, 3)],
         {"kernel": (3, 3), "dilate": (2, 2), "num_filter": 4,
          "num_group": 2, "no_bias": True}, True),
        # the TPU_FUSE fold: data, weight, bias, gamma, beta, moving stats
        ("_fused_conv_bn_relu", _FUSED_INPUTS,
         {"kernel": (3, 3), "pad": (1, 1), "num_filter": 4, "eps": 1e-3,
          "fix_gamma": False}, True),
        ("_fused_conv_bn_relu:fix_gamma_no_relu", _FUSED_INPUTS,
         {"kernel": (3, 3), "stride": (2, 2), "num_filter": 4,
          "fix_gamma": True, "with_relu": False}, True),
        ("_subgraph_exec", [_u(2, 3), _u(3)],
         {"subgraph": _SUBGRAPH_JSON, "arg_names": "x,w", "n_out": 1}, True),
        ("Pooling Pooling_v1", [_u(2, 3, 7, 7)],
         {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
          "pool_type": "max"}, True),
        ("Pooling:avg_full", [_u(2, 3, 6, 6)],
         {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
          "pool_type": "avg", "pooling_convention": "full",
          "count_include_pad": False}, True),
        ("Pooling:avg_full_include", [_u(2, 3, 6, 6)],
         {"kernel": (3, 3), "stride": (2, 2), "pool_type": "avg",
          "pooling_convention": "full"}, True),
        ("Pooling:sum", [_u(2, 3, 6, 6)],
         {"kernel": (2, 2), "stride": (2, 2), "pool_type": "sum"}, True),
        ("Pooling:lp", [_u(2, 3, 6, 6)],
         {"kernel": (2, 2), "stride": (1, 1), "pool_type": "lp",
          "p_value": 2}, True),
        ("Pooling:global", [_u(2, 3, 5, 5)],
         {"kernel": (1, 1), "global_pool": True, "pool_type": "avg"}, True),
        ("Activation", [_u(3, 4)], {"act_type": "softrelu"}, True),
        ("Activation:tanh", [_u(3, 4)], {"act_type": "tanh"}, True),
        ("softmax", [_u(3, 4)], {"axis": 0, "temperature": 2.0}, True),
        ("log_softmax", [_u(3, 4)], {}, True),
        ("softmin", [_u(3, 4)], {"axis": 1}, True),
        ("softmax_cross_entropy", [_u(3, 5), _i(3, hi=5)], {}, (0,)),
        ("SoftmaxOutput Softmax", [_u(3, 5), _i(3, hi=5)],
         {"grad_scale": 0.5, "normalization": "batch"}, (0,)),
        ("SoftmaxOutput:ignore", [_u(4, 5), _c([1.0, -1.0, 3.0, 0.0])],
         {"use_ignore": True, "normalization": "valid"}, (0,)),
        ("BatchNorm BatchNorm_v1", _BN_INPUTS,
         {"eps": 1e-5, "fix_gamma": False, "_train": True}, (0, 1, 2)),
        ("BatchNorm:fix_gamma", _BN_INPUTS, {"_train": True}, (0, 1, 2)),
        ("BatchNorm:predict", _BN_INPUTS,
         {"fix_gamma": False, "_train": False}, (0, 1, 2)),
        ("LayerNorm", [_u(2, 3, 4), _u(4), _u(4)], {}, True),
        ("LayerNorm:axis", [_u(2, 3, 4), _u(3), _u(3)], {"axis": 1}, True),
        ("Dropout", [_u(3, 4)], {"p": 0.3, "_train": False}, True),
        # SGD
        ("sgd_update", [_u(3, 4), _u(3, 4)],
         {"lr": 0.1, "wd": 0.01, "rescale_grad": 0.5,
          "clip_gradient": 0.2}, False),
        ("sgd_mom_update", [_u(3, 4), _u(3, 4), _u(3, 4)],
         {"lr": 0.1, "momentum": 0.9, "wd": 1e-4}, False),
        ("mp_sgd_update", [_u(3, 4, dtype="float16"),
                           _u(3, 4, dtype="float16"), _u(3, 4)],
         {"lr": 0.1, "wd": 0.01}, False),
        ("mp_sgd_mom_update", [_u(3, 4, dtype="float16"),
                               _u(3, 4, dtype="float16"), _u(3, 4),
                               _u(3, 4)],
         {"lr": 0.1, "momentum": 0.9, "clip_gradient": 0.3}, False),
        # aggregated SGD: two weights each, their own lr and wd
        ("multi_sgd_update", [_u(3, 4), _u(3, 4), _u(5), _u(5)],
         dict(_MULTI, rescale_grad=0.5, clip_gradient=0.2), False),
        ("multi_sgd_mom_update", [_u(3, 4)] * 3 + [_u(5)] * 3,
         dict(_MULTI, momentum=0.9), False),
        ("multi_mp_sgd_update", [_u(3, 4, dtype="float16")] * 2 + [_u(3, 4)]
         + [_u(5, dtype="float16")] * 2 + [_u(5)], _MULTI, False),
        ("multi_mp_sgd_mom_update",
         [_u(3, 4, dtype="float16")] * 2 + [_u(3, 4)] * 2
         + [_u(5, dtype="float16")] * 2 + [_u(5)] * 2,
         dict(_MULTI, momentum=0.9, clip_gradient=0.3), False),
    ]
    return cases + _training_op_cases() + _recurrent_op_cases() \
        + _image_op_cases() + _RANDOM_CASES + _IMAGE_RANDOM_CASES


_ROIS = [[0, 0, 0, 3, 3], [1, 1, 1, 5, 4], [0, 2.5, 0.5, 5, 5]]
_W16, _W32 = _u(3, 4, dtype="float16"), _u(3, 4)
_POS34 = _u(3, 4, **_POS)


def _training_op_cases():
    """Slice 13's deterministic names: the rest of the nn ops, four vision
    ops, CTCLoss and the update ops of the other optimizers."""
    return [
        # nn
        ("Deconvolution", [_u(2, 3, 4, 4), _u(3, 2, 3, 3), _u(2)],
         {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1), "adj": (1, 1),
          "num_filter": 2, "no_bias": False}, True),
        ("Deconvolution:group", [_u(2, 4, 3, 3), _u(4, 1, 2, 2)],
         {"kernel": (2, 2), "stride": (2, 2), "num_filter": 2,
          "num_group": 2}, True),
        ("Deconvolution:1d_dilate", [_u(2, 2, 5), _u(2, 3, 3)],
         {"kernel": (3,), "dilate": (2,), "pad": (1,), "num_filter": 3},
         True),
        ("UpSampling", [_u(1, 2, 3, 3)], {"scale": 2}, True),
        ("UpSampling:concat", [_u(1, 2, 4, 4), _u(1, 1, 2, 2)],
         {"scale": 2, "num_args": 2}, True),
        ("UpSampling:bilinear", [_u(1, 2, 3, 3), _u(2, 1, 4, 4)],
         {"scale": 2, "sample_type": "bilinear", "num_args": 2,
          "num_filter": 2}, True),
        ("LRN", [_u(2, 5, 3, 3)], {"nsize": 3, "alpha": 0.01}, True),
        ("LeakyReLU", [_u(3, 4)], {"slope": 0.1}, True),
        ("LeakyReLU:prelu", [_u(2, 3, 4), _u(3)], {"act_type": "prelu"},
         True),
        ("LeakyReLU:elu", [_u(3, 4)], {"act_type": "elu", "slope": 0.7},
         True),
        ("LeakyReLU:selu", [_u(3, 4)], {"act_type": "selu"}, True),
        ("LeakyReLU:gelu", [_u(3, 4)], {"act_type": "gelu"}, True),
        ("LeakyReLU:rrelu_predict", [_u(3, 4)],
         {"act_type": "rrelu", "_train": False}, True),
        ("SoftmaxActivation", [_u(2, 3, 4)], {}, True),
        ("SoftmaxActivation:channel", [_u(2, 3, 4)], {"mode": "channel"},
         True),
        ("InstanceNorm", [_u(2, 3, 4, 4), _u(3), _u(3)], {"eps": 1e-5},
         True),
        ("_contrib_SyncBatchNorm", _BN_INPUTS,
         {"eps": 1e-5, "fix_gamma": False, "_train": True}, (0, 1, 2)),
        ("LinearRegressionOutput", [_u(3, 4), _u(3, 4)],
         {"grad_scale": 0.5}, (0,)),
        ("MAERegressionOutput", [_u(3, 4), _u(3, 4)], {}, (0,)),
        ("LogisticRegressionOutput", [_u(3, 4), _u(3, 4, lo=0.0)], {},
         (0,)),
        ("MakeLoss", [_u(3, 4)], {"grad_scale": 1.0}, True),
        ("BilinearSampler", [_u(1, 2, 4, 5), _u(1, 2, 3, 3, lo=-1.1,
                                                 hi=1.1)], {}, True),
        ("GridGenerator", [_u(2, 6)], {"target_shape": (3, 4)}, True),
        ("GridGenerator:warp", [_u(1, 2, 3, 4)],
         {"transform_type": "warp", "target_shape": (3, 4)}, True),
        ("IdentityAttachKLSparseReg", [_u(3, 4)], {}, True),
        # vision
        ("ROIPooling", [_u(2, 3, 6, 6), _c(_ROIS)],
         {"pooled_size": (2, 2), "spatial_scale": 1.0}, (0,)),
        ("SpatialTransformer", [_u(2, 2, 5, 5), _u(2, 6, lo=-0.6, hi=0.6)],
         {"target_shape": (4, 4), "transform_type": "affine",
          "sampler_type": "bilinear"}, True),
        ("Correlation", [_u(1, 2, 5, 5), _u(1, 2, 5, 5)],
         {"max_displacement": 1, "pad_size": 1}, True),
        ("Correlation:abs_window", [_u(1, 2, 6, 6), _u(1, 2, 6, 6)],
         {"kernel_size": 3, "max_displacement": 2, "stride2": 2,
          "pad_size": 2, "is_multiply": False}, True),
        ("SVMOutput", [_u(4, 3), _c([0.0, 2.0, 1.0, 2.0])],
         {"margin": 0.5, "regularization_coefficient": 0.7}, (0,)),
        ("SVMOutput:linear", [_u(4, 3), _c([1.0, 0.0, 2.0, 1.0])],
         {"use_linear": True}, (0,)),
        # CTC: (T, N, C) activations; blank first (padding 0) or last (-1)
        ("CTCLoss ctc_loss _contrib_CTCLoss _contrib_ctc_loss",
         [_u(6, 2, 4), _c([[1.0, 2.0, 0.0], [3.0, 3.0, 1.0]])], {}, (0,)),
        ("CTCLoss:last", [_u(6, 2, 4), _c([[0.0, 1.0, -1.0],
                                           [2.0, 2.0, 1.0]])],
         {"blank_label": "last"}, (0,)),
        ("CTCLoss:lengths", [_u(6, 2, 4), _c([[1.0, 2.0, 3.0],
                                              [2.0, 1.0, 1.0]]),
                             _c([5.0, 4.0]), _c([2.0, 3.0])],
         {"use_data_lengths": True, "use_label_lengths": True}, (0,)),
        ("CTCLoss:no_alignment", [_u(2, 2, 4), _c([[1.0, 1.0, 2.0],
                                                   [3.0, 0.0, 0.0]])], {},
         (0,)),
        # updates: weight, gradient, states (fp16 weights with fp32 masters)
        ("nag_mom_update", [_W32, _u(3, 4), _u(3, 4)],
         {"lr": 0.1, "momentum": 0.9, "wd": 0.01, "rescale_grad": 0.5},
         False),
        ("mp_nag_mom_update", [_W16, _u(3, 4, dtype="float16"), _u(3, 4),
                               _W32], {"lr": 0.1, "momentum": 0.9}, False),
        ("adam_update", [_W32, _u(3, 4), _u(3, 4), _POS34],
         {"lr": 0.01, "wd": 1e-3, "clip_gradient": 0.3}, False),
        ("ftml_update", [_W32, _u(3, 4), _u(3, 4), _POS34, _u(3, 4)],
         {"lr": 0.1, "t": 2, "clip_grad": 0.5}, False),
        ("rmsprop_update", [_W32, _u(3, 4), _POS34],
         {"lr": 0.05, "clip_weights": 0.8}, False),
        ("rmspropalex_update", [_W32, _u(3, 4), _POS34,
                                _u(3, 4, lo=-0.1, hi=0.1), _u(3, 4)],
         {"lr": 0.05, "wd": 0.01}, False),
        ("ftrl_update", [_W32, _u(3, 4), _u(3, 4), _POS34],
         {"lr": 0.1, "lamda1": 0.05, "wd": 0.01}, False),
        ("signsgd_update", [_W32, _u(3, 4)], {"lr": 0.1, "wd": 0.01},
         False),
        ("signum_update", [_W32, _u(3, 4), _u(3, 4)],
         {"lr": 0.1, "momentum": 0.9, "wd_lh": 0.01}, False),
        ("_contrib_adamw_update contrib_adamw_update",
         [_W32, _u(3, 4), _u(3, 4), _POS34],
         {"lr": 0.01, "eta": 0.5, "wd": 0.01}, False),
        ("_contrib_mp_adamw_update",
         [_W16, _u(3, 4, dtype="float16"), _u(3, 4), _POS34, _W32],
         {"lr": 0.01, "wd": 0.01}, False),
        ("_adamw_update", [_W32, _u(3, 4), _u(3, 4), _POS34, _c([0.5])],
         {"lr": 0.01, "wd": 0.01}, False),
        ("_adamw_update:skip", [_W32, _u(3, 4), _u(3, 4), _POS34,
                                _c([float("inf")])], {"lr": 0.01}, False),
        ("_mp_adamw_update", [_W16, _u(3, 4, dtype="float16"), _u(3, 4),
                              _POS34, _W32, _c([0.5])],
         {"lr": 0.01, "clip_gradient": 0.2}, False),
        ("_sparse_adagrad_update", [_W32, _u(3, 4), _POS34],
         {"lr": 0.1, "wd": 0.01}, False),
        ("_contrib_group_adagrad_update contrib_group_adagrad_update",
         [_W32, _u(3, 4), _u(3, **_POS)], {"lr": 0.1}, False),
    ]


def _graph_json(nodes, heads):
    """Symbol JSON of ``nodes`` [(op or None for a variable, name, attrs,
    [input node indices])] whose outputs are the ``heads`` nodes."""
    return json.dumps({
        "nodes": [{"op": op or "null", "name": name,
                   "attrs": {k: str(v) for k, v in attrs.items()},
                   "inputs": [[i, 0, 0] for i in ins]}
                  for op, name, attrs, ins in nodes],
        "arg_nodes": [i for i, n in enumerate(nodes) if n[0] is None],
        "node_row_ptr": list(range(len(nodes) + 1)),
        "heads": [[h, 0, 0] for h in heads],
        "attrs": {"mxnet_version": ["int", 10500]}})


# foreach's body: (x * s, s + x); while's: i < 3, (v * w, (i + 1, v * w));
# cond's branches: x * 2 and exp(x)
_FOREACH_BODY = _graph_json(
    [(None, "x", {}, []), (None, "s", {}, []),
     ("broadcast_mul", "m", {}, [0, 1]), ("broadcast_add", "a", {}, [1, 0])],
    [2, 3])
_WHILE_COND = _graph_json(
    [(None, "lv0", {}, []), ("_lesser_scalar", "c", {"scalar": 3.0}, [0])],
    [1])
_WHILE_BODY = _graph_json(
    [(None, "lv0", {}, []), (None, "lv1", {}, []), (None, "w", {}, []),
     ("broadcast_mul", "m", {}, [1, 2]),
     ("_plus_scalar", "i", {"scalar": 1.0}, [0])], [3, 4, 3])
_COND_THEN = _graph_json(
    [(None, "x", {}, []), ("_mul_scalar", "t", {"scalar": 2.0}, [0])], [1])
_COND_ELSE = _graph_json([(None, "x", {}, []), ("exp", "e", {}, [0])], [1])
_LSTM_N = 4 * 3 * (4 + 3 + 2)          # rnn_param_size(1, 3, 4, "lstm")
_GRU_BI_N = 2 * 3 * 3 * (4 + 3 + 2)    # rnn_param_size(1, 3, 4, "gru", True)
_TANH_2L_N = 3 * (4 + 3 + 2) + 3 * (3 + 3 + 2)  # 2 layers of rnn_tanh
_RNN_W = {"lo": -0.5, "hi": 0.5}


def _recurrent_op_cases():
    """Slice 14's names: the fused RNN op on each route, its parameter
    concatenation and the three control-flow ops."""
    return [
        ("RNN", [_u(5, 2, 4), _u(_LSTM_N, **_RNN_W), _u(1, 2, 3),
                 _u(1, 2, 3)],
         {"state_size": 3, "num_layers": 1, "mode": "lstm",
          "state_outputs": True}, True),
        ("RNN:gru_bidirectional", [_u(5, 2, 4), _u(_GRU_BI_N, **_RNN_W),
                                   _u(2, 2, 3)],
         {"state_size": 3, "num_layers": 1, "mode": "gru",
          "bidirectional": True, "state_outputs": True}, True),
        ("RNN:tanh_step_route", [_u(5, 2, 4), _u(_TANH_2L_N, **_RNN_W),
                                 _u(2, 2, 3)],
         {"state_size": 3, "num_layers": 2, "mode": "rnn_tanh",
          "cudnn_off": True}, True),
        ("RNN:lstm_clip_lengths", [_u(5, 2, 4), _u(_LSTM_N, **_RNN_W),
                                   _u(1, 2, 3), _u(1, 2, 3),
                                   _c([5.0, 3.0])],
         {"state_size": 3, "num_layers": 1, "mode": "lstm",
          "lstm_state_clip_min": -0.3, "lstm_state_clip_max": 0.3,
          "use_sequence_length": True, "state_outputs": True},
         (0, 1, 2, 3)),
        ("_rnn_param_concat", [_u(2, 3), _u(4)], {"dim": 0, "num_args": 2},
         True),
        ("_foreach", [_u(4, 3), _u(3)],
         {"subgraph": _FOREACH_BODY, "sub_args": "x,s", "n_data": 1,
          "n_states": 1, "n_out": 1}, True),
        ("_while_loop", [_c([0.0]), _u(3), _u(3)],
         {"cond_subgraph": _WHILE_COND, "body_subgraph": _WHILE_BODY,
          "cond_args": "lv0", "body_args": "lv0,lv1,w",
          "lv_names": "lv0,lv1", "n_lv": 2, "n_out": 1,
          "max_iterations": 5}, (1, 2)),
        ("_cond", [_c([1.0]), _u(3)],
         {"then_subgraph": _COND_THEN, "else_subgraph": _COND_ELSE,
          "then_args": "x", "else_args": "x", "n_out": 1}, (1,)),
        ("_cond:else", [_c([0.0]), _u(3)],
         {"then_subgraph": _COND_THEN, "else_subgraph": _COND_ELSE,
          "then_args": "x", "else_args": "x", "n_out": 1}, (1,)),
    ]


# A 4 x 3 RGB PNG (pixels from RandomState(0)): the codec ops' input
CV_PNG = bytes.fromhex(
    "89504e470d0a1a0a0000000d49484452000000040000000308020000003b9639"
    "910000003249444154789c012700d8ff01ac2f7514148603240e10aee9047828"
    "d1b40191625addedf0bc0434fa5f41fca3f0d3e7c79c522d801299dc80f93500"
    "00000049454e44ae426082")
_PIXELS = {"lo": 0.0, "hi": 255.0}
_U8 = {"lo": 0, "hi": 256, "dtype": "uint8"}
# the ops whose work is host codec work (PIL), with no device computation
# to hold to the CPU's: the nd phase's card-against-CPU check leaves them
# out (the machine with the card has no image codec)
HOST_OPS = frozenset(("_cvimdecode", "cvimdecode", "_cvimread", "cvimread",
                      "_cvimresize", "cvimresize"))


def cv_image_file():
    """`CV_PNG` written once under the temporary directory: the file of
    the ``_cvimread`` case."""
    path = os.path.join(tempfile.gettempdir(), "chip_smoke_cv_%s.png"
                        % hashlib.sha1(CV_PNG).hexdigest()[:12])
    if not os.path.exists(path):
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path))
        with os.fdopen(fd, "wb") as f:
            f.write(CV_PNG)
        os.replace(tmp, path)
    return path


def _image_op_cases():
    """Slice 16's deterministic names: the ``_image_*`` ops on HWC / NHWC
    images (float ones with their gradients) and the host ops of
    `image_io.cc`."""
    png = _c(list(CV_PNG), "uint8")
    return [
        ("_image_to_tensor image_to_tensor", [_i(4, 5, 3, **_U8)], {},
         False),
        ("_image_to_tensor:float_batch", [_u(2, 4, 5, 3, **_PIXELS)], {},
         True),
        ("_image_normalize image_normalize", [_u(3, 4, 5)],
         {"mean": (0.485, 0.456, 0.406), "std": (0.229, 0.224, 0.225)},
         True),
        ("_image_normalize:batch", [_u(2, 3, 4, 5)],
         {"mean": 0.5, "std": 0.25}, True),
        ("_image_flip_left_right image_flip_left_right", [_u(4, 5, 3)], {},
         True),
        ("_image_flip_left_right:batch", [_u(2, 4, 5, 3)], {}, True),
        ("_image_flip_top_bottom image_flip_top_bottom", [_u(4, 5, 3)], {},
         True),
        ("_image_adjust_lighting image_adjust_lighting",
         [_u(4, 5, 3, **_PIXELS)], {"alpha": (0.1, -0.2, 0.05)}, True),
        ("_image_resize image_resize", [_u(6, 8, 3, **_PIXELS)],
         {"size": (5, 4)}, True),
        ("_image_resize:upscale_nearest_batch", [_u(2, 6, 8, 3)],
         {"size": (12, 9), "interp": 0}, True),
        ("_image_resize:uint8_short_side", [_i(6, 10, 3, **_U8)],
         {"size": 4, "keep_ratio": True}, False),
        ("_image_crop image_crop", [_u(6, 8, 3)],
         {"x": 1, "y": 2, "width": 4, "height": 3}, True),
        ("_image_crop:batch", [_i(2, 6, 8, 3, **_U8)],
         {"x": 0, "y": 1, "width": 8, "height": 5}, False),
        ("_cvimdecode cvimdecode", [png], {}, False),
        ("_cvimdecode:gray_bgr", [png], {"flag": 0}, False),
        ("_cvimdecode:bgr", [png], {"to_rgb": False}, False),
        ("_cvimread cvimread", [], {"filename": cv_image_file()}, False),
        ("_cvimresize cvimresize", [_i(6, 8, 3, **_U8)],
         {"w": 5, "h": 4, "interp": 1}, False),
        ("_cvcopyMakeBorder cvcopyMakeBorder", [_i(5, 6, 3, **_U8)],
         {"top": 1, "bot": 2, "left": 3, "right": 1, "value": 7.0}, False),
        ("_cvcopyMakeBorder:edge", [_i(5, 6, 3, **_U8)],
         {"top": 2, "bot": 1, "left": 1, "right": 3, "type": 1}, False),
        ("_cvcopyMakeBorder:reflect", [_u(5, 6, 3)],
         {"top": 3, "bot": 1, "left": 2, "right": 2, "type": 2}, False),
    ]


# The random ops (slice 13): a case each, compared by shape and dtype
# (torch's streams are not threefry's, and the card's are not the CPU's);
# their values are held by `random_draw_checks`.
_RANDOM_CASES = [
    ("_random_uniform random_uniform uniform", [],
     {"low": -1.0, "high": 2.0, "shape": (2, 3)}, False),
    ("_random_normal random_normal normal", [],
     {"loc": 1.0, "scale": 2.0, "shape": (2, 3)}, False),
    ("_random_gamma random_gamma", [],
     {"alpha": 2.0, "beta": 0.5, "shape": (4,)}, False),
    ("_random_exponential random_exponential", [],
     {"lam": 2.0, "shape": (4,)}, False),
    ("_random_poisson random_poisson", [], {"lam": 3.0, "shape": (4,)},
     False),
    ("_random_negative_binomial random_negative_binomial", [],
     {"k": 3, "p": 0.4, "shape": (4,)}, False),
    ("_random_generalized_negative_binomial "
     "random_generalized_negative_binomial", [],
     {"mu": 2.0, "alpha": 0.5, "shape": (4,)}, False),
    ("_random_randint random_randint randint", [],
     {"low": -2, "high": 5, "shape": (4,)}, False),
    ("_sample_uniform sample_uniform",
     [_u(2, lo=-1.0, hi=0.0), _u(2, lo=1.0, hi=2.0)], {"shape": (3,)},
     False),
    ("_sample_normal sample_normal", [_u(2), _u(2, **_POS)],
     {"shape": (3,)}, False),
    ("_sample_gamma sample_gamma", [_u(2, **_POS), _u(2, **_POS)],
     {"shape": (3,)}, False),
    ("_sample_exponential sample_exponential", [_u(2, **_POS)],
     {"shape": (3,)}, False),
    ("_sample_poisson sample_poisson", [_u(2, lo=1.0, hi=3.0)],
     {"shape": (3,)}, False),
    ("_sample_negative_binomial sample_negative_binomial",
     [_c([2.0, 3.0]), _c([0.4, 0.6])], {"shape": (3,)}, False),
    ("_sample_generalized_negative_binomial "
     "sample_generalized_negative_binomial",
     [_u(2, **_POS), _u(2, **_POS)], {"shape": (3,)}, False),
    ("_sample_multinomial sample_multinomial",
     [_c([[0.2, 0.3, 0.5], [0.6, 0.3, 0.1]])],
     {"shape": (4,), "get_prob": True}, False),
    ("_shuffle shuffle", [_u(5, 2)], {}, False),
    ("_sample_unique_zipfian", [], {"range_max": 50, "shape": (2, 4)},
     False),
]
# slice 16's random image ops: by shape and dtype, and by the range each
# transform can reach (`image_random_in_range`)
_IMAGE_RANDOM_CASES = [
    ("_image_random_flip_left_right image_random_flip_left_right",
     [_u(4, 5, 3)], {}, False),
    ("_image_random_flip_top_bottom image_random_flip_top_bottom",
     [_u(2, 4, 5, 3)], {}, False),
    ("_image_random_brightness image_random_brightness",
     [_u(4, 5, 3, **_PIXELS)], {"min_factor": 0.5, "max_factor": 1.5},
     False),
    ("_image_random_contrast image_random_contrast",
     [_u(2, 4, 5, 3, **_PIXELS)], {"min_factor": 0.5, "max_factor": 1.5},
     False),
    ("_image_random_saturation image_random_saturation",
     [_u(4, 5, 3, **_PIXELS)], {"min_factor": 0.5, "max_factor": 1.5},
     False),
    ("_image_random_hue image_random_hue", [_u(4, 5, 3, **_PIXELS)],
     {"min_factor": -0.1, "max_factor": 0.1}, False),
    ("_image_random_color_jitter image_random_color_jitter",
     [_u(4, 5, 3, **_PIXELS)],
     {"brightness": 0.4, "contrast": 0.4, "saturation": 0.4, "hue": 0.1},
     False),
    ("_image_random_lighting image_random_lighting",
     [_u(4, 5, 3, **_PIXELS)], {"alpha_std": 0.1}, False),
]
RANDOM_OPS = frozenset(name for names, *_ in _RANDOM_CASES
                       + _IMAGE_RANDOM_CASES for name in names.split())
IMAGE_RANDOM_OPS = frozenset(name for names, *_ in _IMAGE_RANDOM_CASES
                             for name in names.split())


def op_cases():
    """[(case id, op name, inputs, attrs, grad)]: one case for every name
    the port registers."""
    out = []
    for names, inputs, attrs, grad in _op_case_groups():
        names, _, variant = names.partition(":")
        for name in names.split():
            out.append((name + (":" + variant if variant else ""), name,
                        inputs, attrs, grad))
    return out


def op_case_arrays(case, seed=0):
    """The case's inputs as numpy arrays, from `seed`."""
    import numpy as np

    rng = np.random.RandomState(seed)
    out = []
    for spec in case[2]:
        if spec[0] == "c":
            out.append(np.asarray(spec[1], spec[2]))
        elif spec[0] == "u":
            _, shape, lo, hi, dt = spec
            out.append(rng.uniform(lo, hi, shape).astype(dt))
        else:
            _, shape, lo, hi, dt = spec
            out.append(rng.randint(lo, hi, shape).astype(dt))
    return out


def op_case_grad_inputs(case):
    """Indices of the inputs whose gradients the case checks."""
    grad = case[4]
    if grad is True:
        return tuple(i for i, s in enumerate(case[2]) if s[0] == "u")
    return tuple(grad) if grad else ()


def op_case_cotangent(shape, dtype, seed=1):
    import numpy as np

    return np.random.RandomState(seed).standard_normal(shape).astype(dtype)


def port_op_case(mx, case, arrays, ctx):
    """Run one case on `mx` (the port) on ctx: (outputs, input gradients
    by index, every input after the call, cotangents), all numpy. The
    gradients are those of sum(output * cotangent) over the float
    outputs."""
    import numpy as np

    _, name, _, attrs, _ = case
    diff = op_case_grad_inputs(case)
    fn = getattr(mx.nd.op, name)
    nds = [mx.nd.array(a, ctx=ctx, dtype=a.dtype) for a in arrays]
    for i in diff:
        nds[i].attach_grad()
    extra = {} if arrays else {"ctx": ctx}
    if diff:
        with mx.autograd.record():
            outs = fn(*nds, **attrs, **extra)
    else:
        outs = fn(*nds, **attrs, **extra)
    outs = outs if isinstance(outs, list) else [outs]
    cts = []
    if diff:
        heads = [o for o in outs if np.issubdtype(o.asnumpy().dtype,
                                                  np.floating)]
        cts = [op_case_cotangent(h.shape, h.asnumpy().dtype, seed=1 + k)
               for k, h in enumerate(heads)]
        mx.autograd.backward(heads, [mx.nd.array(c, ctx=ctx, dtype=c.dtype)
                                     for c in cts])
    grads = {i: nds[i].grad.asnumpy() for i in diff}
    return ([o.asnumpy() for o in outs], grads,
            [n.asnumpy() for n in nds], cts)


def assert_op_case_close(case, got, want, tols=OP_TOL):
    """Raise unless two runs of a case (outputs, gradients, inputs after)
    agree: dtypes equal, values within the dtype's (rtol, atol) in
    `tols`, other dtypes exactly."""
    import numpy as np

    for what, g, w in (("output", got[0], want[0]),
                       ("grad", [got[1][i] for i in sorted(got[1])],
                        [want[1][i] for i in sorted(want[1])]),
                       ("input after", got[2], want[2])):
        check(len(g) == len(w), f"{case[0]}: {len(g)} {what}s vs {len(w)}")
        for k, (a, b) in enumerate(zip(g, w)):
            a, b = np.asarray(a), np.asarray(b)
            check(a.dtype == b.dtype and a.shape == b.shape,
                  f"{case[0]} {what} {k}: {a.dtype}{a.shape} vs "
                  f"{b.dtype}{b.shape}")
            rtol, atol = tols.get(str(a.dtype), (0, 0))
            ok = np.allclose(a.astype(np.float64), b.astype(np.float64),
                             rtol=rtol, atol=atol, equal_nan=True)
            if not ok:
                check(ok, f"{case[0]} {what} {k}: max err "
                      f"{np.abs(a.astype(np.float64) - b).max()} over rtol "
                      f"{rtol} atol {atol}")


def dropout_keep_rate(mx, ctx, n=200, p=0.5):
    """Check a training-mode Dropout on ctx: its kept share within five
    standard deviations of 1 - p, kept values scaled by 1 / (1 - p), the
    gradient the same mask, and a mask shared along ``axes``. Returns the
    kept share."""
    import numpy as np

    x = mx.nd.ones((n, n), ctx=ctx)
    x.attach_grad()
    with mx.autograd.record():
        y = mx.nd.Dropout(x, p=p)
    y.backward()
    out, grad = y.asnumpy(), x.grad.asnumpy()
    keep = 1.0 - p
    kept = float((out != 0).mean())
    sigma = math.sqrt(keep * p / out.size)
    check(abs(kept - keep) <= 5 * sigma,
          f"Dropout on {ctx} kept {kept}, want {keep} +- {5 * sigma}")
    check(np.all((out == 0) | (out == 1 / keep)), "Dropout scale")
    check(np.array_equal(grad, out), "Dropout gradient is not its mask")
    with mx.autograd.train_mode():
        z = mx.nd.Dropout(mx.nd.ones((4, n), ctx=ctx), p=p,
                          axes=(0,)).asnumpy()
    check(np.all(z == z[:1]), "Dropout axes: mask not shared along axis 0")
    return kept


# The random ops' statistics (slice 13): draws of each distribution on a
# device, their mean and variance against the closed form within
# RANDOM_SE standard errors (of the mean: sqrt(var / n); of the variance:
# sqrt((m4 - var^2) / n), from the draws' fourth moment).
RANDOM_DRAWS = 10 ** 6
RANDOM_SE = 5.0
# (op, parameter arrays (one distribution a row) or None, attrs,
#  [(mean, variance)] a row)
RANDOM_MOMENTS = {
    "_random_uniform": (None, {"low": -1.0, "high": 3.0}, [(1.0, 16 / 12)]),
    "_random_normal": (None, {"loc": 1.0, "scale": 2.0}, [(1.0, 4.0)]),
    "_random_gamma": (None, {"alpha": 2.0, "beta": 0.5}, [(1.0, 0.5)]),
    "_random_exponential": (None, {"lam": 2.0}, [(0.5, 0.25)]),
    "_random_poisson": (None, {"lam": 3.0}, [(3.0, 3.0)]),
    "_random_negative_binomial": (None, {"k": 3, "p": 0.4},
                                  [(4.5, 11.25)]),
    "_random_generalized_negative_binomial": (
        None, {"mu": 2.0, "alpha": 0.5}, [(2.0, 4.0)]),
    "_random_randint": (None, {"low": -2, "high": 5}, [(1.0, 4.0)]),
    "_sample_uniform": ([[-1.0, 0.0], [1.0, 4.0]], {},
                        [(0.0, 4 / 12), (2.0, 16 / 12)]),
    "_sample_normal": ([[0.0, 5.0], [1.0, 0.5]], {},
                       [(0.0, 1.0), (5.0, 0.25)]),
    "_sample_gamma": ([[1.0, 3.0], [2.0, 0.5]], {},
                      [(2.0, 4.0), (1.5, 0.75)]),
    "_sample_exponential": ([[1.0, 4.0]], {}, [(1.0, 1.0), (0.25, 0.0625)]),
    "_sample_poisson": ([[2.0, 7.0]], {}, [(2.0, 2.0), (7.0, 7.0)]),
    "_sample_negative_binomial": ([[2.0, 5.0], [0.5, 0.3]], {},
                                  [(2.0, 4.0), (35 / 3, 350 / 9)]),
    "_sample_generalized_negative_binomial": (
        [[1.0, 3.0], [0.2, 1.0]], {}, [(1.0, 1.2), (3.0, 12.0)]),
}


def random_moments(mx, ctx, name, n=RANDOM_DRAWS):
    """Check one distribution's draws on ctx (`RANDOM_MOMENTS`); returns
    [(mean, variance)] a row, measured."""
    import numpy as np

    params, attrs, want = RANDOM_MOMENTS[name]
    fn = getattr(mx.nd.op, name)
    if params is None:
        draws = fn(shape=(n,), ctx=ctx, **attrs).asnumpy()[None]
    else:
        draws = fn(*[mx.nd.array(p, ctx=ctx) for p in params],
                   shape=(n // len(want),), **attrs).asnumpy()
    check(draws.dtype == (np.int32 if name == "_random_randint"
                          else np.float32), f"{name}: dtype {draws.dtype}")
    if name == "_random_randint":
        check(draws.min() >= attrs["low"] and draws.max() < attrs["high"],
              f"randint on {ctx}: a draw outside [low, high)")
    got = []
    for row, (mean, var) in zip(draws.astype(np.float64), want):
        m, v = row.mean(), row.var()
        se_var = math.sqrt(max(((row - m) ** 4).mean() - v * v, 0.0)
                           / row.size)
        check(abs(m - mean) <= RANDOM_SE * math.sqrt(var / row.size)
              and abs(v - var) <= RANDOM_SE * se_var,
              f"{name} on {ctx}: mean {m} variance {v}, want {mean} {var} "
              f"within {RANDOM_SE} standard errors")
        got.append((float(m), float(v)))
    return got


def random_draw_checks(mx, ctx, n=RANDOM_DRAWS):
    """Check the random ops' draws on ctx: each distribution's moments
    (`random_moments`), multinomial frequencies within RANDOM_SE standard
    errors and its ``get_prob`` the log-probability of each draw,
    ``shuffle`` a permutation, and zipfian draws distinct in range with
    the CPU's tries. Returns the measured moments."""
    import numpy as np

    out = {name: random_moments(mx, ctx, name, n) for name in RANDOM_MOMENTS}
    p = np.array([[0.2, 0.3, 0.5]], np.float32)
    idx, lp = mx.nd.random.multinomial(mx.nd.array(p, ctx=ctx), shape=(n,),
                                       get_prob=True)
    idx, lp = idx.asnumpy()[0], lp.asnumpy()[0]
    check(idx.dtype == np.int32, f"multinomial dtype {idx.dtype}")
    freq = np.bincount(idx, minlength=3) / n
    check(np.all(np.abs(freq - p[0]) <= RANDOM_SE * np.sqrt(
        p[0] * (1 - p[0]) / n)), f"multinomial on {ctx}: {freq}")
    check(np.allclose(lp, np.log(p[0])[idx], rtol=1e-5, atol=1e-6),
          "multinomial get_prob is not the draws' log-probability")
    out["_sample_multinomial"] = freq.tolist()
    perm = mx.nd.shuffle(mx.nd.arange(n, ctx=ctx)).asnumpy()
    check(np.array_equal(np.sort(perm), np.arange(n, dtype=perm.dtype))
          and not np.array_equal(perm, np.arange(n)),
          f"shuffle on {ctx} is not a permutation")
    samples, tries = mx.nd.op._sample_unique_zipfian(
        range_max=1000, shape=(4, 50), ctx=ctx)
    samples, tries = samples.asnumpy(), tries.asnumpy()
    check(all(len(set(r)) == 50 for r in samples) and samples.min() >= 0
          and samples.max() < 1000, "zipfian draws repeat or leave range")
    _, cpu_tries = mx.nd.op._sample_unique_zipfian(range_max=1000,
                                                    shape=(4, 50),
                                                    ctx=mx.cpu())
    check(np.array_equal(tries, cpu_tries.asnumpy()),
          f"zipfian tries {tries} on {ctx}, {cpu_tries.asnumpy()} on cpu")
    out["_sample_unique_zipfian_tries"] = tries.tolist()
    return out


def _random_draws(F, x):
    """Every random op of the frontend once, inside a hybrid block's
    function: the ``_random_*`` by number parameters, the ``_sample_*``
    one distribution a row of ``x``, multinomial, shuffle, zipfian."""
    ones = F.ones_like(x)
    s = (3,)
    zipf, tries = F.op._sample_unique_zipfian(range_max=50, shape=(2, 4))
    return [F.random.uniform(-1, 1, shape=s), F.random.normal(0, 1, shape=s),
            F.random.gamma(2.0, 1.0, shape=s),
            F.random.exponential(2.0, shape=s),
            F.random.poisson(3.0, shape=s),
            F.random.negative_binomial(3, 0.4, shape=s),
            F.random.generalized_negative_binomial(2.0, 0.5, shape=s),
            F.random.randint(0, 9, shape=s),
            F.random.uniform(x, x + 1), F.random.normal(x, ones),
            F.random.gamma(ones * 2, ones), F.random.exponential(ones),
            F.random.poisson(ones * 3),
            F.random.negative_binomial(ones * 2, ones * 0.5),
            F.random.generalized_negative_binomial(ones, ones * 0.5),
            F.random.multinomial(F.softmax(x)), F.random.shuffle(x), zipf,
            tries]


def random_in_graph(mx, ctx, calls=3):
    """The random ops in a hybridized block on ctx (on a card, captured in
    its CUDA graph with the device's generator): every call draws anew
    (the continuous draws all change), the shapes and dtypes are an eager
    call's, ``shuffle`` permutes its rows and the zipfian tries equal an
    eager call's. Returns the count of outputs a call."""
    import numpy as np

    x = np.random.RandomState(0).uniform(-1, 1, (4, 5)).astype(np.float32)
    with ctx:
        xs = mx.nd.array(x)
        eager = [o.asnumpy() for o in _random_draws(mx.nd, xs)]
        net = mx.gluon.nn.HybridLambda(_random_draws)
        net.hybridize()
        runs = [[o.asnumpy() for o in net(xs)] for _ in range(calls)]
    for run in runs:
        check([(o.shape, o.dtype) for o in run]
              == [(o.shape, o.dtype) for o in eager],
              f"random ops in a graph on {ctx}: shapes or dtypes differ")
        check(sorted(map(tuple, run[16])) == sorted(map(tuple, x)),
              f"shuffle in a graph on {ctx} is not a permutation")
        check(np.array_equal(run[18], eager[18]),
              f"zipfian tries in a graph on {ctx}: {run[18]}, eager "
              f"{eager[18]}")
    continuous = (0, 1, 2, 3, 8, 9, 10, 11)
    for a, b in zip(runs, runs[1:]):
        check(all(not np.array_equal(a[i], b[i]) for i in continuous),
              f"random ops in a graph on {ctx} repeat a call's draws")
    return len(eager)


def nd_train(torch, mx, ctx, dtype, units, widths, classes, batch, size,
             steps, warmup=0, seed=0):
    """`steps` + `warmup` SGD steps of `resnet50_v1_nd` on ctx from the
    weights and batch of `seed`; returns the arrays, losses, step seconds
    and host seconds (the time to enqueue a step) of the steps after the
    warm-up, and the FLOP of one step's convolutions and FullyConnected,
    forward and backward (3 x the forward's)."""
    import numpy as np

    params, aux = resnet50_v1_init(seed, units=units, widths=widths,
                                   classes=classes)
    x, label = resnet50_v1_batch(seed + 1, batch, size, classes)
    ps, moms, auxs, xs, labels = resnet50_v1_arrays(mx, ctx, params, aux, x,
                                                    label, dtype)
    arch = {"units": units, "widths": widths}
    flop = []
    resnet50_v1_nd(mx, ps, auxs, xs, labels, flop=flop, **arch)  # counts
    for k, v in aux.items():  # that forward moved no stat: predict mode
        check(np.array_equal(auxs[k].asnumpy(), v), f"{k} moved")
    on_card = ctx.device_type == "gpu"
    losses, seconds, host = [], [], []
    first_grads = None
    for i in range(warmup + steps):
        t0 = time.perf_counter()
        loss = resnet50_v1_nd_step(mx, ps, moms, auxs, xs, labels, **arch)
        t1 = time.perf_counter()
        if on_card:
            torch.cuda.synchronize()
        t2 = time.perf_counter()
        if i == 0:
            first_grads = {k: p.grad.copy() for k, p in ps.items()}
        if i >= warmup:
            seconds.append(t2 - t0)
            host.append(t1 - t0)
        losses.append(float(loss.asscalar()))
    return {"params": ps, "aux": auxs, "aux_init": aux, "moms": moms,
            "losses": losses, "step_s": seconds, "host_s": host,
            "first_grads": first_grads, "flop": 3 * sum(flop),
            "one_more_step": lambda: resnet50_v1_nd_step(
                mx, ps, moms, auxs, xs, labels, **arch)}


def nd_full_width(torch, mx, dtype, smi):
    """Check (a) and the measurement at one dtype: batch 32 at 224 x 224,
    1000 classes, 2 warm-up steps and 5 timed. Returns the line and a
    function that takes one more step."""
    import numpy as np

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run = nd_train(torch, mx, mx.gpu(0), dtype, RESNET50_UNITS,
                   RESNET50_WIDTHS, ND_CLASSES, ND_BATCH, ND_SIZE, ND_STEPS,
                   warmup=ND_WARMUP)
    peak = torch.cuda.max_memory_allocated()
    # (a): finite loss and gradients, every moving stat moved
    check(all(math.isfinite(v) for v in run["losses"]),
          f"nd {dtype}: non-finite loss {run['losses']}")
    finite = torch.stack([torch.isfinite(g._data).all()
                          for g in run["first_grads"].values()])
    check(bool(finite.all()), f"nd {dtype}: a non-finite gradient")
    unmoved = [k for k, v in run["aux"].items()
               if np.array_equal(v.asnumpy(), run["aux_init"][k])]
    check(not unmoved, f"nd {dtype}: moving stats unchanged: {unmoved}")
    step_ms = statistics.median(run["step_s"]) * 1e3
    host_ms = statistics.median(run["host_s"]) * 1e3
    bound_ms = run["flop"] / PEAK_FLOPS[dtype] * 1e3
    return {"dtype": dtype, "batch": ND_BATCH, "image": ND_SIZE,
            "classes": ND_CLASSES, "params": sum(
                p.size for p in run["params"].values()),
            "losses": run["losses"], "step_ms": [s * 1e3 for s in
                                                 run["step_s"]],
            "median_step_ms": step_ms, "img_per_s": ND_BATCH / step_ms * 1e3,
            "median_host_ms": host_ms,
            "step_flop": run["flop"], "bound_ms": bound_ms,
            "bound_by": "operations", "bound_share": bound_ms / step_ms,
            "peak_mem_gb": peak / 1e9, "card": smi}, run["one_more_step"]


def nd_small_card_vs_cpu(torch, mx):
    """Check (b): the small fp32 version stepped twice on the card and on
    the CPU from the same weights and batch."""
    import numpy as np

    arch = {k: ND_SMALL[k] for k in ("units", "widths", "classes", "batch",
                                     "size")}
    runs = [nd_train(torch, mx, ctx, "float32", steps=2, **arch)
            for ctx in (mx.gpu(0), mx.cpu())]
    card, cpu = runs
    worst = 0.0
    pairs = [("loss", np.asarray(card["losses"]), np.asarray(cpu["losses"]))]
    for group in ("params", "aux", "moms"):
        pairs += [(f"{group} {k}", v.asnumpy(), cpu[group][k].asnumpy())
                  for k, v in card[group].items()]
    pairs += [(f"grad {k}", v.grad.asnumpy(),
               cpu["params"][k].grad.asnumpy())
              for k, v in card["params"].items()]
    for what, a, b in pairs:
        err = float(np.abs(a - b).max())
        worst = max(worst, err)
        check(np.allclose(a, b, **ND_SMALL_TOL),
              f"nd small card vs CPU: {what} max err {err} over "
              f"{ND_SMALL_TOL}")
    return {"arch": ND_SMALL, "losses_card": card["losses"],
            "losses_cpu": cpu["losses"], "compared": len(pairs),
            "max_abs_err": worst, "tol": ND_SMALL_TOL}


def assert_random_case_alike(case, got, want):
    """Raise unless two runs of a random op's case give outputs of the
    same shapes and dtypes and leave the inputs as they were."""
    import numpy as np

    check(len(got[0]) == len(want[0]), f"{case[0]}: output counts")
    for a, b in zip(got[0], want[0]):
        check(a.shape == b.shape and a.dtype == b.dtype,
              f"{case[0]}: {a.dtype}{a.shape} vs {b.dtype}{b.shape}")
    for a, b in zip(got[2], want[2]):
        check(np.array_equal(a, b), f"{case[0]}: an input changed")


def image_random_in_range(case, got):
    """Raise unless a random image op's output (`port_op_case`'s result)
    is one its transform can reach from the input: a flip the input or its
    mirror; brightness, contrast and saturation between their blends at
    the two factors; the hue rotation keeping each pixel's luma; the
    lighting one constant shift a channel within 10 standard deviations;
    the colour jitter finite."""
    import numpy as np

    name, attrs = case[1], case[3]
    out = got[0][0].astype(np.float64)
    x = got[2][0].astype(np.float64)
    luma = np.array([0.299, 0.587, 0.114])
    gray = (x * luma).sum(-1, keepdims=True)
    lo, hi = attrs.get("min_factor"), attrs.get("max_factor")
    if "flip" in name:
        axis = x.ndim - (2 if "left_right" in name else 3)
        ok = np.array_equal(out, x) or np.array_equal(out, np.flip(x, axis))
    elif "brightness" in name or "contrast" in name or \
            "saturation" in name:
        if "brightness" in name:
            other = np.zeros_like(gray)
        elif "contrast" in name:
            other = gray.mean(axis=(-3, -2, -1), keepdims=True)
        else:
            other = gray
        ends = [a * x + (1 - a) * other for a in (lo, hi)]
        slack = 1e-4 * (1 + np.abs(x))
        ok = bool(np.all(out >= np.minimum(*ends) - slack)
                  and np.all(out <= np.maximum(*ends) + slack))
    elif "hue" in name:
        ok = np.allclose((out * luma).sum(-1, keepdims=True), gray,
                         rtol=1e-4, atol=1e-2)
    elif "lighting" in name:
        shift = (out - x).reshape(-1, x.shape[-1])
        reach = 10 * attrs["alpha_std"] * (np.abs(
            np.array([[-0.5675, 0.7192, 0.4009], [-0.5808, -0.0045, -0.814],
                      [-0.5836, -0.6948, 0.4203]]))
            @ np.array([55.46, 4.794, 1.148]))
        ok = np.allclose(shift, shift[0], atol=1e-3) and \
            bool(np.all(np.abs(shift[0]) <= reach))
    else:
        ok = bool(np.all(np.isfinite(out)))
    check(ok, f"{case[0]}: an output its transform cannot reach")


def nd_ops_card_vs_cpu(mx):
    """Check (c): every case of the op table, forward and backward, on the
    card against the CPU (the random ops' by shape and dtype, the random
    image ops' by their range too; the host codec ops, `HOST_OPS`, left
    out); Dropout's training mode by its statistics on both; and the
    random ops' draws by theirs (`random_draw_checks`, 10^6 draws a
    distribution)."""
    cases = [c for c in op_cases() if c[1] not in HOST_OPS]
    for case in cases:
        arrays = op_case_arrays(case)
        got, want = (port_op_case(mx, case, arrays, ctx)
                     for ctx in (mx.gpu(0), mx.cpu()))
        if case[1] in RANDOM_OPS:
            assert_random_case_alike(case, got, want)
            if case[1] in IMAGE_RANDOM_OPS:
                image_random_in_range(case, got)
                image_random_in_range(case, want)
        else:
            assert_op_case_close(case, got, want)
    kept = {str(ctx): dropout_keep_rate(mx, ctx)
            for ctx in (mx.gpu(0), mx.cpu())}
    mx.random.seed(0)
    draws = {str(ctx): random_draw_checks(mx, ctx)
             for ctx in (mx.gpu(0), mx.cpu())}
    names = {case[1] for case in cases}
    return {"cases": len(cases), "ops": len(names),
            "host_ops_left_out": len(HOST_OPS),
            "random_ops": len(names & RANDOM_OPS),
            "with_grad": sum(1 for c in cases if op_case_grad_inputs(c)),
            "dropout_kept": kept, "random_draws": draws,
            "random_outputs_in_a_graph": random_in_graph(mx, mx.gpu(0)),
            "random_bound": f"{RANDOM_SE} standard errors of "
                            f"{RANDOM_DRAWS} draws", "tol": OP_TOL}


def nd_phase(torch, smi):
    """Slice 6's path: a ResNet-50 v1 train step written with `mx.nd` and
    `mx.autograd` (`resnet50_v1_nd`), at full width in fp32 (TF32 off) and
    in bf16; then checks (b) and (c). (d): no kernel launches. Returns the
    line and {dtype: a function that takes one more step}."""
    import mxnet_tpu_torch as mx

    reset_launches()
    full, more = [], {}
    for dtype in ("float32", "bfloat16"):
        line, more[dtype] = nd_full_width(torch, mx, dtype, smi)
        full.append(line)
    launches = read_launches()
    check(not any(launches.values()),
          f"the nd path launched kernels: {launches}")
    return {"full_width": full, "kernel_launches": launches,
            "small_card_vs_cpu": nd_small_card_vs_cpu(torch, mx),
            "ops_card_vs_cpu": nd_ops_card_vs_cpu(mx)}, more


# --- the gluon phase (slice 7): model zoo, hybridize, NDArrayIter, Trainer -

GLUON_BATCHES = 4  # batches an epoch, bench.py:597
GLUON_EPOCHS = 1 + 2  # one warm-up epoch (the captures), two timed
GLUON_OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}  # :614-616
# the small fp32 model of checks (b) and (c) and of the CPU test: ResNet v1
# with one bottleneck unit in each of two stages, batch 4 at 32 x 32
GLUON_SMALL = {"layers": [1, 1], "channels": [8, 16, 32], "classes": 10,
               "batch": 4, "size": 32, "batches": 2}
# fused against aggregated updates: the bounds of the JAX package's
# `test_aggregated_sgd_matches_sequential` (test_optimizer.py:149)
GLUON_UPDATE_TOL = {"rtol": 1e-6, "atol": 1e-6}


def fused_env(fused):
    """`MXNET_FUSED_STEP` set to ``fused`` for the block."""
    return env_scope({"MXNET_FUSED_STEP": "1" if fused else "0"})


def gluon_train(mx, net_fn, data, label, *, dtype, batch, epochs,
                fused=True, ctx=None, params_file=None, hybridize=True,
                hook=None):
    """`bench.py:584-652`'s `_measure_framework` loop, written only against
    the package `mx` it is given (`mxnet_tpu` or `mxnet_tpu_torch`): the
    net from ``net_fn()``, initialized with `mx.init.Xavier()` (then loaded
    from ``params_file`` if given), hybridized with ``static_alloc`` and
    cast to ``dtype``; an `NDArrayIter` over ``data`` and ``label``
    (unshuffled); a hybridized `SoftmaxCrossEntropyLoss`; the SGD `Trainer`
    (lr 0.1, momentum 0.9, wd 1e-4, multi-precision unless fp32); then
    ``epochs`` epochs of `record()` / `backward()` / `trainer.step(batch)`.
    ``fused`` sets `MXNET_FUSED_STEP` for the run; everything is made on
    ``ctx`` (default: the current context). ``hook(what, epoch, net)``, if
    given, is called with ``"begin"`` before each step and ``"end"`` after
    its `trainer.step`. Returns the net, the trainer, the loss block, the
    iterator and each step's loss array."""
    with fused_env(fused), ctx or mx.current_context():
        net = net_fn()
        net.initialize(mx.init.Xavier(), ctx=ctx)
        if params_file is not None:
            net.load_parameters(params_file, ctx=mx.current_context())
        if hybridize:
            net.hybridize(static_alloc=True)
        if dtype != "float32":
            net.cast(dtype)
        train_iter = mx.io.NDArrayIter(data, label, batch_size=batch,
                                       shuffle=False)
        sce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        if hybridize:
            sce.hybridize()
        trainer = mx.gluon.Trainer(
            net.collect_params(), "sgd",
            dict(GLUON_OPT, multi_precision=dtype != "float32"))
        losses = []
        for epoch in range(epochs):
            train_iter.reset()
            for b in train_iter:
                if hook is not None:
                    hook("begin", epoch, net)
                x = b.data[0]
                y = b.label[0]
                if dtype != "float32":
                    x = x.astype(dtype)
                with mx.autograd.record():
                    out = net(x)
                    loss = sce(out, y)
                loss.backward()
                trainer.step(batch)
                losses.append(loss)
                if hook is not None:
                    hook("end", epoch, net)
    return {"net": net, "trainer": trainer, "loss_fn": sce,
            "iter": train_iter, "losses": losses}


def gluon_small_net(mx):
    """``net_fn`` of the small model: ResNet v1 with `BottleneckV1`."""
    vision = mx.gluon.model_zoo.vision
    return lambda: vision.ResNetV1(
        vision.BottleneckV1, GLUON_SMALL["layers"], GLUON_SMALL["channels"],
        classes=GLUON_SMALL["classes"])


def gluon_batches(seed, n, size, classes):
    """``n`` images uniform in [-1, 1) and labels as float32 indices, from
    `numpy.random.RandomState(seed)`, drawn as `bench.py:601-604` draws
    them."""
    import numpy as np

    rng = np.random.RandomState(seed)
    data = rng.uniform(-1, 1, (n, 3, size, size)).astype(np.float32)
    label = rng.randint(0, classes, (n,)).astype(np.float32)
    return data, label


def gluon_state(run):
    """numpy copies of a `gluon_train` run: each step's loss (per sample),
    each parameter by structural name (moving stats included), and each
    momentum by the same name."""
    net, trainer = run["net"], run["trainer"]
    params = net._collect_params_with_prefix()
    order = sorted(net.collect_params().keys())
    full = net.collect_params()
    structural = {id(p): k for k, p in params.items()}
    updater = getattr(trainer, "_updater", None) or trainer._updaters[0]
    moms = {}
    for i, name in enumerate(order):
        state = updater.states.get(i)
        if state is not None:
            state = state[0] if isinstance(state, tuple) else state
            moms[structural[id(full[name])]] = _to_numpy(state)
    return {"losses": [loss.asnumpy() for loss in run["losses"]],
            "params": {k: p.data().asnumpy() for k, p in params.items()},
            "moms": moms}


def _to_numpy(x):
    import numpy as np

    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    return np.asarray(x.detach().float().cpu().numpy())


def resnet50_v1_step_flop():
    """The FLOP of one ResNet-50 v1 train step at batch 32 x 224²: 3 x the
    forward's convolutions and FullyConnected, counted by `resnet50_v1_nd`
    from the shapes on meta tensors (740.7 GFLOP)."""
    import mxnet_tpu_torch as mx
    import torch

    params, aux = resnet50_v1_shapes()
    meta = {k: mx.nd.NDArray(torch.empty(v, device="meta"))
            for k, v in {**params, **aux}.items()}
    flop = []
    x = mx.nd.NDArray(torch.empty((ND_BATCH, 3, ND_SIZE, ND_SIZE),
                                  device="meta"))
    label = mx.nd.NDArray(torch.empty((ND_BATCH,), device="meta"))
    resnet50_v1_nd(mx, {k: meta[k] for k in params},
                   {k: meta[k] for k in aux}, x, label, flop=flop)
    return 3 * sum(flop)


def gluon_full_width(torch, mx, dtype, smi, flop):
    """Checks (a) and (d) and the measurement at one dtype: the model
    zoo's `resnet50_v1(classes=1000)` through `gluon_train`, batch 32 at
    224², 4 batches an epoch, one warm-up epoch (the captures) and two
    timed, each step paced by reading an updated weight
    (`bench.py:626-650`). Returns the line, a function that takes one
    more step, and the run's `Trainer`."""
    import numpy as np
    from mxnet_tpu_torch.compile_cache import named_stats

    data, label = gluon_batches(0, ND_BATCH * GLUON_BATCHES, ND_SIZE,
                                ND_CLASSES)
    times = {"begin": [], "end": [], "read": [], "epoch": [],
             "programs": []}

    def hook(what, epoch, net):
        if what == "begin":
            if len(times["epoch"]) == epoch:
                times["epoch"].append(epoch)
                times["programs"].append(named_stats("cached_op")["misses"])
            times["begin"].append((epoch, time.perf_counter()))
            return
        times["end"].append(time.perf_counter())
        # reading a weight the step's update wrote waits for the whole step
        next(iter(net.collect_params().values())).data()._data \
            .reshape(-1)[0].item()
        times["read"].append(time.perf_counter())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    run = gluon_train(mx, lambda: mx.gluon.model_zoo.vision.resnet50_v1(
        classes=ND_CLASSES), data, label, dtype=dtype, batch=ND_BATCH,
        epochs=GLUON_EPOCHS, ctx=mx.gpu(0), hook=hook)
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    programs = times["programs"] + [named_stats("cached_op")["misses"]]
    captured = [b - a for a, b in zip(programs, programs[1:])]
    warm = [i for i, (e, _) in enumerate(times["begin"]) if e == 0]
    timed = [i for i, (e, _) in enumerate(times["begin"]) if e > 0]
    capture_s = times["read"][warm[-1]] - t0
    step_s = [times["read"][i] - times["begin"][i][1] for i in timed]
    host_s = [times["end"][i] - times["begin"][i][1] for i in timed]
    net = run["net"]
    params = net.collect_params()
    # (a): finite losses and gradients, every moving stat moved
    losses = [float(np.mean(loss.asnumpy())) for loss in run["losses"]]
    check(all(math.isfinite(v) for v in losses),
          f"gluon {dtype}: non-finite loss {losses}")
    finite = torch.stack([torch.isfinite(p.grad()._data).all()
                          for p in params.values() if p.grad_req != "null"])
    check(bool(finite.all()), f"gluon {dtype}: a non-finite gradient")
    unmoved = [k for k, p in params.items()
               if k.endswith(("running_mean", "running_var"))
               and np.array_equal(p.data().asnumpy(), np.full(
                   p.shape, 1.0 if k.endswith("var") else 0.0))]
    check(not unmoved, f"gluon {dtype}: moving stats unchanged: {unmoved}")
    # (d): the warm-up epoch captures, the later epochs capture nothing
    check(captured[0] > 0 and not any(captured[1:]),
          f"gluon {dtype}: programs captured by epoch {captured}")
    step_ms = statistics.median(step_s) * 1e3
    bound_ms = flop / PEAK_FLOPS[dtype] * 1e3
    graphs = net._cached_op.graphs + run["loss_fn"]._cached_op.graphs
    run["iter"].reset()
    first = run["iter"].next()
    return {"dtype": dtype, "batch": ND_BATCH, "image": ND_SIZE,
            "classes": ND_CLASSES,
            "params": sum(p.data().size for p in params.values()
                          if p.grad_req != "null"),
            "losses": losses, "step_ms": [s * 1e3 for s in step_s],
            "median_step_ms": step_ms, "img_per_s": ND_BATCH / step_ms * 1e3,
            "median_host_ms": statistics.median(host_s) * 1e3,
            "capture_s": capture_s, "programs_by_epoch": captured,
            "graphs": graphs, "wall_s": wall_s,
            "step_flop": flop, "bound_ms": bound_ms,
            "bound_by": "operations", "bound_share": bound_ms / step_ms,
            "peak_mem_gb": peak / 1e9, "held_before_gb": held / 1e9,
            "card": smi}, lambda: gluon_one_step(mx, run, first, dtype), \
        run["trainer"]


def gluon_one_step(mx, run, batch, dtype):
    """One more training step of a `gluon_train` run on ``batch``."""
    x, y = batch.data[0], batch.label[0]
    if dtype != "float32":
        x = x.astype(dtype)
    with mx.autograd.record():
        loss = run["loss_fn"](run["net"](x), y)
    loss.backward()
    run["trainer"].step(x.shape[0])
    return loss


def gluon_small_runs(mx, params_file, **kw):
    """`gluon_state` of the small model trained one epoch (two steps) from
    ``params_file``, fp32, for each ``name: (ctx, options)`` in ``kw``."""
    small = GLUON_SMALL
    data, label = gluon_batches(0, small["batch"] * small["batches"],
                                small["size"], small["classes"])
    return {name: gluon_state(gluon_train(
        mx, gluon_small_net(mx), data, label, dtype="float32",
        batch=small["batch"], epochs=1, ctx=ctx, params_file=params_file,
        **opts)) for name, (ctx, opts) in kw.items()}


def gluon_compare(what, got, want, tol):
    """Raise unless two `gluon_state`s agree within ``tol``; returns the
    count of arrays compared and the largest error."""
    import numpy as np

    pairs = [(f"loss {i}", a, b) for i, (a, b) in
             enumerate(zip(got["losses"], want["losses"]))]
    for group in ("params", "moms"):
        check(sorted(got[group]) == sorted(want[group]),
              f"{what}: {group} names differ")
        pairs += [(f"{group} {k}", v, want[group][k])
                  for k, v in got[group].items()]
    worst = 0.0
    for name, a, b in pairs:
        err = float(np.abs(a - b).max())
        worst = max(worst, err)
        check(np.allclose(a, b, **tol),
              f"{what}: {name} max err {err} over {tol}")
    return {"compared": len(pairs), "max_abs_err": worst}


def gluon_dropout(mx, ctx, calls=3, p=0.5):
    """A hybridized Dense + Dropout called under `record()` ``calls`` times
    on ctx (on a card: replays of one captured graph). Raises unless each
    call keeps its share within five standard deviations of 1 - p and no
    two calls draw the same mask; returns the shares."""
    import numpy as np

    with ctx:
        net = mx.gluon.nn.HybridSequential()
        net.add(mx.gluon.nn.Dense(64, in_units=64), mx.gluon.nn.Dropout(p))
        net.initialize(mx.init.One(), ctx=ctx)
        net.hybridize()
        x = mx.nd.ones((32, 64))
        masks = []
        for _ in range(calls):
            with mx.autograd.record():
                y = net(x)
            y.backward()
            masks.append(y.asnumpy() != 0)
    kept = [float(m.mean()) for m in masks]
    sigma = math.sqrt(p * (1 - p) / masks[0].size)
    check(all(abs(k - (1 - p)) <= 5 * sigma for k in kept),
          f"Dropout on {ctx} kept {kept}")
    check(all(not np.array_equal(a, b) for i, a in enumerate(masks)
              for b in masks[i + 1:]), f"Dropout on {ctx} repeated a mask")
    return kept


def gluon_checks(mx, workdir):
    """Checks (b), (c) and (e) on the small model: its weights from one
    Xavier initialization on the CPU, saved with `save_parameters` and
    loaded by every run; and Dropout's masks in a replayed graph."""
    small = GLUON_SMALL
    params_file = os.path.join(workdir, "gluon_small.params")
    with mx.cpu():
        net = gluon_small_net(mx)()
        net.initialize(mx.init.Xavier(), ctx=mx.cpu())
        net(mx.nd.zeros((1, 3, small["size"], small["size"])))
        net.save_parameters(params_file)
    card = mx.gpu(0)
    # (b): hybridized on the card, eager on the card, on the CPU
    runs = gluon_small_runs(mx, params_file, card=(card, {}),
                            card_eager=(card, {"hybridize": False}),
                            cpu=(mx.cpu(), {}))
    b = {"card_vs_cpu": gluon_compare("gluon small card vs CPU",
                                      runs["card"], runs["cpu"],
                                      ND_SMALL_TOL),
         "hybrid_vs_eager": gluon_compare(
             "gluon small hybridized vs eager on the card", runs["card"],
             runs["card_eager"], ND_SMALL_TOL)}
    # (c): the aggregated multi_sgd_mom_update path (which rebinds the
    # weights, so the graphs copy them in) against the fused update
    upd = gluon_small_runs(mx, params_file, fused=(card, {}),
                           aggregated=(card, {"fused": False}))
    c = gluon_compare("gluon fused vs aggregated update", upd["aggregated"],
                      upd["fused"], GLUON_UPDATE_TOL)
    # (e): Accuracy of the same predictions on the card and on the CPU
    data, label = gluon_batches(1, 64, small["size"], small["classes"])
    acc = {}
    for ctx in (card, mx.cpu()):
        with ctx:
            net = gluon_small_net(mx)()
            net.load_parameters(params_file, ctx=ctx)
            net.hybridize()
            metric = mx.metric.Accuracy()
            metric.update([mx.nd.array(label)], [net(mx.nd.array(data))])
            acc[str(ctx)] = metric.get()[1]
    check(len(set(acc.values())) == 1, f"Accuracy card vs CPU: {acc}")
    return {"small": small, "b": b, "c": dict(c, tol=GLUON_UPDATE_TOL),
            "accuracy": acc, "tol": ND_SMALL_TOL,
            "dropout_kept": gluon_dropout(mx, card)}


def gluon_update_forms(torch, trainer):
    """`SGD.fused_update`'s two forms on the card, over the parameters,
    gradients and momenta of a full-width fp32 gluon run's ``trainer``:
    with floats, as the gluon `Trainer` passes them, and with a device
    tensor written from pinned memory, as the Module's captured step reads
    them (`fused_hyper_slots`). Raises unless both write the same weights
    and momenta within `GLUON_UPDATE_TOL`. Returns each form's device time
    a call (`cuda_ms`, the tensor's copy included) and one call's time
    with its host time (`call_ms`), and {"update_<form>": a function that
    makes one more call}, for `--profile`'s host launch calls."""
    from mxnet_tpu_torch.optimizer.optimizer import (fused_hyper_args,
                                                     fused_hyper_slots)

    opt = trainer._optimizer
    idx = [i for i, p in enumerate(trainer._params) if p.grad_req != "null"]
    weights = [trainer._params[i].list_data()[0]._data.detach() for i in idx]
    grads = [trainer._params[i].list_grad()[0]._data.detach() for i in idx]
    lrs, wds = opt._fused_hyperparams(idx)
    groups, values = fused_hyper_slots(lrs, wds)
    values.append(opt.rescale_grad)
    copies = {form: ([w.clone() for w in weights],
                     [trainer._updater.states[i].clone() for i in idx])
              for form in ("float", "tensor")}

    def call(form):
        ws, moms = copies[form]
        if form == "float":
            opt.fused_update(ws, grads, moms, lrs, wds, opt.rescale_grad)
            return
        hyper = torch.tensor(values, dtype=torch.float32).pin_memory().to(
            weights[0].device, non_blocking=True)
        opt.fused_update(ws, grads, moms, *fused_hyper_args(hyper, groups),
                         groups=groups)

    for form in copies:
        call(form)
    errs = [float((a - b).abs().max())
            for group in (0, 1) for a, b in zip(copies["float"][group],
                                                copies["tensor"][group])]
    check(all(torch.allclose(a, b, **GLUON_UPDATE_TOL)
              for group in (0, 1) for a, b in zip(copies["float"][group],
                                                  copies["tensor"][group])),
          f"fused_update's float and tensor forms differ by {max(errs)}")
    out = {"params": sum(w.numel() for w in weights),
           "max_abs_err": max(errs), "tol": GLUON_UPDATE_TOL}
    for form in copies:
        out[f"{form}_ms"] = cuda_ms(lambda: call(form))
        out[f"{form}_call_ms"] = call_ms(lambda: call(form))
    return out, {f"update_{form}": lambda form=form: call(form)
                 for form in copies}


def gluon_phase(torch, smi, workdir):
    """Slice 7's path: `gluon_train` on the model zoo's ResNet-50 v1 at full
    width in fp32 (TF32 off) and bf16, then checks (b), (c) and (e) on the
    small model. (f): no kernel launches. Then `gluon_update_forms` on the
    fp32 run's trainer. Returns the line and {dtype or update form: a
    function that takes one more step}."""
    import mxnet_tpu_torch as mx

    flop = resnet50_v1_step_flop()
    reset_launches()
    full, more, trainers = [], {}, {}
    for dtype in ("float32", "bfloat16"):
        line, more[dtype], trainers[dtype] = gluon_full_width(
            torch, mx, dtype, smi, flop)
        full.append(line)
    launches = read_launches()
    check(not any(launches.values()),
          f"the gluon path launched kernels: {launches}")
    forms, form_steps = gluon_update_forms(torch, trainers["float32"])
    return {"full_width": full, "kernel_launches": launches,
            **gluon_checks(mx, workdir), "update_forms": forms}, \
        {**more, **form_steps}


MODULE_BATCHES = 4  # batches an epoch, bench.py:705
MODULE_EPOCHS = 1 + 2  # one warm-up epoch (the capture), two timed
MODULE_OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}  # :717-719
# the small fp32 model of checks (b)-(f) and of the CPU test: the symbolic
# ResNet with one unit in each of four stages and the ImageNet stem, batch 4
MODULE_SMALL = {"units": [1, 1, 1, 1], "num_stages": 4,
                "filter_list": [8, 16, 32, 64, 128], "num_classes": 10,
                "image_shape": (3, 64, 64), "batch": 4}
# captured against eager steps: `test_fused_step.py:116`'s bounds
MODULE_FUSED_TOL = {"rtol": 3e-5, "atol": 3e-6}
# (c) with Adam (slice 13): its fused update in the captured step
MODULE_ADAM_OPT = {"learning_rate": 0.01, "beta1": 0.5, "wd": 1e-4}
MODULE_NOISE_INITS = 6  # sets of weights the noise reading draws


def module_train(mx, sym_fn, data, label, *, batch, epochs, fused,
                 ctx=None, arg_params=None, aux_params=None, hook=None,
                 optimizer_params=None, optimizer="sgd"):
    """`bench.py:684-768`'s `_measure_module` loop, written only against
    the package `mx` it is given (`mxnet_tpu` or `mxnet_tpu_torch`): a
    `mx.mod.Module` over ``sym_fn()`` bound to an `NDArrayIter` over
    ``data`` and ``label`` (unshuffled), its parameters from
    `mx.init.Xavier()` or from ``arg_params`` / ``aux_params`` (numpy
    arrays by name), SGD (lr 0.1, momentum 0.9, wd 1e-4, unless
    ``optimizer`` and ``optimizer_params`` say otherwise); then ``epochs``
    epochs of
    ``if not mod.fused_step(b): mod.forward_backward(b); mod.update()``,
    each step paced by reading a weight its update wrote. ``fused`` sets
    `MXNET_FUSED_STEP` for the run; everything is made on ``ctx``
    (default: the current context). ``hook(what, epoch, mod)``, if given,
    is called with ``"begin"`` before each step, ``"end"`` after it is
    enqueued and ``"read"`` after the read. Returns the module, the
    iterator and each step's first output (a copy)."""
    hook = hook or (lambda what, epoch, mod: None)
    with fused_env(fused), ctx or mx.current_context():
        ctx = mx.current_context()
        mod = mx.mod.Module(sym_fn(), context=ctx)
        train_iter = mx.io.NDArrayIter(data, label, batch_size=batch,
                                       shuffle=False)
        mod.bind(data_shapes=train_iter.provide_data,
                 label_shapes=train_iter.provide_label)
        if arg_params is None:
            mod.init_params(mx.init.Xavier())
        else:
            mod.init_params(
                arg_params={k: mx.nd.array(v)
                            for k, v in arg_params.items()},
                aux_params={k: mx.nd.array(v)
                            for k, v in (aux_params or {}).items()})
        mod.init_optimizer(optimizer=optimizer, optimizer_params=tuple(
            (optimizer_params or MODULE_OPT).items()))
        paced = mod._exec.arg_dict[mod._param_names[-1]]
        outputs = []
        for epoch in range(epochs):
            train_iter.reset()
            for b in train_iter:
                hook("begin", epoch, mod)
                if not mod.fused_step(b):
                    mod.forward_backward(b)
                    mod.update()
                hook("end", epoch, mod)
                paced.asnumpy()  # waits for the step's update
                hook("read", epoch, mod)
                outputs.append(mod.get_outputs()[0].copy())
    return {"mod": mod, "iter": train_iter, "outputs": outputs}


def module_small_sym(mx):
    """``sym_fn`` of the small model, from the package's own
    `models.resnet`."""
    import importlib

    resnet = importlib.import_module(mx.__name__ + ".models.resnet")
    keys = ("units", "num_stages", "filter_list", "num_classes",
            "image_shape")
    return lambda: resnet.resnet(**{k: MODULE_SMALL[k] for k in keys})


def module_state(run):
    """numpy copies of a `module_train` run: each step's first output, the
    arguments and aux states by name, and each optimizer state by its
    parameter's name (a state of several tensors, Adam's mean and var, as
    ``name 0``, ``name 1``)."""
    mod = run["mod"]
    arg, aux = mod.get_params()
    moms = {}
    for i, name in enumerate(mod._param_names):
        state = mod._updater.states.get(i)
        if isinstance(state, tuple):
            moms.update({f"{name} {j}": _to_numpy(t)
                         for j, t in enumerate(state) if t is not None})
        elif state is not None:
            moms[name] = _to_numpy(state)
    return {"outputs": [o.asnumpy() for o in run["outputs"]],
            "params": {k: v.asnumpy() for k, v in {**arg, **aux}.items()},
            "moms": moms}


def module_errors(what, got, want, tol):
    """[(name, max abs err, within ``tol``)] of two `module_state`s: each
    step's output, then every array and momentum by name."""
    import numpy as np

    check(len(got["outputs"]) == len(want["outputs"]),
          f"{what}: {len(got['outputs'])} steps against "
          f"{len(want['outputs'])}")
    pairs = [(f"output {i}", a, b) for i, (a, b) in
             enumerate(zip(got["outputs"], want["outputs"]))]
    for group in ("params", "moms"):
        check(sorted(got[group]) == sorted(want[group]),
              f"{what}: {group} names differ")
        pairs += [(f"{group} {k}", v, want[group][k])
                  for k, v in got[group].items()]
    return [(name, float(np.abs(a - b).max()), bool(np.allclose(a, b, **tol)))
            for name, a, b in pairs]


def module_compare(what, got, want, tol):
    """Raise unless two `module_state`s agree within ``tol``; returns the
    count of arrays compared and the largest error."""
    errs = module_errors(what, got, want, tol)
    for name, err, ok in errs:
        check(ok, f"{what}: {name} max err {err} over {tol}")
    return {"compared": len(errs), "max_abs_err": max(e for _, e, _ in errs)}


def module_spread(what, got, want, tol):
    """How far two `module_state`s part, as a reading that never raises:
    the largest error, where, and how many arrays leave ``tol``."""
    errs = module_errors(what, got, want, tol)
    name, err, _ = max(errs, key=lambda e: e[1])
    return {"max_abs_err": err, "at": name,
            "outside_tol": sum(not ok for *_, ok in errs)}


def symbol_forward_flop(sym, shapes):
    """The FLOP of one forward of ``sym`` at the input ``shapes``: its
    convolutions (plain or folded with a BatchNorm by ``TPU_FUSE``) and
    FullyConnected, from the shapes that `infer_shape` gives every node's
    output (matched by node, not by name: an exported gluon graph names
    many nodes alike)."""
    import numpy as np

    internals = sym.get_internals()
    _, out_shapes, _ = internals.infer_shape(**shapes)
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    arg_of = dict(zip(sym.list_arguments(), arg_shapes))
    flop = 0
    for (node, index), out in zip(internals._outputs, out_shapes):
        if index or node.op not in ("Convolution", "_fused_conv_bn_relu",
                                    "FullyConnected"):
            continue
        w = arg_of[node.inputs[1][0].name]
        if node.op == "FullyConnected":
            flop += 2 * out[0] * int(np.prod(w))
        else:
            flop += 2 * int(np.prod(out)) * int(np.prod(w[1:]))
    return flop


def symbol_step_flop(sym, shapes):
    """The FLOP of one train step of ``sym`` at the input ``shapes``: 3 x
    its forward's (`symbol_forward_flop`)."""
    return 3 * symbol_forward_flop(sym, shapes)


def module_fixed_params(sym):
    """The parameters the graph never changes: the gammas of BatchNorms
    with ``fix_gamma`` (zero gradient; no weight decay off ``_weight``)."""
    graph = json.loads(sym.tojson())
    return {graph["nodes"][node["inputs"][1][0]]["name"]
            for node in graph["nodes"] if node["op"] == "BatchNorm"
            and node.get("attrs", {}).get("fix_gamma") == "True"}


def module_full_width(torch, mx, smi, fused):
    """The measurement: `module_train` on `resnet50_symbol(1000, (3, 224,
    224))`, batch 32 at 224², 4 batches an epoch, one warm-up epoch and two
    timed, fused (the captured step) or eager; with checks (a) and, for
    the fused run, (e)'s no capture after the warm-up epoch. Returns the
    line and a function that takes one more step."""
    import numpy as np
    from mxnet_tpu_torch.compile_cache import named_stats
    from mxnet_tpu_torch.models.resnet import resnet50_symbol

    data, label = gluon_batches(0, ND_BATCH * MODULE_BATCHES, ND_SIZE,
                                ND_CLASSES)
    times = {"begin": [], "end": [], "read": [], "programs": []}
    init = {}

    def hook(what, epoch, mod):
        if not init:  # the weights before the first step
            arg, aux = mod.get_params()
            init.update({k: v.asnumpy() for k, v in {**arg, **aux}.items()})
        now = time.perf_counter()
        if what == "begin":
            if len(times["programs"]) == epoch:
                times["programs"].append(named_stats("executor")["misses"])
            times["begin"].append((epoch, now))
        else:
            times[what].append(now)

    def sym_fn():
        return resnet50_symbol(num_classes=ND_CLASSES,
                               image_shape=(3, ND_SIZE, ND_SIZE))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    run = module_train(mx, sym_fn, data, label, batch=ND_BATCH,
                       epochs=MODULE_EPOCHS, fused=fused, ctx=mx.gpu(0),
                       hook=hook)
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    mod = run["mod"]
    programs = times["programs"] + [named_stats("executor")["misses"]]
    captured = [b - a for a, b in zip(programs, programs[1:])]
    warm = [i for i, (e, _) in enumerate(times["begin"]) if e == 0]
    timed = [i for i, (e, _) in enumerate(times["begin"]) if e > 0]
    step_s = [times["read"][i] - times["begin"][i][1] for i in timed]
    host_s = [times["end"][i] - times["begin"][i][1] for i in timed]
    what = "fused" if fused else "eager"
    # (a): finite outputs; every weight and moving stat moved
    outs = run["outputs"]
    check(all(bool(np.isfinite(o.asnumpy()).all()) for o in outs),
          f"module {what}: a non-finite output")
    arg, aux = mod.get_params()
    fixed = module_fixed_params(mod.symbol)
    unmoved = [k for k, v in {**arg, **aux}.items() if k not in fixed
               and np.array_equal(v.asnumpy(), init[k])]
    check(not unmoved, f"module {what}: arrays unchanged: {unmoved}")
    check(all(k.endswith("gamma") for k in fixed),
          f"module {what}: fixed parameters {fixed}")
    graphs = sum(s.captures for s in mod._exec._steps.values())
    if fused:
        check(captured[0] == 1 and not any(captured[1:]) and graphs == 1,
              f"module fused: steps captured by epoch {captured}, "
              f"graphs {graphs}")
    else:
        check(not any(captured), f"module eager: captured {captured}")
    step_ms = statistics.median(step_s) * 1e3
    flop = symbol_step_flop(mod.symbol, {"data": (ND_BATCH, 3, ND_SIZE,
                                                  ND_SIZE),
                                         "softmax_label": (ND_BATCH,)})
    bound_ms = flop / PEAK_FLOPS["float32"] * 1e3
    run["iter"].reset()
    first = run["iter"].next()

    def one_more_step():
        with fused_env(fused):
            if not mod.fused_step(first):
                mod.forward_backward(first)
                mod.update()
        return mod.get_outputs()[0]

    return {"path": what, "dtype": "float32", "batch": ND_BATCH,
            "image": ND_SIZE, "classes": ND_CLASSES,
            "params": sum(v.size for v in arg.values()),
            "fixed_params": sorted(fixed),
            "step_ms": [s * 1e3 for s in step_s],
            "median_step_ms": step_ms, "img_per_s": ND_BATCH / step_ms * 1e3,
            "median_host_ms": statistics.median(host_s) * 1e3,
            "capture_s": times["read"][warm[-1]] - t0,
            "programs_by_epoch": captured, "graphs": graphs,
            "wall_s": wall_s, "step_flop": flop, "bound_ms": bound_ms,
            "bound_by": "operations", "bound_share": bound_ms / step_ms,
            "peak_mem_gb": peak / 1e9, "held_before_gb": held / 1e9,
            "card": smi}, one_more_step


def module_small_init(mx):
    """The small model's Xavier weights, drawn once on the CPU: numpy
    (arg_params, aux_params)."""
    with mx.cpu():
        mod = mx.mod.Module(module_small_sym(mx)(), context=mx.cpu())
        shape = (MODULE_SMALL["batch"],) + tuple(MODULE_SMALL["image_shape"])
        mod.bind(data_shapes=[("data", shape)],
                 label_shapes=[("softmax_label", (MODULE_SMALL["batch"],))])
        mod.init_params(mx.init.Xavier())
        arg, aux = mod.get_params()
    return ({k: v.asnumpy() for k, v in arg.items()},
            {k: v.asnumpy() for k, v in aux.items()})


def module_small_batches(seed, n):
    return gluon_batches(seed, n, MODULE_SMALL["image_shape"][1],
                         MODULE_SMALL["num_classes"])


def module_small_run(mx, ctx, init, n, *, fused=True, opt=None, seed=0,
                     optimizer="sgd"):
    data, label = module_small_batches(seed, n)
    return module_train(mx, module_small_sym(mx), data, label,
                        batch=MODULE_SMALL["batch"], epochs=1, fused=fused,
                        ctx=ctx, arg_params=init[0], aux_params=init[1],
                        optimizer_params=opt, optimizer=optimizer)


def module_adam_run(mx, ctx, fused, steps=5):
    """``steps`` Adam steps (`MODULE_ADAM_OPT`) of `bench.py`'s MLP
    (`serve_mlp_symbol`) from Xavier weights drawn on the CPU after seed 0.
    An MLP, not the small ResNet: Adam divides each step by the root of
    its second moment, so a parameter whose gradient nearly cancels (the
    ResNet's first BatchNorm gamma, ~1e-5) takes a step of ~lr whatever
    the sign of its rounding noise, and captured and eager part by ~lr
    there however exact the update is."""
    import numpy as np

    m = SERVE_MLP
    arg, _ = serve_mlp_module(mx, mx.cpu(), seed=0).get_params()
    rng = np.random.RandomState(5)
    n = steps * m["batch"]
    data = rng.uniform(-1, 1, (n, m["dim"])).astype(np.float32)
    label = rng.randint(0, m["classes"], n).astype(np.float32)
    return module_train(mx, lambda: serve_mlp_symbol(mx), data, label,
                        batch=m["batch"], epochs=1, fused=fused, ctx=ctx,
                        arg_params={k: v.asnumpy() for k, v in arg.items()},
                        optimizer="adam", optimizer_params=MODULE_ADAM_OPT)


def module_dropout(mx, ctx, steps=3, p=0.5):
    """A symbol with Dropout trained ``steps`` fused steps at lr 0 (on a
    card: replays of one captured graph): the outputs differ from step to
    step, so each replay drew a new mask. Returns the fraction of entries
    that changed between consecutive steps."""
    import numpy as np

    def sym_fn():
        data = mx.sym.Variable("data")
        drop = mx.sym.Dropout(data, p=p)
        fc = mx.sym.FullyConnected(drop, num_hidden=8, name="fc")
        return mx.sym.SoftmaxOutput(fc, name="softmax")

    x = np.ones((16, 32), dtype=np.float32)
    y = np.zeros((16,), dtype=np.float32)
    run = module_train(mx, sym_fn, x, y, batch=16, epochs=steps, fused=True,
                       ctx=ctx, optimizer_params={"learning_rate": 0.0})
    outs = [o.asnumpy() for o in run["outputs"]]
    changed = [float(np.mean(a != b)) for a, b in zip(outs, outs[1:])]
    check(all(c > 0.5 for c in changed),
          f"Dropout in the fused step on {ctx} repeated masks: {changed}")
    return changed


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms for the block. Its default ones
    differ run to run by ~1e-6 on the small model (the weight gradients),
    and the model's gradient jumps where a max-pool or ReLU switches, so
    that noise can grow past the bounds of the checks that compare five
    steps of two paths (`module_noise` reads how far); with them, two runs
    of one path are bit-equal."""
    import torch

    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def module_small_sched_opt(mx):
    """Check (d)'s optimizer: `MODULE_OPT` under a `FactorScheduler` whose
    rate halves after every two updates."""
    return dict(MODULE_OPT, lr_scheduler=mx.lr_scheduler.FactorScheduler(
        step=2, factor=0.5))


def module_noise(mx, card, n):
    """Why (c) and (d) run under cuDNN's deterministic algorithms. At each
    of `MODULE_NOISE_INITS` more sets of Xavier weights, (d)'s epoch of
    ``n`` rows with cuDNN's default algorithms, captured once and eager
    twice: how far capture parts the results from eager, and how far the
    algorithms' run-to-run noise parts two eager runs (readings, which
    never raise); then captured and eager with the deterministic
    algorithms, which must agree within `MODULE_FUSED_TOL`."""
    def state(init, fused):
        return module_state(module_small_run(
            mx, card, init, n, fused=fused, opt=module_small_sched_opt(mx)))

    rows = []
    for _ in range(MODULE_NOISE_INITS):
        init = module_small_init(mx)
        captured, eager, again = (state(init, fused)
                                  for fused in (True, False, False))
        with cudnn_deterministic():
            det = module_compare(
                "module small captured vs eager, deterministic, noise",
                state(init, True), state(init, False), MODULE_FUSED_TOL)
        rows.append({
            "captured_vs_eager": module_spread(
                "noise", captured, eager, MODULE_FUSED_TOL),
            "eager_vs_eager": module_spread(
                "noise", eager, again, MODULE_FUSED_TOL),
            "deterministic_captured_vs_eager": det})
    return rows


def module_checks(mx, workdir):
    """Checks (b)-(f) on the small model, from one set of Xavier weights
    drawn on the CPU; (c) and (d) with cuDNN's deterministic algorithms;
    then the noise reading (`module_noise`)."""
    import numpy as np
    from mxnet_tpu_torch.compile_cache import named_stats

    card, cpu = mx.gpu(0), mx.cpu()
    init = module_small_init(mx)
    # (b): two captured steps on the card, with cuDNN's default
    # algorithms, against two on the CPU
    b = module_compare("module small card vs CPU",
                       module_state(module_small_run(mx, card, init, 8)),
                       module_state(module_small_run(mx, cpu, init, 8)),
                       ND_SMALL_TOL)
    # (c), (d): one epoch of five steps, captured against eager
    # (MXNET_FUSED_STEP=0), at a fixed rate and under a FactorScheduler
    n = 5 * MODULE_SMALL["batch"]
    with cudnn_deterministic():
        c = module_compare(
            "module small captured vs eager",
            module_state(module_small_run(mx, card, init, n)),
            module_state(module_small_run(mx, card, init, n, fused=False)),
            MODULE_FUSED_TOL)
        sched_runs = {fused: module_small_run(
            mx, card, init, n, fused=fused, opt=module_small_sched_opt(mx))
            for fused in (True, False)}
        d = module_compare("module small captured vs eager, FactorScheduler",
                           module_state(sched_runs[True]),
                           module_state(sched_runs[False]), MODULE_FUSED_TOL)
        # slice 13: Adam's fused update, its bias-corrected rate read from
        # the device at each replay; one capture for the five steps
        adam_runs = {fused: module_adam_run(mx, card, fused)
                     for fused in (True, False)}
        adam = module_compare("module MLP captured vs eager, Adam",
                              module_state(adam_runs[True]),
                              module_state(adam_runs[False]),
                              MODULE_FUSED_TOL)
    steps = adam_runs[True]["mod"]._exec._steps
    check(steps.misses == 1 and steps.hits == 4,
          f"module Adam: {steps.misses} captures, {steps.hits} replays")
    adam.update(captures=steps.misses, replays=steps.hits)
    d["lr_after"] = sched_runs[True]["mod"]._optimizer.lr_scheduler(
        sched_runs[True]["mod"]._optimizer.num_update)
    # (e): a short last batch pads into the captured graph: 5 rows in an
    # iterator of batch 4 (the iterator pads), then a 1-row DataBatch
    # (the module pads)
    before = named_stats("executor")["misses"]
    run = module_small_run(mx, card, init, 5)
    mod = run["mod"]
    after_iter = named_stats("executor")["misses"] - before
    x, y = module_small_batches(3, 1)
    with card:
        mod.fused_step(mx.io.DataBatch([mx.nd.array(x)], [mx.nd.array(y)]))
    short_rows = mod.get_outputs()[0].shape[0]
    after_short = named_stats("executor")["misses"] - before
    check(after_iter == 1 and after_short == 1 and short_rows == 1,
          f"module short batch: captures {after_iter} then {after_short}, "
          f"{short_rows} output rows")
    # (f): a checkpoint saved on the card, loaded on the CPU
    prefix = os.path.join(workdir, "module_small")
    mod.save_checkpoint(prefix, 1)
    with open(prefix + "-symbol.json") as f:
        text = f.read()
    check(text == mod.symbol.tojson(), "module checkpoint: symbol text")
    xs, ys = module_small_batches(4, MODULE_SMALL["batch"])
    fwd = {}
    for ctx, m in ((card, mod), (cpu, None)):
        with ctx:
            if m is None:
                m = mx.mod.Module.load(prefix, 1, context=cpu)
                m.bind(data_shapes=mod.data_shapes,
                       label_shapes=mod.label_shapes, for_training=False)
                check(m.symbol.tojson() == text,
                      "module checkpoint: loaded symbol text")
            m.forward(mx.io.DataBatch([mx.nd.array(xs)], [mx.nd.array(ys)]),
                      is_train=False)
            fwd[str(ctx)] = m.get_outputs()[0].asnumpy()
    err = float(np.abs(fwd[str(card)] - fwd[str(cpu)]).max())
    check(err <= 1e-4, f"module checkpoint: forward differs by {err}")
    return {"small": MODULE_SMALL, "b": dict(b, tol=ND_SMALL_TOL),
            "c": dict(c, tol=MODULE_FUSED_TOL),
            "d": dict(d, tol=MODULE_FUSED_TOL),
            "c_adam": dict(adam, optimizer=MODULE_ADAM_OPT,
                           tol=MODULE_FUSED_TOL),
            "e": {"captures_5_rows_in_batch_4": after_iter,
                  "captures_after_1_row_batch": after_short,
                  "output_rows": short_rows},
            "f": {"forward_max_abs_err": err, "symbol_bytes": len(text)},
            "dropout_changed": module_dropout(mx, card),
            "noise": module_noise(mx, card, n)}


def module_phase(torch, smi, workdir, profile=False):
    """Slice 8's path: `module_train` on the symbolic ResNet-50 at full
    width, fused (one captured CUDA graph a step) and eager, then checks
    (b)-(f) on the small model. (g): no kernel launches. Returns the line
    and, when ``profile``, the profiles of one more step of each path,
    taken before the small model's ~20 captures (after them, the first
    profiled replay of the full-width graph crashed: ROADMAP C.4)."""
    import mxnet_tpu_torch as mx

    reset_launches()
    full, more = [], {}
    for fused in (True, False):
        line, more["fused" if fused else "eager"] = module_full_width(
            torch, mx, smi, fused)
        full.append(line)
    launches = read_launches()
    check(not any(launches.values()),
          f"the module path launched kernels: {launches}")
    profiles = {f"module_{path}": profile_step(torch, step, must_run=(
        "convolution", "batchnorm")) for path, step in more.items()} \
        if profile else {}
    return {"full_width": full, "kernel_launches": launches,
            **module_checks(mx, workdir)}, profiles


# --- the serve phase (slice 9): Predictor, DynamicBatcher, rollout --------

SERVE_CLIENTS = 4  # closed-loop clients, bench.py:1163
SERVE_REQS = 200  # requests a client on an accelerator, bench.py:1164-1165
SERVE_SIZES = (1, 2, 3, 5, 8, 11)  # rows a request, cycled, bench.py:1166
SERVE_WAIT_MS = 1.0  # the batcher's flush deadline, bench.py:1196
SERVE_SWAP_AT = (0.3, 0.65)  # shares of completions where the swaps fire
SERVE_PROBE_ROWS = 3  # the fixed request read after each swap
# bench.py's own probe: the 64 -> 128 -> 8 MLP Module bound at batch 8
SERVE_MLP = {"dim": 64, "hidden": 128, "classes": 8, "batch": 8,
             "buckets": (2, 4, 8, 16)}
# the small ResNet v1 of checks (d) and (e) and of the CPU test: the gluon
# phase's small model at 32 x 32, a two-wide ladder
SERVE_SMALL = {"size": 32, "buckets": (2, 4)}
# batcher against direct: the same request, maybe in another bucket
SERVE_TOL = {"rtol": 1e-5, "atol": 1e-6}
# the least standard deviation of a served model's outputs over the rows
# and classes of the payloads: below it the output hardly depends on the
# input, and no comparison of two such outputs can fail
SERVE_MIN_STD = 1e-2


def serve_mlp_symbol(mx):
    """`bench.py:1152-1157`'s symbol."""
    m = SERVE_MLP
    with mx.name.NameManager():
        data = mx.sym.Variable("data")
        fc1 = mx.sym.FullyConnected(data, num_hidden=m["hidden"], name="fc1")
        act = mx.sym.Activation(fc1, act_type="relu")
        fc2 = mx.sym.FullyConnected(act, num_hidden=m["classes"], name="fc2")
        return mx.sym.SoftmaxOutput(fc2, name="softmax")


def serve_mlp_module(mx, ctx, seed=None, params=None):
    """`bench.py:1158-1161`'s Module, bound for inference on ``ctx``, its
    weights Xavier (after ``mx.random.seed(seed)`` when given) or
    ``params`` (numpy arrays by name)."""
    m = SERVE_MLP
    with ctx:
        mod = mx.mod.Module(serve_mlp_symbol(mx), context=ctx)
        mod.bind([("data", (m["batch"], m["dim"]))],
                 [("softmax_label", (m["batch"],))], for_training=False)
        if params is None:
            if seed is not None:
                mx.random.seed(seed)
            mod.init_params(mx.init.Xavier())
        else:
            mod.init_params(arg_params={k: mx.nd.array(v)
                                        for k, v in params.items()})
    return mod


def numpy_params(pair):
    """(arg_params, aux_params) of NDArrays as numpy arrays by name."""
    return tuple({k: v.asnumpy() for k, v in d.items()} for d in pair)


def serve_export(mx, net_fn, shape, prefix, seed, ctx):
    """A gluon net from ``net_fn()`` with Xavier weights drawn after
    ``mx.random.seed(seed)`` on ``ctx``, hybridized, called once on a
    1-row batch of ``shape`` and exported to ``prefix`` (epoch 0); returns
    the net."""
    with ctx:
        mx.random.seed(seed)
        net = net_fn()
        net.initialize(mx.init.Xavier(), ctx=ctx)
        net.hybridize()
        net(mx.nd.zeros((1,) + tuple(shape), ctx=ctx))
        net.export(prefix, 0)
    return net


def draw_moving_stats(aux, seed):
    """BatchNorm moving statistics for the aux arrays ``aux`` (numpy by
    name), drawn in name order from `RandomState(seed)`: means uniform on
    [-0.1, 0.1), variances on [0.5, 1.5). The fold's scale and shift are
    then far from the identity while a deep net's activations stay alive:
    means well above 0 before every ReLU cut a ResNet's output to a
    constant."""
    import numpy as np

    rng = np.random.RandomState(seed)
    return {k: rng.uniform(*((0.5, 1.5) if k.endswith("var")
                             else (-0.1, 0.1)),
                           aux[k].shape).astype(np.float32)
            for k in sorted(aux)}


def serve_draw_stats(mx, path, seed):
    """Rewrite the moving statistics in the params file ``path`` with
    `draw_moving_stats(..., seed)`. Returns (arg_params, aux_params) as
    numpy."""
    with mx.cpu():
        saved = {k: v.asnumpy() for k, v in mx.nd.load(path).items()}
        arg = {k[4:]: v for k, v in saved.items() if k.startswith("arg:")}
        aux = draw_moving_stats({k[4:]: v for k, v in saved.items()
                                 if k.startswith("aux:")}, seed)
        mx.nd.save(path, {**{"arg:" + k: mx.nd.array(v)
                             for k, v in arg.items()},
                          **{"aux:" + k: mx.nd.array(v)
                             for k, v in aux.items()}})
        mx.nd.load(path)  # the JAX package's writer is asynchronous
    return arg, aux


def serve_small_export(mx, prefix, seed=0):
    """The small ResNet v1 exported on the CPU, its BatchNorm moving stats
    then drawn by `serve_draw_stats` so that the fold uses them. Returns
    (arg_params, aux_params) as numpy."""
    size = SERVE_SMALL["size"]
    with mx.cpu():
        serve_export(mx, gluon_small_net(mx), (3, size, size), prefix,
                     seed, mx.cpu())
    return serve_draw_stats(mx, f"{prefix}-0000.params", seed)


def output_std(outs):
    """The standard deviation over the rows and classes of the outputs
    ``outs`` (numpy arrays of one width); a served output that does not
    depend on its input reads 0."""
    import numpy as np

    return float(np.concatenate(outs).std())


def serve_payloads(trail):
    """One payload a request size, uniform on [-1, 1) from
    `RandomState(0)` in size order, as `bench.py:1167-1169` draws them."""
    import numpy as np

    rng = np.random.RandomState(0)
    return {s: rng.uniform(-1, 1, (s,) + tuple(trail)).astype(np.float32)
            for s in sorted(set(SERVE_SIZES))}


def served_layout(pred, arg, aux):
    """A checkpoint's (arg, aux) moved into the predictor's layout: under
    ``TPU_FUSE`` BatchNorm's moving stats are arguments of the folded
    node (`Predictor.swap_weights` moves them the same way)."""
    arg, aux = dict(arg), dict(aux)
    for n in list(aux):
        if n in pred._arg_params and n not in arg:
            arg[n] = aux.pop(n)
    return arg, aux


def fresh_predictor(mx, pred, arg, aux):
    """A new Predictor over ``pred``'s symbol, inputs, ladder and context,
    with the weights ``arg`` / ``aux`` (``pred``'s layout)."""
    import importlib

    serving = importlib.import_module(mx.__name__ + ".serving")
    data = [(d.name, d.shape) for d in pred._data_descs]
    labels = [(n, (1,) + t) for n, t in pred._label_trails.items()]
    return serving.Predictor(pred._symbol, arg, aux, data_shapes=data,
                             label_shapes=labels, buckets=pred.buckets,
                             ctx=pred._ctx)


def serving_probe(mx, pred, weights_b, per_client=SERVE_REQS):
    """`bench.py:1132-1302`'s `_measure_serving` loop over ``pred``, written
    only against the package `mx` it is given (`mxnet_tpu` or
    `mxnet_tpu_torch`): `serving.warmup`, then `SERVE_CLIENTS` closed-loop
    clients of ``per_client`` requests each (sizes cycling `SERVE_SIZES`,
    payloads from `serve_payloads`) through a
    `DynamicBatcher(max_wait_ms=1.0)` after one warm-in request of each
    size; the same loop with two live `swap_weights`, to ``weights_b``
    (a checkpoint's numpy (arg, aux)) at 30 % of the completions and back
    to the weights ``pred`` started with at 65 %; and the same clients
    calling `Predictor.predict` directly.

    Checks, each raising: no build after warm-up, across all three loops;
    every batcher response equal to the same request through
    `Predictor.predict` within `SERVE_TOL`; after each swap, a fixed
    probe request bit-equal to a fresh Predictor's over that weight set;
    ``weights_version`` 2 at the end. Returns the numbers and the largest
    differences."""
    import importlib
    import threading

    import numpy as np

    serving = importlib.import_module(mx.__name__ + ".serving")
    trail = tuple(pred._data_descs[0].shape[1:])
    payloads = serve_payloads(trail)
    weights_a = numpy_params((pred._arg_params, pred._aux_params))
    weights_b = served_layout(pred, *weights_b)
    warm = serving.warmup(pred)
    misses_warm = pred.cache.misses
    refs = {s: pred.predict(p).asnumpy() for s, p in payloads.items()}
    total = SERVE_CLIENTS * per_client
    rows = sum(SERVE_SIZES[(k + i) % len(SERVE_SIZES)]
               for k in range(SERVE_CLIENTS) for i in range(per_client))
    lat = [[] for _ in range(SERVE_CLIENTS)]
    responses = {s: [] for s in payloads}
    fill = {"rows": 0, "slots": 0}

    def closed_loop(fn, record):
        errors = []

        def client(k):
            try:
                for i in range(per_client):
                    s = SERVE_SIZES[(k + i) % len(SERVE_SIZES)]
                    t = time.perf_counter()
                    out = fn(payloads[s])
                    if record:
                        lat[k].append(time.perf_counter() - t)
                        responses[s].append(out)
            except Exception as e:  # noqa: BLE001 — raised below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(SERVE_CLIENTS)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if errors:
            raise errors[0]
        return time.perf_counter() - t0

    dispatch = pred._run_dispatch

    def counted_dispatch(bucket, arrays):
        # the fill ratio: real rows over padded slots of each flush
        fill["rows"] += int(arrays[0].shape[0])
        fill["slots"] += bucket
        return dispatch(bucket, arrays)

    probe = payloads[SERVE_PROBE_ROWS]
    probes = []
    with serving.DynamicBatcher(pred, max_wait_ms=SERVE_WAIT_MS) as srv:
        for s in SERVE_SIZES:  # warm-in, untimed
            srv.predict(payloads[s])
        pred._run_dispatch = counted_dispatch
        try:
            wall = closed_loop(srv.predict, record=True)
        finally:
            del pred._run_dispatch
        stamps = []
        stamp_lock = threading.Lock()
        misses_preswap = pred.cache.misses

        def stamped_predict(x):
            srv.predict(x)
            with stamp_lock:
                stamps.append(time.perf_counter())

        def swapper():
            deadline = time.perf_counter() + 600
            for frac, weights in zip(SERVE_SWAP_AT, (weights_b, weights_a)):
                while time.perf_counter() < deadline:
                    with stamp_lock:
                        if len(stamps) >= total * frac:
                            break
                    time.sleep(0.002)
                t0 = time.perf_counter()
                pred.swap_weights(*weights)
                swap_s.append(time.perf_counter() - t0)
                probes.append(pred.predict(probe).asnumpy())

        swap_s = []
        sw = threading.Thread(target=swapper, daemon=True)
        sw.start()
        swap_wall = closed_loop(stamped_predict, record=False)
        sw.join()
        swap_misses = pred.cache.misses - misses_preswap
        win = max(0.1, swap_wall / 12.0)
        counts = {}
        for t in stamps:
            i = int((t - stamps[0]) / win)
            counts[i] = counts.get(i, 0) + 1
        n_win = max(max(counts), 1)
        per_win = [counts.get(i, 0) / win for i in range(n_win)]
        base = sorted(per_win)[len(per_win) // 2]
        dip_depth = max(0.0, 1.0 - min(per_win) / base) if base > 0 else 0.0
        dip_ms = (sum(win for r in per_win if r < 0.9 * base) * 1e3
                  if base > 0 else 0.0)
    misses_predirect = pred.cache.misses
    direct_wall = closed_loop(pred.predict, record=False)
    direct_misses = pred.cache.misses - misses_predirect
    steady = misses_preswap - misses_warm
    check(warm["compiles"] == len(pred.buckets),
          f"serve: warm-up built {warm['compiles']} programs for "
          f"{len(pred.buckets)} buckets")
    check(steady == 0 and swap_misses == 0 and direct_misses == 0,
          f"serve: builds after warm-up: {steady} in the timed loop, "
          f"{swap_misses} across the swaps, {direct_misses} direct")
    check(pred.weights_version == 2,
          f"serve: weights_version {pred.weights_version} after two swaps")
    # (b): every batcher response against the same request, direct
    errs = []
    for s, outs in responses.items():
        for out in outs:
            got = out.asnumpy()
            errs.append(float(np.abs(got - refs[s]).max()))
            check(np.allclose(got, refs[s], **SERVE_TOL),
                  f"serve: a batcher response of {s} rows differs from "
                  f"direct by {errs[-1]}")
    # (c): the probe after each swap against a fresh predictor's
    swap_errs = []
    for weights, got in zip((weights_b, weights_a), probes):
        want = fresh_predictor(mx, pred, *weights).predict(probe).asnumpy()
        swap_errs.append(float(np.abs(got - want).max()))
        check(np.array_equal(got, want),
              f"serve: the probe after a swap differs from a fresh "
              f"predictor's by {swap_errs[-1]}")
    all_lat = sorted(x for per in lat for x in per)
    return {"requests": total, "rows": rows, "clients": SERVE_CLIENTS,
            "buckets": list(pred.buckets),
            "req_per_s": total / wall, "img_per_s": rows / wall,
            "p50_ms": percentile_ms(all_lat, 50),
            "p99_ms": percentile_ms(all_lat, 99),
            "direct_req_per_s": total / direct_wall,
            "direct_img_per_s": rows / direct_wall,
            "cold_capture_s": warm["seconds"],
            "warmup_captures": warm["compiles"],
            "steady_state_captures": steady,
            "fill_ratio": fill["rows"] / max(fill["slots"], 1),
            "swap_req_per_s": total / swap_wall,
            "swap_dip_depth": dip_depth, "swap_dip_ms": dip_ms,
            "swap_s": swap_s, "swap_captures": swap_misses,
            "direct_captures": direct_misses,
            "weights_version": pred.weights_version,
            "batcher_vs_direct_max_abs_err": max(errs),
            "swap_probe_max_abs_err": max(swap_errs)}


def serve_graph(pred, bucket):
    """The captured forward of one bucket of ``pred``."""
    exec_ = pred._execs[bucket]
    return next(v for k, v in pred.cache._entries.items() if k[1] is exec_)


def serve_full_width(torch, mx, smi, workdir):
    """The measurement: the model zoo's `resnet50_v1(classes=1000)`, Xavier
    from seed 0, hybridized, exported, its moving stats drawn by
    `serve_draw_stats`, served by `Predictor.load` at the default ladder
    with ``TPU_FUSE`` through `serving_probe`; weights B are Xavier after
    ``mx.random.seed(99)`` with stats drawn from seed 99. Then each
    bucket's graph time against its FLOP bound and beside the graph of the
    same checkpoint served unfused (``MXNET_SUBGRAPH_BACKEND=NONE``), and
    check (b)'s second half: the direct responses against the unfused
    symbol's eager forward on the card, over outputs whose spread is at
    least `SERVE_MIN_STD`. Returns the line and the predictor."""
    import numpy as np

    vision = mx.gluon.model_zoo.vision
    prefix = os.path.join(workdir, "resnet50_v1")
    card = mx.gpu(0)
    shape = (3, ND_SIZE, ND_SIZE)
    data_shapes = [("data", (1,) + shape)]
    net = serve_export(mx, lambda: vision.resnet50_v1(classes=ND_CLASSES),
                       shape, prefix, 0, card)
    serve_draw_stats(mx, f"{prefix}-0000.params", 0)
    mx.random.seed(99)
    net.initialize(mx.init.Xavier(), ctx=card, force_reinit=True)
    sym = mx.sym.load(prefix + "-symbol.json")
    aux_names = set(sym.list_auxiliary_states())
    params = {k: v.data().asnumpy() for k, v in net.collect_params().items()}
    weights_b = ({k: v for k, v in params.items() if k not in aux_names},
                 draw_moving_stats({k: v for k, v in params.items()
                                    if k in aux_names}, 99))
    del net
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    pred = mx.serving.Predictor.load(prefix, 0, data_shapes=data_shapes)
    fused = sum(n.op == "_fused_conv_bn_relu" for n in pred._symbol._nodes())
    convs = sum(n.op == "Convolution" for n in sym._nodes())
    check(fused == convs == 53,
          f"serve: {fused} folded nodes for {convs} convolutions")
    line = serving_probe(mx, pred, weights_b)
    peak = torch.cuda.max_memory_allocated()
    with env_scope({"MXNET_SUBGRAPH_BACKEND": "NONE"}):
        plain = mx.serving.Predictor.load(prefix, 0, data_shapes=data_shapes)
    check("BatchNorm" in [n.op for n in plain._symbol._nodes()],
          "serve: NONE folded the BatchNorms")
    plain.warmup()
    per_bucket = []
    for b in pred.buckets:
        ms = cuda_ms(serve_graph(pred, b).graph.replay)
        unfused_ms = cuda_ms(serve_graph(plain, b).graph.replay)
        flop = symbol_forward_flop(sym, {"data": (b,) + shape})
        bound = flop / PEAK_FLOPS["float32"] * 1e3
        per_bucket.append({"bucket": b, "cuda_ms": ms,
                           "unfused_cuda_ms": unfused_ms,
                           "fused_over_unfused": ms / unfused_ms,
                           "flop": flop, "bound_ms": bound,
                           "bound_by": "operations",
                           "bound_share": bound / ms,
                           "img_per_s": b / ms * 1e3})
    del plain
    # (b), second half: direct responses against the unfused eager forward
    _, arg, aux = mx.model.load_checkpoint(prefix, 0)
    eager_errs, outs = [], []
    for s, x in serve_payloads(shape).items():
        args = {k: v.as_in_context(card) for k, v in arg.items()}
        args["data"] = mx.nd.array(x, ctx=card)
        ex = sym.bind(card, args=args, aux_states={
            k: v.as_in_context(card) for k, v in aux.items()},
            grad_req={"data": "write"})  # not all "null": the eager path
        want = ex.forward(is_train=False)[0].asnumpy()
        outs.append(pred.predict(x).asnumpy())
        err = float(np.abs(outs[-1] - want).max())
        eager_errs.append(err)
        check(err <= 1e-4, f"serve: {s} rows differ from the unfused "
              f"eager forward by {err}")
    std = output_std(outs)
    check(std >= SERVE_MIN_STD, f"serve: the outputs' spread is {std}")
    return {"model": "resnet50_v1", "classes": ND_CLASSES, "image": ND_SIZE,
            "dtype": "float32", "fused_nodes": fused, **line,
            "per_bucket": per_bucket,
            "fused_vs_eager_max_abs_err": max(eager_errs),
            "out_std": std, "peak_mem_gb": peak / 1e9,
            "held_before_gb": held / 1e9, "card": smi}, pred


def serve_traffic_window(mx, pred, per_client=10):
    """A function that serves a short window of batcher traffic (the
    profiled one): `SERVE_CLIENTS` closed-loop clients of ``per_client``
    requests through a new `DynamicBatcher`, closed at the end, so no
    worker replays a graph while the profiler starts or stops."""
    import threading

    payloads = serve_payloads(tuple(pred._data_descs[0].shape[1:]))

    def window():
        with mx.serving.DynamicBatcher(pred,
                                       max_wait_ms=SERVE_WAIT_MS) as srv:
            def client(k):
                for i in range(per_client):
                    srv.predict(payloads[SERVE_SIZES[(k + i)
                                                     % len(SERVE_SIZES)]])

            threads = [threading.Thread(target=client, args=(k,))
                       for k in range(SERVE_CLIENTS)]
            for th in threads:
                th.start()
            for th in threads:
                th.join()

    return window


def serve_mlp(mx):
    """`bench.py`'s own probe at its own size on the card: the MLP Module
    through ``as_predictor(buckets=(2, 4, 8, 16))`` and `serving_probe`;
    weights B Xavier after ``mx.random.seed(99)``."""
    card = mx.gpu(0)
    mod = serve_mlp_module(mx, card, seed=0)
    pred = mod.as_predictor(buckets=SERVE_MLP["buckets"])
    weights_b = numpy_params(serve_mlp_module(mx, card, seed=99)
                             .get_params())
    return {"model": "mlp", **SERVE_MLP, **serving_probe(mx, pred,
                                                         weights_b)}


def serve_card_vs_cpu(mx, workdir):
    """Check (d): the MLP and the small ResNet v1 (``TPU_FUSE``) served on
    the card and on the CPU from the same weights give the same outputs,
    within 1e-5 and 1e-4, and outputs whose spread is at least
    `SERVE_MIN_STD`."""
    import numpy as np

    params = numpy_params(serve_mlp_module(mx, mx.cpu(), seed=0)
                          .get_params())[0]
    preds = [serve_mlp_module(mx, ctx, params=params)
             .as_predictor(buckets=SERVE_MLP["buckets"])
             for ctx in (mx.gpu(0), mx.cpu())]
    prefix = os.path.join(workdir, "serve_small")
    serve_small_export(mx, prefix)
    size = SERVE_SMALL["size"]
    small = [mx.serving.Predictor.load(
        prefix, 0, data_shapes=[("data", (1, 3, size, size))],
        buckets=SERVE_SMALL["buckets"], ctx=ctx)
        for ctx in (mx.gpu(0), mx.cpu())]
    out = {}
    for what, pair, tol, trail in (
            ("mlp", preds, 1e-5, (SERVE_MLP["dim"],)),
            ("small_resnet", small, 1e-4, (3, size, size))):
        errs, outs = [], []
        for x in serve_payloads(trail).values():
            card_out, cpu_out = (p.predict(x).asnumpy() for p in pair)
            outs.append(card_out)
            errs.append(float(np.abs(card_out - cpu_out).max()))
            check(errs[-1] <= tol, f"serve {what}: card vs CPU {errs[-1]}")
        std = output_std(outs)
        check(std >= SERVE_MIN_STD,
              f"serve {what}: the outputs' spread is {std}")
        out[what] = {"max_abs_err": max(errs), "tol": tol, "out_std": std}
    return out, prefix


def serve_cold_bucket(mx, prefix):
    """Check (e): four threads hitting every bucket of an unwarmed
    predictor at once make one capture a bucket."""
    import threading

    import numpy as np

    size = SERVE_SMALL["size"]
    pred = mx.serving.Predictor.load(
        prefix, 0, data_shapes=[("data", (1, 3, size, size))],
        buckets=SERVE_SMALL["buckets"], ctx=mx.gpu(0))
    start = threading.Barrier(4)
    errors = []

    def client(k):
        try:
            start.wait(timeout=60)
            for b in pred.buckets[k % 2:] + pred.buckets[:k % 2]:
                pred.predict(np.ones((b, 3, size, size), np.float32))
        except Exception as e:  # noqa: BLE001 — raised below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    captures = sum(p.captures for p in pred.cache.values())
    check(pred.cache.misses == captures == len(pred.buckets),
          f"serve cold bucket: {pred.cache.misses} builds, {captures} "
          f"captures for {len(pred.buckets)} buckets")
    return {"threads": 4, "builds": pred.cache.misses, "captures": captures}


def serve_phase(torch, smi, workdir, profile=False):
    """Slice 9's path: `serve_full_width` and `serve_mlp`, checks (a)-(c)
    inside `serving_probe`; then check (d) (`serve_card_vs_cpu`), (e)
    (`serve_cold_bucket`) and (f): no kernel launches. Returns the line
    and, when ``profile``, the profile of a window of full-width batcher
    traffic, taken before the small checks."""
    import mxnet_tpu_torch as mx

    reset_launches()
    full, pred = serve_full_width(torch, mx, smi, workdir)
    mlp = serve_mlp(mx)
    launches = read_launches()
    check(not any(launches.values()),
          f"the serve path launched kernels: {launches}")
    profiles = {"serve_batcher": profile_step(
        torch, serve_traffic_window(mx, pred), must_run=("convolution",))} \
        if profile else {}
    del pred
    card_vs_cpu, prefix = serve_card_vs_cpu(mx, workdir)
    return {"full_width": full, "mlp": mlp, "kernel_launches": launches,
            "card_vs_cpu": card_vs_cpu,
            "cold_bucket": serve_cold_bucket(mx, prefix)}, profiles


OBS_BURST = 16                # sessions of each generation window
OBS_PREFIX_NEW = 16           # new tokens of each prefix session
OBS_SPEC_NEW = 32             # new tokens of each spec-burst session
OBS_SERVE_PER_CLIENT = 50     # SERVE_CLIENTS x 50 = 200 requests a window
OBS_MODULE_STEPS = 2          # fused steps of the module window
OBS_FLOP_TOL = 0.03           # counted FLOPs against the phase's own bound
OBS_PEAK_MARGIN = 1.05        # a measured peak above the sheet is an error
OBS_BUCKET_CALLS = 10         # bucket-32 forwards the serving row reads
OBS_TURNS = ("off", "on", "off", "on")  # the overhead reading's windows
# then one generate window with each plane alone: its share of the cost
OBS_PLANES = ("telemetry", "tracing", "health", "observatory")
SERVE_STAGES = ("serving.admission", "serving.queue", "serving.execute",
                "serving.reassembly")


def planes():
    from mxnet_tpu_torch import health, observatory, telemetry, tracing

    return telemetry, tracing, health, observatory


@contextlib.contextmanager
def planes_on():
    """Telemetry, tracing, health and the observatory on over fresh state
    for the block (as ``MXNET_TELEMETRY=1 MXNET_TRACING=1 MXNET_HEALTH=1
    MXNET_OBSERVATORY=1`` would start them); off and reset after, their
    threads stopped."""
    for plane in planes():
        plane.reset()
        plane.enable()
    try:
        yield
    finally:
        for plane in planes():
            plane.disable()
            plane.reset()


@contextlib.contextmanager
def planes_off(keep=None):
    """Every plane off for the block (the overhead reading's baseline) but
    the one named ``keep``, all back on after, their state kept."""
    for plane in planes():
        if plane.__name__.rsplit(".", 1)[-1] != keep:
            plane.disable()
    try:
        yield
    finally:
        for plane in planes():
            plane.enable()


def fresh_records():
    """Drop what the planes recorded so far (health's beacons stay)."""
    telemetry, tracing, _, observatory = planes()
    telemetry.reset()
    tracing.reset()
    observatory.reset()


def counter(name):
    from mxnet_tpu_torch import telemetry

    m = telemetry.get(name)
    return m.value if m is not None else 0


def lane_row(lane):
    """The observatory's roofline row of ``lane`` (`summary`), trimmed."""
    from mxnet_tpu_torch import observatory

    row = observatory.summary()["lanes"].get(lane)
    check(row is not None, f"observe: no roofline row for the {lane} lane")
    keep = ("key", "dtype", "flops", "bytes_accessed", "roofline_bound",
            "predicted_floor_s", "measured_s", "device_s", "wall_s",
            "host_gap_us", "mfu", "mbu", "samples")
    return {k: row.get(k) for k in keep}


def observe_generate(torch):
    """The generation windows, planes on: the default model (seed 0) and a
    32 x 2048 slab. A 16-session burst with the planes off and on in turns
    (`OBS_TURNS`), equal streams every time; the checks, on the last
    window: ``serving.generation.tokens`` equals the tokens streamed, the
    census's ``kv_cache`` is exactly the slab (512 MiB) and at most what
    the allocator holds, no capture after warm-up, the tick beacon's median
    gap within 2x of the median tick. Then 16 sessions on one system prompt
    through a prefix engine and a burst through the speculative lane with
    the n-gram draft: their ``prefix.*`` / ``spec.*`` counters equal the
    engines' own counts."""
    import gc

    import numpy as np

    from mxnet_tpu_torch import memory, tracing
    from mxnet_tpu_torch.models import TransformerLM, TransformerLMConfig
    from mxnet_tpu_torch.serving.generation import NgramDraft

    cfg = TransformerLMConfig()
    lm = TransformerLM(cfg, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.RandomState(0)
    lens = rng.randint(GEN_PROMPT_LENS[0], GEN_PROMPT_LENS[1] + 1, OBS_BURST)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in lens]
    out = {}
    eng, warm = lane_engine(lm)
    try:
        misses0, captures0 = eng.cache.misses, eng.captures
        ticks = []
        real_tick = eng._tick

        def timed_tick():
            t0 = time.perf_counter()
            real_tick()
            ticks.append(time.perf_counter() - t0)

        eng._tick = timed_tick
        turns, first = [], None
        for turn in OBS_TURNS:
            ticks.clear()
            with (planes_off() if turn == "off" else
                  contextlib.nullcontext()):
                if turn == "on":
                    fresh_records()
                outs, _, wall = burst(eng, prompts)
            first = outs if first is None else first
            check(outs == first, f"observe: the burst's streams changed "
                  f"in a window with the planes {turn}")
            turns.append({"planes": turn, "wall_s": wall,
                          "tokens_per_s": sum(map(len, outs)) / wall,
                          "median_tick_s": statistics.median(ticks)})
        eng._tick = real_tick
        outs_on = outs
        streamed = sum(len(o) for o in outs_on)
        check(counter("serving.generation.tokens") == streamed,
              f"observe: serving.generation.tokens "
              f"{counter('serving.generation.tokens')} for {streamed} "
              "tokens streamed")
        check((eng.cache.misses, eng.captures) == (misses0, captures0),
              "observe: the generate windows captured after warm-up")
        gap, tick = eng._beacon.median_gap(), turns[-1]["median_tick_s"]
        check(gap is not None and 0.5 <= gap / tick <= 2.0,
              f"observe: tick beacon median gap {gap} s against the median "
              f"tick {tick} s")
        gc.collect()
        census = memory.census()
        slab = census["categories"]["kv_cache"]["total"]
        categorized = sum(c["total"] for c in census["categories"].values())
        allocated = torch.cuda.memory_allocated()
        check(slab == eng.kv_slab_bytes() == 512 << 20,
              f"observe: census kv_cache {slab} bytes, the slab "
              f"{eng.kv_slab_bytes()} ({len(memory._providers['kv_cache'])}"
              " providers registered)")
        check(categorized <= allocated,
              f"observe: census {categorized} bytes > allocated {allocated}")
        worst = tracing.tick_recorder.worst()
        check(worst is not None and worst["name"] == "generation.tick",
              "observe: no tick span tree recorded")
        out["burst"] = {
            "sessions": OBS_BURST, "new_tokens": GEN_NEW,
            "tokens_streamed": streamed, "warm_captures": warm["captures"],
            "turns": turns, **overhead(turns, "tokens_per_s"),
            "median_tick_s": tick, "beacon_median_gap_s": gap,
            "census_kv_cache_bytes": slab,
            "census_categorized_bytes": categorized,
            "memory_allocated_bytes": allocated,
            "tick_row": lane_row("generation.tick")}
        # each plane alone, after the checks read the last window
        eng._tick = timed_tick
        alone = {}
        for name in OBS_PLANES:
            ticks.clear()
            with planes_off(keep=name):
                outs_alone, _, wall = burst(eng, prompts)
            check(outs_alone == first, f"observe: the burst's streams "
                  f"changed with {name} alone on")
            alone[name] = {"tokens_per_s": sum(map(len, outs_alone)) / wall,
                           "median_tick_s": statistics.median(ticks)}
        eng._tick = real_tick
        out["burst"]["plane_alone"] = alone
    finally:
        eng.close()
    del eng
    gc.collect()

    eng, _ = lane_engine(lm, prefix_cache=True, prefix_min_tokens=PREFIX_MIN)
    try:
        fresh_records()
        for p in prefix_prompts(cfg.vocab_size)[:OBS_BURST]:
            eng.generate(p, max_new_tokens=OBS_PREFIX_NEW)
        got = {"hits": counter("serving.generation.prefix.hits"),
               "misses": counter("serving.generation.prefix.misses")}
        want = {"hits": eng.prefix_hits, "misses": eng.prefix_misses}
        check(got == want and want["hits"] >= OBS_BURST - 1,
              f"observe: prefix counters {got}, the engine's {want}")
        out["prefix"] = dict(got, inserts=counter(
            "serving.generation.prefix.inserts"))
    finally:
        eng.close()
    del eng
    gc.collect()

    eng, _ = lane_engine(lm, spec_k=SPEC_K, draft=NgramDraft())
    try:
        fresh_records()
        t0 = time.perf_counter()
        streams = [eng.submit(p, max_new_tokens=OBS_SPEC_NEW)
                   for p in prompts]
        spec_tokens = sum(len(s.result(timeout=600)) for s in streams)
        wall = time.perf_counter() - t0
        got = {"committed": counter("serving.generation.spec.committed"),
               "verified_slots": counter(
                   "serving.generation.spec.verified_slots")}
        want = {"committed": eng.spec_committed,
                "verified_slots": eng.spec_verified_slots}
        check(got == want and got["committed"] > 0,
              f"observe: spec counters {got}, the engine's {want}")
        out["spec"] = dict(got, tokens_per_s=spec_tokens / wall,
                           accepted=counter(
                               "serving.generation.spec.accepted"),
                           proposed=counter(
                               "serving.generation.spec.proposed"))
    finally:
        eng.close()
    del eng, lm
    gc.collect()
    return out


def overhead(turns, rate):
    """The overhead reading over alternating windows: the mean rate and
    the mean median tick (where read) with the planes off and on."""
    out = {}
    for side in ("off", "on"):
        rows = [t for t in turns if t["planes"] == side]
        out[f"{rate}_{side}"] = statistics.mean(t[rate] for t in rows)
        if "median_tick_s" in rows[0]:
            out[f"median_tick_s_{side}"] = statistics.mean(
                t["median_tick_s"] for t in rows)
    out["on_over_off"] = out[f"{rate}_off"] / out[f"{rate}_on"]
    return out


def serve_window(mx, pred):
    """`SERVE_CLIENTS` closed-loop clients of `OBS_SERVE_PER_CLIENT`
    requests (sizes cycling `SERVE_SIZES`) through a new batcher; the
    requests answered and the wall seconds."""
    import threading

    payloads = serve_payloads(tuple(pred._data_descs[0].shape[1:]))
    done = []
    t0 = time.perf_counter()
    with mx.serving.DynamicBatcher(pred, max_wait_ms=SERVE_WAIT_MS) as srv:
        def client(k):
            for i in range(OBS_SERVE_PER_CLIENT):
                srv.predict(payloads[SERVE_SIZES[(k + i)
                                                 % len(SERVE_SIZES)]])
                done.append(1)

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(SERVE_CLIENTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    return len(done), time.perf_counter() - t0


def request_trees(events):
    """Check that every request has exactly one complete span tree with
    no orphan; returns the number of request trees."""
    spans = [e for e in events if e.get("ph") == "X"]
    by_trace = {}
    for e in spans:
        by_trace.setdefault(e["args"]["trace_id"], []).append(e)
    trees = 0
    for tid, group in by_trace.items():
        ids = {e["args"]["span_id"] for e in group}
        orphans = [e["name"] for e in group
                   if e["args"].get("parent_id") not in (None, *ids)]
        check(not orphans, f"observe: orphan spans {orphans} in {tid}")
        roots = [e for e in group if e["name"] == "serving.request"]
        if not roots:
            continue
        check(len(roots) == 1, f"observe: trace {tid} has {len(roots)} "
              "request roots")
        names = {e["name"] for e in group}
        check(set(SERVE_STAGES) <= names,
              f"observe: request tree {tid} lacks "
              f"{set(SERVE_STAGES) - names}")
        trees += 1
    return trees


def observe_serve(torch, mx, workdir):
    """The serve windows over the serve phase's ResNet-50 v1 checkpoint
    (``TPU_FUSE``, ladder 1-32), planes on: 200 requests through the
    batcher with the planes off and on in turns (`OBS_TURNS`). Checks, on
    the last window: ``serving.requests`` and the answered count are 200,
    each request has exactly one complete span tree, and the bucket-32
    program's counted FLOPs are within 3 % of the phase's own bound (its
    convolutions and FullyConnected)."""
    from mxnet_tpu_torch import tracing

    prefix = os.path.join(workdir, "resnet50_v1")
    shape = (3, ND_SIZE, ND_SIZE)
    pred = mx.serving.Predictor.load(prefix, 0,
                                     data_shapes=[("data", (1,) + shape)])
    pred.warmup()
    captures = pred.cache.misses
    want = SERVE_CLIENTS * OBS_SERVE_PER_CLIENT
    turns = []
    for turn in OBS_TURNS:
        with (planes_off() if turn == "off" else contextlib.nullcontext()):
            if turn == "on":
                fresh_records()
            n, wall = serve_window(mx, pred)
        check(n == want, f"observe: {n} requests answered, want {want}")
        turns.append({"planes": turn, "wall_s": wall,
                      "req_per_s": n / wall})
    events, dropped = tracing.take_events()
    check(counter("serving.requests") == want,
          f"observe: serving.requests {counter('serving.requests')}, "
          f"want {want}")
    check(dropped == 0, f"observe: {dropped} span events dropped")
    trees = request_trees(events)
    check(trees == want, f"observe: {trees} request trees for {want}")
    check(pred.cache.misses == captures,
          "observe: the serve windows captured after warm-up")
    # the bucket-32 program alone: its roofline row
    import numpy as np

    from mxnet_tpu_torch import observatory

    observatory.reset("serving")
    x = serve_payloads(shape)[SERVE_SIZES[-1]]
    big = np.concatenate([x] * -(-32 // len(x)))[:32]
    for _ in range(OBS_BUCKET_CALLS):
        pred.predict(big)
    row = lane_row("serving")
    sym = mx.sym.load(prefix + "-symbol.json")
    bound = symbol_forward_flop(sym, {"data": (32,) + shape})
    check(abs(row["flops"] / bound - 1) <= OBS_FLOP_TOL,
          f"observe: bucket-32 counted {row['flops']} FLOP against the "
          f"bound's {bound}")
    fill = counter("serving.batch_rows") / max(counter("serving.batch_slots"),
                                               1)
    return {"requests": want, "turns": turns,
            **overhead(turns, "req_per_s"), "request_trees": trees,
            "batch_fill_ratio": fill, "bucket32_bound_flop": bound,
            "bucket32_flop_over_bound": row["flops"] / bound,
            "bucket32_row": row}


def observe_module(torch, mx):
    """The module window, planes on: `Module.fit` of the symbolic
    ResNet-50 (batch 32 x 224², fp32, SGD as the module phase) over two
    batches, so two captured fused steps. Checks: the ``step.*``
    histograms count the two steps, the ``fit.step`` beacon moved, and the
    step program's counted FLOPs are within 3 % of the phase's own bound
    (3 x the forward's convolutions and FullyConnected)."""
    from mxnet_tpu_torch import health, telemetry
    from mxnet_tpu_torch.models.resnet import resnet50_symbol

    data, label = gluon_batches(0, ND_BATCH * OBS_MODULE_STEPS, ND_SIZE,
                                ND_CLASSES)
    fresh_records()
    with mx.gpu(0):
        mod = mx.mod.Module(resnet50_symbol(num_classes=ND_CLASSES,
                                            image_shape=(3, ND_SIZE,
                                                         ND_SIZE)),
                            context=mx.gpu(0))
        mod.fit(mx.io.NDArrayIter(data, label, batch_size=ND_BATCH),
                num_epoch=1, optimizer="sgd",
                optimizer_params=tuple(MODULE_OPT.items()),
                initializer=mx.init.Xavier())
    snap = telemetry.snapshot()
    counts = {k: snap["histograms"].get(f"step.{k}_us", {}).get("count")
              for k in ("total", "fwdbwd", "update", "sync", "data")}
    check(all(c == OBS_MODULE_STEPS for c in counts.values()),
          f"observe: step histograms counted {counts}, want "
          f"{OBS_MODULE_STEPS} each")
    check(snap["gauges"].get("step.fused") == 1,
          "observe: fit did not take the fused step")
    beacon = health.beacons().get("fit.step")
    check(beacon is not None and beacon.touches == OBS_MODULE_STEPS,
          f"observe: the fit.step beacon moved "
          f"{beacon.touches if beacon else None} times")
    row = lane_row("step")
    bound = symbol_step_flop(mod.symbol, {"data": (ND_BATCH, 3, ND_SIZE,
                                                   ND_SIZE),
                                          "softmax_label": (ND_BATCH,)})
    check(abs(row["flops"] / bound - 1) <= OBS_FLOP_TOL,
          f"observe: the step counted {row['flops']} FLOP against the "
          f"bound's {bound}")
    return {"steps": OBS_MODULE_STEPS, "step_counts": counts,
            "step_total_us": snap["histograms"]["step.total_us"],
            "bound_flop": bound, "flop_over_bound": row["flops"] / bound,
            "step_row": row}


def observe_peaks():
    """The observatory's peak probes on the card: bf16 and fp32 (TF32 off)
    matmul FLOP/s and the copy's bytes/s, each below 1.05 x the data
    sheet's constant."""
    from mxnet_tpu_torch import observatory

    pk = observatory.peaks(refresh=True)
    flops = pk["matmul_flops"]
    for dtype, peak in PEAK_FLOPS.items():
        check(0 < flops[dtype] < OBS_PEAK_MARGIN * peak,
              f"observe: measured {dtype} matmul {flops[dtype]} FLOP/s "
              f"against the sheet's {peak}")
    check(0 < pk["hbm_bytes_per_s"] < OBS_PEAK_MARGIN * PEAK_BYTES_PER_S,
          f"observe: measured copy {pk['hbm_bytes_per_s']} B/s against "
          f"the sheet's {PEAK_BYTES_PER_S}")
    check(pk["collective_bytes_per_s"] is None,
          "observe: a collective peak on one card")
    return {"matmul_flops": flops, "hbm_bytes_per_s": pk["hbm_bytes_per_s"],
            "collective_bytes_per_s": None,
            "share_of_sheet": {
                **{k: v / PEAK_FLOPS[k] for k, v in flops.items()},
                "hbm": pk["hbm_bytes_per_s"] / PEAK_BYTES_PER_S},
            "provenance": pk["provenance"]}


def observe_phase(torch, smi, workdir):
    """Slice 11's planes over the full-width models of the earlier phases,
    in short windows, each plane on (`observe_generate`, `observe_serve`,
    `observe_module`, `observe_peaks`); no K1-K3 launch. The telemetry
    snapshot is dumped under the run's temp dir."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import telemetry

    reset_launches()
    with planes_on():
        generate = observe_generate(torch)
        progress("observe generate")
        serve = observe_serve(torch, mx, workdir)
        progress("observe serve")
        module = observe_module(torch, mx)
        progress("observe module")
        peaks = observe_peaks()
        snapshot = telemetry.dump(os.path.join(workdir, "telemetry.json"))
        with open(snapshot) as f:
            snap = json.load(f)
    launches = read_launches()
    check(not any(launches.values()),
          f"the observe windows launched kernels: {launches}")
    return {"generate": generate, "serve": serve, "module": module,
            "peaks": peaks, "snapshot_path": snapshot,
            "snapshot_counters": len(snap["counters"]),
            "snapshot_histograms": len(snap["histograms"]),
            "kernel_launches": launches, "card": smi}


# slice 12's overlap lane (`bench.py:1630-1850`'s three planes)
OVL_DIM, OVL_HIDDEN, OVL_CLASSES = 512, 512, 8     # bench.py:1668-1683
OVL_BATCH, OVL_BATCHES, OVL_EPOCHS = 256, 8, 12    # 1 cold + 12 timed
# off/on pairs of each train feed, alternating which mode runs first: the
# host's run-to-run spread is wider than the lane's effect on this plane
OVL_PAIRS = {"card": 10, "host_small": 4, "host": 2}
# the host-fed runs: 0.5 MiB float32 batches, below
# io.staging.STAGE_MIN_BYTES (8 MiB), so none is staged, and 16 MiB ones,
# each staged
OVL_HOST_BATCH, OVL_HOST_BATCHES, OVL_HOST_EPOCHS = 8192, 4, 6
# bench.py trains it with Adam at 1e-3; the port's Adam has no fused update
# yet (ROADMAP A.4), so the plane takes SGD with momentum: the captured
# fused step that the staged feed reaches
OVL_OPT = (("learning_rate", 0.01), ("momentum", 0.9))
OVL_SERVE_PER_CLIENT = 25


def overlap_lane(lane):
    """The host gap of one observatory lane over its last samples: the
    median wall, the median device time between the CUDA events around
    its program over the same steps, and their difference (None where
    the lane has no events)."""
    from mxnet_tpu_torch import observatory

    with observatory._lock:
        count = (observatory._lanes.get(lane) or {}).get("count", 0)
    gap = observatory.host_gap(lane)
    out = {"samples": count}
    if gap is not None:
        wall, device, diff = gap
        out.update(wall_us_median=wall * 1e6, device_us_median=device * 1e6,
                   host_gap_us=diff * 1e6)
    return out


def overlap_modes(fn, order=("off", "on")):
    """``fn()`` with ``MXNET_OVERLAP`` 0 and 1 in ``order``, the
    observatory on over fresh lanes for each; {"off": result, "on":
    result}."""
    from mxnet_tpu_torch import observatory

    out = {}
    for mode in order:
        flag = "1" if mode == "on" else "0"
        with env_scope({"MXNET_OVERLAP": flag}):
            observatory.reset()
            observatory.enable()
            try:
                out[mode] = fn()
            finally:
                observatory.disable()
                observatory.reset()
    return out


def overlap_train(torch, mx, feed="card"):
    """The train plane: `bench.py`'s host-heavy MLP (512 -> 512 -> 8,
    batch 256, 8 batches of float64 sources cast to the float32 inputs
    each batch) through `Module.fit` with SGD (`OVL_OPT`), one cold epoch
    then `OVL_EPOCHS`, Xavier after ``mx.random.seed(7)``. ``feed``
    ``"card"``: its `NDArrayIter` copies the batches to the card itself;
    ``"host_small"``: it hands them over on the host (``host_batches``),
    below the size the staged feed takes; ``"host"``: the same with 16
    MiB batches (`OVL_HOST_BATCH`), which the staged feed copies.
    Returns (the line, the final params)."""
    import numpy as np

    from mxnet_tpu_torch import compile_cache

    batch, batches, epochs = ((OVL_HOST_BATCH, OVL_HOST_BATCHES,
                               OVL_HOST_EPOCHS) if feed == "host" else
                              (OVL_BATCH, OVL_BATCHES, OVL_EPOCHS))
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (batch * batches, OVL_DIM))
    y = rng.randint(0, OVL_CLASSES, (batch * batches,)).astype(np.float64)
    data = mx.sym.Variable("data")
    fc1 = mx.sym.FullyConnected(data, num_hidden=OVL_HIDDEN, name="fc1")
    act = mx.sym.Activation(fc1, act_type="relu")
    fc2 = mx.sym.FullyConnected(act, num_hidden=OVL_CLASSES, name="fc2")
    sym = mx.sym.SoftmaxOutput(fc2, name="softmax")
    marks = {}

    def at_epoch_end(epoch, *_):
        if epoch == 0:
            torch.cuda.synchronize()
            marks["misses"] = compile_cache.named_stats("executor")["misses"]
            marks["t0"] = time.perf_counter()
            from mxnet_tpu_torch import observatory
            observatory.reset("step")

    mx.random.seed(7)
    mod = mx.mod.Module(sym, context=mx.gpu(0))
    staged = []
    consume = mod._consume_staged

    def spy(batch):
        feed = consume(batch)
        staged.append(feed is not None)
        return feed

    mod._consume_staged = spy
    it = mx.io.NDArrayIter(x, y, batch_size=batch, shuffle=False)
    it.host_batches = feed != "card"
    mod.fit(it, num_epoch=epochs + 1, optimizer="sgd",
            optimizer_params=OVL_OPT, initializer=mx.init.Xavier(),
            epoch_end_callback=at_epoch_end)
    torch.cuda.synchronize()
    wall = time.perf_counter() - marks["t0"]
    steady = compile_cache.named_stats("executor")["misses"] - marks["misses"]
    check(steady == 0, f"overlap train: {steady} captures after the cold "
          "epoch")
    arg, _ = mod.get_params()
    check(len(staged) == (epochs + 1) * batches,
          f"overlap train: {len(staged)} fused steps")
    return {"batch": batch, "steps_per_s": epochs * batches / wall,
            "staged_steps": sum(staged), "fused_steps": len(staged),
            "captures_after_warmup": steady, **overlap_lane("step")}, \
        {k: v.asnumpy() for k, v in arg.items()}


def overlap_serving(torch, mx, prefix):
    """The serving plane: the serve phase's full-width ResNet-50 v1
    checkpoint loaded by `Predictor.load` (``TPU_FUSE``, ladder 1-32),
    warmed, then `SERVE_CLIENTS` closed-loop clients of
    `OVL_SERVE_PER_CLIENT` requests (`SERVE_SIZES` rows, cycled) through a
    `DynamicBatcher`, and a probe of 3 rows read after. Returns (the line,
    the probe's output)."""
    import threading

    shape = (3, ND_SIZE, ND_SIZE)
    pred = mx.serving.Predictor.load(prefix, 0,
                                     data_shapes=[("data", (1,) + shape)])
    mx.serving.warmup(pred)
    misses0 = pred.cache.misses
    payloads = serve_payloads(shape)
    errors = []
    with mx.serving.DynamicBatcher(pred, max_wait_ms=SERVE_WAIT_MS) as srv:
        for _ in range(3):
            srv.predict(payloads[SERVE_PROBE_ROWS])

        def client(k):
            try:
                for i in range(OVL_SERVE_PER_CLIENT):
                    srv.predict(payloads[SERVE_SIZES[(k + i)
                                                     % len(SERVE_SIZES)]])
            except Exception as e:  # noqa: BLE001 - raised below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(SERVE_CLIENTS)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        if errors:
            raise errors[0]
        probe = srv.predict(payloads[SERVE_PROBE_ROWS]).asnumpy()
    steady = pred.cache.misses - misses0
    check(steady == 0, f"overlap serving: {steady} captures after warm-up")
    del pred
    return {"req_per_s": SERVE_CLIENTS * OVL_SERVE_PER_CLIENT / wall,
            "captures_after_warmup": steady, **overlap_lane("serving")}, \
        probe


def overlap_generation(torch, state):
    """The generation plane: the full-width default engine (32 x 2048, the
    generate phase's model and seed-0 weights) and the generate phase's
    64-session burst. Returns (the line, the streams)."""
    lm = state["lm"]
    eng, warm = lane_engine(lm, params=seed0_params(torch, state))
    try:
        captures0 = eng.captures
        outs, _, wall = burst(eng, state["prompts"])
        check(eng.captures == captures0,
              "overlap generation: captured after warm-up")
    finally:
        eng.close(timeout=60)
    return {"tokens_per_s": sum(map(len, outs)) / wall,
            "captures_after_warmup": 0, **overlap_lane("generation.tick")}, \
        outs


def overlap_phase(torch, smi, workdir, state):
    """Slice 12's overlap lane: three planes, each with ``MXNET_OVERLAP=0``
    then ``=1`` and the observatory on for its host gap (wall minus the
    device time between the CUDA events around the step, bucket or tick
    program): train (`overlap_train`, fed from the card and from the
    host, final params bit-equal across modes), serving
    (`overlap_serving`, probe outputs bit-equal) and
    generation (`overlap_generation`, every stream equal across modes and
    to the generate phase's). No capture after warm-up, no kernel."""
    import numpy as np

    import mxnet_tpu_torch as mx

    reset_launches()
    # each feed in off/on pairs, alternating which runs first: the two
    # modes' rates compared within one call and around the same point of it
    runs = {feed: [overlap_modes(lambda: overlap_train(torch, mx, feed),
                                 ("off", "on") if i % 2 == 0 else
                                 ("on", "off"))
                   for i in range(pairs)]
            for feed, pairs in OVL_PAIRS.items()}
    for feed, rs in runs.items():
        p_off = rs[0]["off"][1]
        for r in rs:
            # a batch the iterator put on the card has nothing left to
            # stage, a small one costs less in lockstep, a 16 MiB host
            # batch is staged on every step
            want = r["on"][0]["fused_steps"] if feed == "host" else 0
            check(r["off"][0]["staged_steps"] == 0
                  and r["on"][0]["staged_steps"] == want,
                  f"overlap train, {feed} feed: staged "
                  f"{r['off'][0]['staged_steps']} (off) and "
                  f"{r['on'][0]['staged_steps']} (on) steps, want 0 and "
                  f"{want}")
            check(all(set(p_off) == set(r[m][1]) and all(
                p_off[k].dtype == r[m][1][k].dtype
                and np.array_equal(p_off[k], r[m][1][k]) for k in p_off)
                for m in ("off", "on")),
                f"overlap train, {feed} feed: params differ across modes "
                "or runs")
    progress("overlap train")
    serving = overlap_modes(lambda: overlap_serving(
        torch, mx, os.path.join(workdir, "resnet50_v1")))
    o_off, o_on = serving["off"][1], serving["on"][1]
    check(o_off.dtype == o_on.dtype and np.array_equal(o_off, o_on),
          "overlap serving: probe outputs differ across modes")
    check(output_std([o_on]) >= SERVE_MIN_STD,
          "overlap serving: the probe's outputs do not spread")
    progress("overlap serving")
    gen = overlap_modes(lambda: overlap_generation(torch, state))
    check(gen["off"][1] == gen["on"][1] == state["outs"],
          "overlap generation: streams differ across modes or from the "
          "generate phase's")
    launches = read_launches()
    check(not any(launches.values()),
          f"the overlap lane launched kernels: {launches}")

    def plane(modes, parity):
        off, on = modes["off"][0], modes["on"][0]
        out = {"off": off, "on": on, "parity": parity}
        if off.get("host_gap_us") is not None and \
                on.get("host_gap_us") is not None:
            out["host_gap_on_over_off"] = (on["host_gap_us"]
                                           / max(off["host_gap_us"], 1e-9))
        return out

    def train_plane(rs):
        line = plane(rs[0], "params bit-equal across modes and runs")
        rates = {m: [r[m][0]["steps_per_s"] for r in rs]
                 for m in ("off", "on")}
        ratios = sorted(on / off for on, off in zip(rates["on"],
                                                    rates["off"]))
        line.update(steps_per_s_off=rates["off"], steps_per_s_on=rates["on"],
                    pairs=len(rs), pairs_on_faster=sum(r > 1 for r in ratios),
                    on_over_off_median=statistics.median(ratios),
                    on_over_off_range=[ratios[0], ratios[-1]],
                    second_run={m: rs[1][m][0] for m in ("off", "on")})
        return line

    return {"card": smi, "basis": "same workload, only MXNET_OVERLAP flips",
            "train": train_plane(runs["card"]),
            "train_host_feed_small": train_plane(runs["host_small"]),
            "train_host_feed": train_plane(runs["host"]),
            "serving": plane(serving, "probe outputs bit-equal"),
            "generation": plane(gen, "streams equal, and to the generate "
                                "phase's"),
            "kernel_launches": launches}


# --- the gan phase (slice 13): a full-width DCGAN ----------------------------

# the published DCGAN (Radford, Metz and Chintala 2016; the defaults of
# MXNet's example/gluon/dc_gan/dcgan.py): 64 x 64 x 3, batch 64
GAN_FULL = {"nz": 100, "ngf": 64, "ndf": 64, "nc": 3, "size": 64,
            "batch": 64}
GAN_OPT = {"learning_rate": 2e-4, "beta1": 0.5}  # example/gluon/dcgan.py
GAN_WARMUP, GAN_TIMED = 3, 20
GAN_POOL = 4  # batches of real images, made once and cycled
# check (b): the example's widths at batch 8, two D/G iterations
GAN_SMALL = {"nz": 16, "ngf": 16, "ndf": 16, "nc": 1, "size": 16,
             "batch": 8, "iters": 2}
GAN_MARGIN = 0.15  # d-real-minus-fake, test_examples.py:114-121
GAN_EXAMPLE = "example/gluon/dcgan.py"


def dcgan_nets(mx, nz, ngf, ndf, nc, size):
    """`example/gluon/dcgan.py`'s generator and discriminator, written only
    against the package ``mx`` it is given, for ``size`` x ``size`` images
    (a power of two, 16 or more): the generator goes from the noise's 1 x 1
    through 4 x 4 up to ``size`` by stride-2 `Conv2DTranspose` layers with
    BatchNorm and relu, widths ngf * 2^k down to ngf, then to ``nc``
    channels and tanh; the discriminator mirrors it with `Conv2D`,
    `LeakyReLU(0.2)` and BatchNorm (none on its first layer) down to a
    1-channel `Conv2D(4, 1, 0)`. At 16 it is the example's three-layer net
    (``nz`` is the noise's channel count, which the first layer infers)."""
    nn = mx.gluon.nn
    stages = int(round(math.log2(size // 4)))
    check(size == 4 * 2 ** stages and stages >= 2,
          f"dcgan_nets: size {size} is not a power of two >= 16")
    netG = nn.HybridSequential()
    with netG.name_scope():
        for i in range(stages):
            first = i == 0
            netG.add(nn.Conv2DTranspose(ngf * 2 ** (stages - 1 - i), 4,
                                        1 if first else 2, 0 if first else 1,
                                        use_bias=False))
            netG.add(nn.BatchNorm())
            netG.add(nn.Activation("relu"))
        netG.add(nn.Conv2DTranspose(nc, 4, 2, 1, use_bias=False))
        netG.add(nn.Activation("tanh"))
    netD = nn.HybridSequential()
    with netD.name_scope():
        netD.add(nn.Conv2D(ndf, 4, 2, 1, use_bias=False))
        netD.add(nn.LeakyReLU(0.2))
        for i in range(1, stages):
            netD.add(nn.Conv2D(ndf * 2 ** i, 4, 2, 1, use_bias=False))
            netD.add(nn.BatchNorm())
            netD.add(nn.LeakyReLU(0.2))
        netD.add(nn.Conv2D(1, 4, 1, 0, use_bias=False))
    return netG, netD


def dcgan_real_images(n, size=16, nc=1, seed=0):
    """`example/gluon/dcgan.py`'s `real_images` at any size and channel
    count: noise near -1 with a bright centred blob (at 16 x 16 x 1 the
    example's own draws)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    x = rng.rand(n, nc, size, size).astype(np.float32) * 0.2 - 1.0
    lo, hi = 5 * size // 16, 11 * size // 16
    x[:, :, lo:hi, lo:hi] += 1.6
    return np.clip(x, -1, 1)


def dcgan_iteration(mx, nets, trainers, loss_fn, real, noise, labels):
    """One iteration of the example's loop: the D step (D on the real
    batch and on the generated one, detached, under one `record()`), then
    the G step. Returns (errD, errG, D's outputs on real, on fake)."""
    netG, netD = nets
    trainerG, trainerD = trainers
    real_label, fake_label = labels
    bs = real.shape[0]
    with mx.autograd.record():
        out_real = netD(real).reshape((-1,))
        err_real = loss_fn(out_real, real_label)
        fake = netG(noise)
        out_fake = netD(fake.detach()).reshape((-1,))
        err_fake = loss_fn(out_fake, fake_label)
        errD = err_real + err_fake
    errD.backward()
    trainerD.step(bs)
    with mx.autograd.record():
        out = netD(netG(noise)).reshape((-1,))
        errG = loss_fn(out, real_label)
    errG.backward()
    trainerG.step(bs)
    return errD, errG, out_real, out_fake


def dcgan_setup(mx, ctx, cfg, weights_seed=None, hybridize=True):
    """The nets (hybridized unless told not), their Adam trainers, the
    loss and the labels on ctx. Weights: `mx.init.Normal(0.02)`, or with
    ``weights_seed`` every convolution's drawn from numpy's N(0, 0.02)
    (the same on any package and device; BatchNorm keeps its initial
    gamma 1, beta 0 and stats)."""
    import numpy as np

    nets = dcgan_nets(mx, cfg["nz"], cfg["ngf"], cfg["ndf"], cfg["nc"],
                      cfg["size"])
    with ctx:
        for net in nets:
            net.initialize(mx.init.Normal(0.02), ctx=ctx)
        # the deferred shapes, then the numpy weights
        fake = nets[0](mx.nd.zeros((1, cfg["nz"], 1, 1), ctx=ctx))
        nets[1](fake)
        if weights_seed is not None:
            rng = np.random.RandomState(weights_seed)
            for net in nets:
                for name, p in sorted(
                        net._collect_params_with_prefix().items()):
                    if name.endswith("weight"):
                        p.set_data(mx.nd.array(rng.normal(
                            0, 0.02, p.shape).astype(np.float32), ctx=ctx))
        for net in nets:
            if hybridize:
                net.hybridize()
        trainers = tuple(mx.gluon.Trainer(net.collect_params(), "adam",
                                          dict(GAN_OPT)) for net in nets)
        bs = cfg["batch"]
        labels = (mx.nd.ones((bs,), ctx=ctx), mx.nd.zeros((bs,), ctx=ctx))
    return nets, trainers, mx.gluon.loss.SigmoidBinaryCrossEntropyLoss(), \
        labels


def dcgan_adam_moments(trainer):
    """{parameter index: [mean, var]} of a gluon Trainer's Adam states,
    numpy, on either package."""
    upd = getattr(trainer, "_updater", None) or trainer._updaters[0]
    return {i: [_to_numpy(t) for t in s] for i, s in upd.states.items()}


def dcgan_state(mx, nets, trainers):
    """The nets' parameters (weights and BatchNorm stats) by structural
    name and both trainers' Adam moments, numpy."""
    out = {}
    for tag, net, trainer in zip("GD", nets, trainers):
        for name, p in net._collect_params_with_prefix().items():
            out[f"{tag} {name}"] = p.data().asnumpy()
        for i, (m, v) in dcgan_adam_moments(trainer).items():
            out[f"{tag} adam mean {i}"], out[f"{tag} adam var {i}"] = m, v
    return out


def dcgan_small_run(mx, ctx, cfg=GAN_SMALL, seed=0, hybridize=True):
    """Check (b)'s run and the CPU test's: the DCGAN of ``cfg`` from the
    weights of ``seed``, stepped ``cfg["iters"]`` iterations on numpy's
    real images and noise. Returns (losses [errD, errG] an iteration,
    `dcgan_state`)."""
    import numpy as np

    nets, trainers, loss_fn, labels = dcgan_setup(
        mx, ctx, cfg, weights_seed=seed, hybridize=hybridize)
    bs = cfg["batch"]
    real = dcgan_real_images(bs * cfg["iters"], cfg["size"], cfg["nc"],
                             seed + 1)
    rng = np.random.RandomState(seed + 2)
    losses = []
    for it in range(cfg["iters"]):
        noise = rng.normal(0, 1, (bs, cfg["nz"], 1, 1)).astype(np.float32)
        errD, errG, _, _ = dcgan_iteration(
            mx, nets, trainers, loss_fn,
            mx.nd.array(real[it * bs:(it + 1) * bs], ctx=ctx),
            mx.nd.array(noise, ctx=ctx), labels)
        losses.append([errD.asnumpy(), errG.asnumpy()])
    return losses, dcgan_state(mx, nets, trainers)


def dcgan_flop(cfg):
    """One iteration's FLOP in the convolutions and transposed
    convolutions, from the shapes: each call that is backpropagated counts
    3 x its forward (data and weight gradients), the D step's generator
    call 1 x; so 9 D forwards and 4 G forwards. Returns (iteration, G
    forward, D forward)."""
    b, size = cfg["batch"], cfg["size"]
    stages = int(round(math.log2(size // 4)))
    g_chans = [cfg["nz"]] + [cfg["ngf"] * 2 ** (stages - 1 - i)
                             for i in range(stages)] + [cfg["nc"]]
    g = 0
    for i in range(stages + 1):
        hw_in = 1 if i == 0 else 4 * 2 ** (i - 1)
        g += 2 * b * g_chans[i] * hw_in ** 2 * g_chans[i + 1] * 16
    d_chans = [cfg["nc"]] + [cfg["ndf"] * 2 ** i for i in range(stages)] \
        + [1]
    d = 0
    for i in range(stages + 1):
        hw_out = 1 if i == stages else size // 2 ** (i + 1)
        d += 2 * b * d_chans[i + 1] * hw_out ** 2 * d_chans[i] * 16
    return 9 * d + 4 * g, g, d


def dcgan_signatures(net):
    """A hybridized net's captured instances by signature: the train and
    recording flags, whether its data input needs a gradient, and the
    instance count."""
    return [{"train": key[0], "recording": key[1],
             "data_requires_grad": key[2][-1][3], "instances": n}
            for key, n in net._cached_op.instances().items()]


def example_namespace(rel_path, imports, port=True, subs=()):
    """The repo example ``rel_path`` executed as a module (its ``main`` not
    run): with ``port``, its ``imports`` imports of ``mxnet_tpu`` changed to
    ``mxnet_tpu_torch`` and each (old, new) text of ``subs`` replaced
    once, else as it stands. Returns its namespace."""
    import re

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        rel_path)
    with open(path) as f:
        src = f.read()
    if port:
        src, n = re.subn(r"^(\s*)(import|from) mxnet_tpu\b",
                         r"\1\2 mxnet_tpu_torch", src, flags=re.M)
        check(n == imports,
              f"{rel_path}: {n} imports of mxnet_tpu, want {imports}")
        for old, new in subs:
            check(src.count(old) == 1, f"{rel_path}: {old!r} is not there "
                  "once")
            src = src.replace(old, new)
    name = re.sub(r"\W", "_", rel_path)
    ns = {"__name__": name, "__file__": path}
    exec(compile(src, path, "exec"), ns)
    return ns


def run_example(ns, argv, ctx=None, parse=False, text_keys=()):
    """``main()`` of an example namespace (`example_namespace`) under
    ``argv``, inside ``ctx`` (default: the current context), its stdout
    captured; with ``parse``, ``main(parser.parse_args(argv))``, for an
    example whose main takes its arguments. Returns its ``name:value``
    figures: numbers, and the text of the names in ``text_keys``."""
    import io

    import mxnet_tpu_torch as mx

    out, old_argv = io.StringIO(), sys.argv
    sys.argv = [ns["__file__"]] + list(argv)
    try:
        with contextlib.redirect_stdout(out), ctx or mx.current_context():
            if parse:
                ns["main"](ns["parser"].parse_args(argv))
            else:
                ns["main"]()
    finally:
        sys.argv = old_argv
    figures = {}
    for line in out.getvalue().splitlines():
        key, _, value = line.rpartition(":")
        if key.strip() in text_keys:
            figures[key.strip()] = value.strip()
            continue
        with contextlib.suppress(ValueError):
            figures[key.strip()] = float(value)
    return figures


def run_dcgan_example(argv, ctx=None):
    """`example/gluon/dcgan.py` run through the port with only its imports
    changed (``mxnet_tpu`` -> ``mxnet_tpu_torch``), on ``ctx`` (default: the
    port's default context, the card). Returns its two figures
    (``blob-minus-border``, ``d-real-minus-fake``)."""
    return run_example(example_namespace(GAN_EXAMPLE, 3), argv, ctx)


def gan_full_width(torch, mx, smi):
    """The published DCGAN on the card (`GAN_FULL`, `GAN_OPT`): both nets
    hybridized, fp32 (TF32 off), `GAN_WARMUP` iterations then `GAN_TIMED`
    timed ones of the example's loop (its four reads of each iteration
    included); checks (a) and (c). Returns the line and a function that
    runs one more iteration."""
    import numpy as np

    from mxnet_tpu_torch import observatory

    cfg = GAN_FULL
    bs = cfg["batch"]
    ctx = mx.gpu(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mx.random.seed(0)
    nets, trainers, loss_fn, labels = dcgan_setup(mx, ctx, cfg)
    stats0 = {k: v for k, v in dcgan_state(mx, nets, trainers).items()
              if "running" in k}
    pool = [mx.nd.array(x, ctx=ctx) for x in np.split(dcgan_real_images(
        bs * GAN_POOL, cfg["size"], cfg["nc"], seed=1), GAN_POOL)]
    state = {"i": 0}

    def one():
        real = pool[state["i"] % GAN_POOL]
        state["i"] += 1
        noise = mx.nd.random.normal(0, 1, shape=(bs, cfg["nz"], 1, 1),
                                    ctx=ctx)
        return dcgan_iteration(mx, nets, trainers, loss_fn, real, noise,
                               labels)

    def reads(res):
        errD, errG, out_real, out_fake = res
        return [float(errD.mean().asnumpy()), float(errG.mean().asnumpy()),
                float(out_real.sigmoid().mean().asnumpy()),
                float(out_fake.sigmoid().mean().asnumpy())]

    losses, wall, host = [], [], []
    captures = None
    for i in range(GAN_WARMUP + GAN_TIMED):
        if i == GAN_WARMUP:
            captures = [net._cached_op.captures for net in nets]
        t0 = time.perf_counter()
        res = one()
        t1 = time.perf_counter()
        losses.append(reads(res))
        t2 = time.perf_counter()
        if i >= GAN_WARMUP:
            host.append(t1 - t0)
            wall.append(t2 - t0)
    after = [net._cached_op.captures for net in nets]
    peak = torch.cuda.max_memory_allocated()
    # (a): finite losses, every moving stat moved
    check(all(math.isfinite(v) for row in losses for v in row),
          f"gan: a non-finite loss in {losses}")
    moved = dcgan_state(mx, nets, trainers)
    unmoved = [k for k, v in stats0.items() if np.array_equal(moved[k], v)]
    check(not unmoved, f"gan: moving stats unchanged: {unmoved}")
    # (c): every capture in the warm-up
    check(after == captures, f"gan: captures {captures} after the warm-up, "
          f"{after} after the timed iterations")
    sigs = {"netG": dcgan_signatures(nets[0]),
            "netD": dcgan_signatures(nets[1])}
    check(any(not s["data_requires_grad"] and s["recording"]
              and s["instances"] == 2 for s in sigs["netD"]),
          f"gan: netD's recorded no-grad signature does not hold two "
          f"instances: {sigs['netD']}")
    flop, g_flop, d_flop = dcgan_flop(cfg)
    iter_ms = statistics.median(wall) * 1e3
    peak_fp32 = observatory.peaks()["matmul_flops"]["float32"]
    bound_ms = flop / peak_fp32 * 1e3
    return {"config": dict(cfg, **GAN_OPT, optimizer="adam",
                           dtype="float32, TF32 off"),
            "source": "Radford, Metz and Chintala 2016; MXNet "
                      "example/gluon/dc_gan/dcgan.py defaults",
            "warmup": GAN_WARMUP, "timed": GAN_TIMED,
            "losses_d_g_dreal_dfake": losses,
            "iteration_ms": [w * 1e3 for w in wall],
            "median_iteration_ms": iter_ms,
            "img_per_s": bs / iter_ms * 1e3,
            "median_host_ms": statistics.median(host) * 1e3,
            "iteration_flop": flop, "g_forward_flop": g_flop,
            "d_forward_flop": d_flop, "peak_fp32_flops": peak_fp32,
            "bound_ms": bound_ms, "bound_by": "operations",
            "bound_share": bound_ms / iter_ms,
            "sheet_bound_share": flop / PEAK_FLOPS["float32"] * 1e3
            / iter_ms,
            "captures_g_d": after, "signatures": sigs,
            "peak_mem_gb": peak / 1e9, "card": smi}, one


def gan_phase(torch, smi):
    """Slice 13's path: the full-width DCGAN (`gan_full_width`, checks (a)
    and (c)), one more iteration under torch.profiler (host launch calls,
    idle share), the repo's example at its defaults through the port (its
    ``d-real-minus-fake`` above `GAN_MARGIN`), and check (b): the small
    DCGAN on the card against the CPU under cuDNN's deterministic
    algorithms. (e): no kernel launch. (d), the new ops' cases and the
    random ops' draws, runs in the nd phase. Returns the line and the
    profile."""
    import numpy as np

    import mxnet_tpu_torch as mx

    reset_launches()
    full, one_more = gan_full_width(torch, mx, smi)
    launches = read_launches()
    check(not any(launches.values()),
          f"the gan path launched kernels: {launches}")
    profile = profile_step(torch, one_more, must_run=("convolution",))
    full["host_launch_calls"] = profile["host_launch_calls"]
    full["idle_share"] = profile["idle_share"]
    full["profile"] = profile_summary(profile)
    example = run_dcgan_example([], ctx=mx.gpu(0))
    check(example.get("d-real-minus-fake", -1) > GAN_MARGIN,
          f"gan: the example's figures {example}, want d-real-minus-fake "
          f"> {GAN_MARGIN}")
    with cudnn_deterministic():
        card = dcgan_small_run(mx, mx.gpu(0))
    cpu = dcgan_small_run(mx, mx.cpu())
    worst = 0.0
    pairs = [(f"losses {i}", np.asarray(a, np.float64),
              np.asarray(b, np.float64))
             for i, (a, b) in enumerate(zip(card[0], cpu[0]))]
    pairs += [(k, v, cpu[1][k]) for k, v in card[1].items()]
    for what, a, b in pairs:
        err = float(np.abs(a - b).max())
        worst = max(worst, err)
        check(np.allclose(a, b, **ND_SMALL_TOL),
              f"gan small card vs CPU: {what} max err {err} over "
              f"{ND_SMALL_TOL}")
    return {"full_width": full, "kernel_launches": launches,
            "example": dict(example, margin=GAN_MARGIN,
                            argv="defaults: nz 16, ngf = ndf = 16, 16 x 16 "
                                 "x 1, batch 32, 256 examples, 3 epochs"),
            "small_card_vs_cpu": {"config": GAN_SMALL,
                                  "compared": len(pairs),
                                  "max_abs_err": worst,
                                  "tol": ND_SMALL_TOL}}, profile


# -- slice 14: the recurrent path ---------------------------------------------

# the "large" LSTM language model of Zaremba, Sutskever and Vinyals 2014
# (2 x 1500, dropout 0.65, 35 unrolled steps) on WikiText-2's vocabulary,
# at MXNet's example/gluon/word_language_model/train.py batch of 32
LM_FULL = {"vocab": 33278, "embed": 1500, "hidden": 1500, "layers": 2,
           "dropout": 0.65, "bptt": 35, "batch": 32}
# the repo example's Trainer: SGD at its default rate 2.0, gradients clipped
# elementwise at 0.25 (MXNet's train.py takes rate 20 with a clip of the
# global norm; at rate 20 under the elementwise clip this model diverged on
# the card, PERF.md)
LM_OPT = {"learning_rate": 2.0, "clip_gradient": 0.25}
LM_WARMUP, LM_TIMED = 3, 20
# bptt windows of the synthetic corpus that the iterations cycle through, as
# epochs would: a first-order chain over 33,278 words is learned only from
# pairs seen again
LM_POOL = 4
# check (b): a small LSTM LM from numpy weights, two steps
LM_SMALL = {"vocab": 64, "embed": 32, "hidden": 32, "layers": 2,
            "dropout": 0.0, "bptt": 8, "batch": 4, "steps": 2}
LM_SMALL_TOL = {"rtol": 1e-4, "atol": 1e-4}
WORD_LM_EXAMPLE = "example/gluon/word_language_model.py"
# the vocabulary tests/python/unittest/test_examples.py:54 runs it at: at its
# default 200 the example stops near perplexity 197 on either package, above
# its own assert's vocab / 4 (ROADMAP.md, reference-side behaviour)
WORD_LM_VOCAB = 100
BUCKETING_EXAMPLE = "example/rnn/lstm_bucketing.py"
BUCKETING_PPL = 20.0  # tests/python/unittest/test_examples.py:84
# MXNet's example/rnn/bucketing/lstm_bucketing.py defaults, on a synthetic
# vocabulary of 10,000 words
BUCKET_CFG = {"layers": 2, "hidden": 200, "embed": 200, "vocab": 10000,
              "batch": 32, "buckets": (10, 20, 30, 40, 50, 60),
              "sentences": 1920, "epochs": 2}
BUCKET_OPT = {"learning_rate": 0.01, "momentum": 0.0, "wd": 1e-5}


def word_lm_module(mx):
    """`example/gluon/word_language_model.py` as a module for the package
    ``mx``: through the port with its imports changed, or as it stands."""
    return example_namespace(WORD_LM_EXAMPLE, 3,
                             port=mx.__name__ == "mxnet_tpu_torch")


def word_lm_setup(mx, ctx, cfg, weights_seed=None, hybridize=True):
    """The example's `RNNModel` (untied) at ``cfg``'s widths on ctx, its
    `Trainer` (SGD at ``cfg``'s rate, else `LM_OPT`'s, with `LM_OPT`'s
    elementwise ``clip_gradient``) and loss; ``model.rnn`` hybridized
    unless told not. Weights: `mx.init.Xavier()`, or with ``weights_seed``
    each parameter drawn from numpy's U(-0.1, 0.1) by its structural name
    (the same on any package and device)."""
    import numpy as np

    ex = word_lm_module(mx)
    with ctx:
        model = ex["RNNModel"](cfg["vocab"], cfg["embed"], cfg["hidden"],
                               cfg["layers"], dropout=cfg["dropout"])
        model.initialize(mx.init.Xavier(), ctx=ctx)
        # the decoder's deferred input width
        hidden = model.begin_state(func=mx.nd.zeros, batch_size=1, ctx=ctx)
        model(mx.nd.zeros((1, 1), ctx=ctx), hidden)
        if weights_seed is not None:
            rng = np.random.RandomState(weights_seed)
            for name, p in sorted(model._collect_params_with_prefix()
                                  .items()):
                p.set_data(mx.nd.array(rng.uniform(-0.1, 0.1, p.shape)
                                       .astype(np.float32), ctx=ctx))
        if hybridize:
            model.rnn.hybridize()
        opt = dict(LM_OPT, learning_rate=cfg.get("lr",
                                                 LM_OPT["learning_rate"]))
        trainer = mx.gluon.Trainer(model.collect_params(), "sgd", opt)
    return ex, model, trainer, mx.gluon.loss.SoftmaxCrossEntropyLoss()


def word_lm_windows(ex, cfg, n, seed=0):
    """``n`` consecutive (input, target) bptt windows of the example's
    synthetic corpus at ``cfg``'s vocabulary, batchified as the example
    does: numpy (bptt, batch) arrays."""
    import numpy as np

    T, N = cfg["bptt"], cfg["batch"]
    data = ex["batchify"](ex["synthetic_corpus"](cfg["vocab"],
                                                 n * T * N + N, seed), N)
    return [(data[i * T:(i + 1) * T].astype(np.float32),
             data[i * T + 1:(i + 1) * T + 1].astype(np.float32))
            for i in range(n)]


def word_lm_iteration(mx, model, trainer, loss_fn, x, y, hidden, cfg):
    """One iteration of the example's loop: the hidden state detached
    (truncated BPTT), the forward and loss under `record()`, the backward
    and the SGD step over batch x bptt tokens. Returns (per-token loss,
    hidden)."""
    hidden = [h.detach() for h in hidden]
    with mx.autograd.record():
        out, hidden = model(x, hidden)
        loss = loss_fn(out.reshape((-1, cfg["vocab"])), y.reshape((-1,)))
    loss.backward()
    trainer.step(cfg["batch"] * cfg["bptt"])
    return loss, hidden


def word_lm_small_run(mx, ctx, cfg=LM_SMALL, seed=0, hybridize=True):
    """Check (b)'s run and the CPU test's: the LSTM LM of ``cfg`` from the
    weights of ``seed`` stepped ``cfg["steps"]`` iterations over the
    corpus's consecutive windows. Returns (mean losses, the parameters by
    structural name and the final hidden state, numpy)."""
    ex, model, trainer, loss_fn = word_lm_setup(
        mx, ctx, cfg, weights_seed=seed, hybridize=hybridize)
    with ctx:
        hidden = model.begin_state(func=mx.nd.zeros,
                                   batch_size=cfg["batch"], ctx=ctx)
        losses = []
        for x, y in word_lm_windows(ex, cfg, cfg["steps"], seed + 1):
            loss, hidden = word_lm_iteration(
                mx, model, trainer, loss_fn, mx.nd.array(x, ctx=ctx),
                mx.nd.array(y, ctx=ctx), hidden, cfg)
            losses.append(float(loss.mean().asnumpy()))
    state = {name: p.data().asnumpy()
             for name, p in model._collect_params_with_prefix().items()}
    for i, h in enumerate(hidden):
        state[f"hidden {i}"] = h.asnumpy()
    return losses, state


def word_lm_flop(cfg):
    """One iteration's FLOP in its products, from the shapes: per layer
    and token the gates' 2 x 4H x (I + H), the decoder's 2 x H x vocab,
    each backpropagated (3 x the forward). Returns (iteration,
    recurrent, decoder)."""
    tokens = cfg["bptt"] * cfg["batch"]
    rec = 0
    width_in = cfg["embed"]
    for _ in range(cfg["layers"]):
        rec += 2 * tokens * 4 * cfg["hidden"] * (width_in + cfg["hidden"])
        width_in = cfg["hidden"]
    dec = 2 * tokens * cfg["hidden"] * cfg["vocab"]
    return 3 * (rec + dec), 3 * rec, 3 * dec


def lstm_lm_full_width(torch, mx, smi):
    """The full-width LSTM LM on the card (`LM_FULL`, `LM_OPT`): the
    example's model and loop, ``model.rnn`` hybridized, fp32 (TF32 off),
    `LM_WARMUP` iterations then `LM_TIMED` timed ones (the loss read each
    iteration); checks (a) and the LM's part of (d). Returns the line and
    a function that runs one more iteration."""
    import numpy as np

    from mxnet_tpu_torch import observatory
    from mxnet_tpu_torch.ops import rnn as rnn_ops

    cfg = LM_FULL
    ctx = mx.gpu(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # what earlier phases still hold: the phase's own peak is above it
    held = torch.cuda.memory_allocated()
    mx.random.seed(0)
    ex, model, trainer, loss_fn = word_lm_setup(mx, ctx, cfg)
    params = sum(int(np.prod(p.shape))
                 for p in model.collect_params().values())
    pool = [(mx.nd.array(x, ctx=ctx), mx.nd.array(y, ctx=ctx))
            for x, y in word_lm_windows(ex, cfg, LM_POOL)]
    state = {"i": 0, "hidden": model.begin_state(
        func=mx.nd.zeros, batch_size=cfg["batch"], ctx=ctx)}

    def one():
        x, y = pool[state["i"] % LM_POOL]
        state["i"] += 1
        loss, state["hidden"] = word_lm_iteration(
            mx, model, trainer, loss_fn, x, y, state["hidden"], cfg)
        return loss

    rnn_ops.reset_routes()
    losses, wall, host = [], [], []
    captures = None
    for i in range(LM_WARMUP + LM_TIMED):
        if i == LM_WARMUP:
            captures = model.rnn._cached_op.captures
        t0 = time.perf_counter()
        loss = one()
        t1 = time.perf_counter()
        losses.append(float(loss.mean().asnumpy()))
        t2 = time.perf_counter()
        if i >= LM_WARMUP:
            host.append(t1 - t0)
            wall.append(t2 - t0)
    after = model.rnn._cached_op.captures
    routes = dict(rnn_ops.ROUTE_CALLS)
    peak = torch.cuda.max_memory_allocated()
    timed = losses[LM_WARMUP:]
    ppl = [math.exp(v) for v in timed]
    # (a): finite losses; the perplexity falls over the timed iterations
    check(all(math.isfinite(v) for v in losses),
          f"lstm_lm: a non-finite loss in {losses}")
    first, last = statistics.mean(ppl[:LM_POOL]), statistics.mean(
        ppl[-LM_POOL:])
    check(last < first, f"lstm_lm: perplexity {first} over the first "
          f"{LM_POOL} timed iterations, {last} over the last {LM_POOL}")
    # (d): every capture in the warm-up
    check(after == captures, f"lstm_lm: {captures} captures after the "
          f"warm-up, {after} after the timed iterations")
    flop, rec_flop, dec_flop = word_lm_flop(cfg)
    iter_ms = statistics.median(wall) * 1e3
    peak_fp32 = observatory.peaks()["matmul_flops"]["float32"]
    bound_ms = flop / peak_fp32 * 1e3
    tokens = cfg["bptt"] * cfg["batch"]
    return {"config": dict(cfg, **LM_OPT, optimizer="sgd", tied=False,
                           dtype="float32, TF32 off",
                           hybridized="model.rnn"),
            "source": "Zaremba, Sutskever and Vinyals 2014 (large); MXNet "
                      "example/gluon/word_language_model/train.py batch 32; "
                      "WikiText-2 vocabulary",
            "data": f"the example's synthetic_corpus, {LM_POOL} bptt "
                    f"windows cycled",
            "warmup": LM_WARMUP, "timed": LM_TIMED, "losses": losses,
            "perplexity_first_last": [first, last],
            "iteration_ms": [w * 1e3 for w in wall],
            "median_iteration_ms": iter_ms,
            "tokens_per_s": tokens / iter_ms * 1e3,
            "median_host_ms": statistics.median(host) * 1e3,
            "iteration_flop": flop, "recurrent_flop": rec_flop,
            "decoder_flop": dec_flop, "peak_fp32_flops": peak_fp32,
            "bound_ms": bound_ms, "bound_by": "operations",
            "bound_share": bound_ms / iter_ms,
            "sheet_bound_share": flop / PEAK_FLOPS["float32"] * 1e3
            / iter_ms,
            "parameters": params, "captures": after,
            "signatures": {str(k[:2]): n for k, n in
                           model.rnn._cached_op.instances().items()},
            "rnn_route_calls": routes,
            "peak_mem_gb": peak / 1e9, "held_at_start_gb": held / 1e9,
            "phase_peak_mem_gb": (peak - held) / 1e9, "card": smi}, one


def rnn_route_check(torch, cfg=LM_FULL):
    """Check (c): the `RNN` op at the full-width LM's shapes (data [bptt,
    batch, embed], both layers, random states, no dropout) on the card,
    its ``fused`` route (cuDNN) against its ``step`` route
    (``cudnn_off``): the output, both final states and the gradients of
    sum(output * cotangent) + the final states' sums to the data, the flat
    parameters and both initial states must agree within an absolute
    error of ``ROUTE_TOL`` x max(1, max |step route's value|) each, fp32
    with TF32 off: cuDNN's and cuBLAS's sums in other orders over 35
    steps. Also times each route's forward + backward and the repack of
    the flat vector into cuDNN's layout that each fused call makes
    (`torch._cudnn_rnn_flatten_weight` of each layer's views)."""
    from mxnet_tpu_torch.ops import rnn as rnn_ops

    T, N, I = cfg["bptt"], cfg["batch"], cfg["embed"]
    H, L = cfg["hidden"], cfg["layers"]
    gen = torch.Generator(device="cuda").manual_seed(14)
    n = rnn_ops.rnn_param_size(L, H, I, "lstm")
    x = torch.randn(T, N, I, device="cuda", generator=gen)
    w = torch.rand(n, device="cuda", generator=gen) * 0.08 - 0.04
    h0 = torch.randn(L, N, H, device="cuda", generator=gen) * 0.5
    c0 = torch.randn(L, N, H, device="cuda", generator=gen) * 0.5
    ct = torch.randn(T, N, H, device="cuda", generator=gen)
    attrs = {"state_size": H, "num_layers": L, "mode": "lstm",
             "state_outputs": True, "p": 0.0, "_train": True}

    def run(cudnn_off):
        ins = [t.clone().requires_grad_() for t in (x, w, h0, c0)]
        out, hT, cT = rnn_ops._rnn(None, *ins, cudnn_off=cudnn_off, **attrs)
        grads = torch.autograd.grad(
            (out * ct).sum() + hT.sum() + cT.sum(), ins)
        return [out, hT, cT] + list(grads)

    names = ["output", "hT", "cT", "grad data", "grad parameters",
             "grad h0", "grad c0"]
    fused, step = run(False), run(True)
    errs = {}
    for name, a, b in zip(names, fused, step):
        err = float((a - b).abs().max())
        scale = max(1.0, float(b.abs().max()))
        errs[name] = {"max_abs_err": err, "scale": scale}
        check(err <= ROUTE_TOL * scale,
              f"lstm_lm (c): fused vs step route, {name}: max err {err} "
              f"over {ROUTE_TOL} x {scale}")
    layers = rnn_ops._slice_params(w, L, H, I, "lstm", 1)

    def repack():
        for wi, wh, bi, bh, _ in layers:
            torch._cudnn_rnn_flatten_weight([wi, wh, bi, bh], 4,
                                            wi.shape[1], 2, H, 0, 1, False,
                                            False)

    return {"tol": ROUTE_TOL, "compared": errs,
            "fused_fwd_bwd_ms": cuda_ms(lambda: run(False)),
            "step_fwd_bwd_ms": cuda_ms(lambda: run(True)),
            "repack_ms": cuda_ms(repack),
            "repack_bytes": 2 * 4 * (n - L * 2 * 4 * H)}


# check (c)'s bound on |fused - step| over max(1, |step|); written before
# the first run on the card
ROUTE_TOL = 1e-4


def bucketing_sym_gen(mx, cfg):
    """`example/rnn/lstm_bucketing.py`'s ``sym_gen`` at ``cfg``'s widths:
    Embedding -> the fused `RNN` op (an LSTM over the flat
    ``lstm_parameters_weight``, zero begin states) -> FullyConnected ->
    SoftmaxOutput, NT batches."""
    from importlib import import_module

    rnn_param_size = import_module(mx.__name__ + ".ops.rnn").rnn_param_size
    L, H, E, V, B = (cfg["layers"], cfg["hidden"], cfg["embed"],
                     cfg["vocab"], cfg["batch"])

    def sym_gen(seq_len):
        data = mx.sym.Variable("data")
        label = mx.sym.Variable("softmax_label")
        embed = mx.sym.Embedding(data, input_dim=V, output_dim=E,
                                 name="embed")
        tnc = mx.sym.transpose(embed, axes=(1, 0, 2))
        rnn_params = mx.sym.Variable(
            "lstm_parameters_weight", shape=(rnn_param_size(L, H, E,
                                                            "lstm"),))
        h0 = mx.sym.zeros(shape=(L, B, H))
        c0 = mx.sym.zeros(shape=(L, B, H))
        rnn = mx.sym.RNN(tnc, rnn_params, h0, c0, state_size=H,
                         num_layers=L, mode="lstm", name="lstm")
        ntc = mx.sym.transpose(rnn, axes=(1, 0, 2))
        pred = mx.sym.FullyConnected(mx.sym.Reshape(ntc, shape=(-1, H)),
                                     num_hidden=V, name="pred")
        out = mx.sym.SoftmaxOutput(pred, mx.sym.Reshape(label, shape=(-1,)),
                                   name="softmax")
        return out, ("data",), ("softmax_label",)

    return sym_gen


def bucket_sentences(vocab, n, longest, seed=7):
    """Markov-chain sentences as `example/rnn/lstm_bucketing.py`'s
    ``synthetic_sentences`` makes them (two likely successors a word), at
    lengths drawn uniformly from 5 to ``longest``."""
    import numpy as np

    rng = np.random.RandomState(seed)
    nxt = rng.randint(0, vocab, size=(vocab, 2))
    out = []
    for _ in range(n):
        s = [int(rng.randint(vocab))]
        for _ in range(int(rng.randint(5, longest + 1)) - 1):
            s.append(int(nxt[s[-1], rng.randint(2)]) if rng.rand() < 0.9
                     else int(rng.randint(vocab)))
        out.append(s)
    return out


def bucketing_path(torch, mx, smi, cfg=BUCKET_CFG):
    """The bucketed LSTM LM through `BucketingModule` on the card at
    `BUCKET_CFG`: `rnn.BucketSentenceIter` over `bucket_sentences`,
    U(-0.1, 0.1) weights (the repo example's), SGD (`BUCKET_OPT`), each batch one
    `BucketingModule.fused_step` for ``cfg["epochs"]`` epochs. Check (d):
    each bucket's module holds exactly one captured step, all made in the
    first epoch. Prints each bucket's captures and steps, and the steps a
    second of the last epoch."""
    import random

    import numpy as np

    random.seed(0)
    np.random.seed(0)
    mx.random.seed(0)
    sents = bucket_sentences(cfg["vocab"], cfg["sentences"],
                             max(cfg["buckets"]))
    it = mx.rnn.BucketSentenceIter(sents, cfg["batch"],
                                   buckets=list(cfg["buckets"]),
                                   invalid_label=0)
    mod = mx.mod.BucketingModule(bucketing_sym_gen(mx, cfg),
                                 default_bucket_key=it.default_bucket_key,
                                 context=mx.gpu(0))
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(mx.init.Uniform(0.1))
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(BUCKET_OPT))
    metric = mx.metric.Perplexity(ignore_label=0)
    steps, epoch_s, captures_first = {}, [], None
    for epoch in range(cfg["epochs"]):
        it.reset()
        metric.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = 0
        for batch in it:
            check(mod.fused_step(batch), "lstm_lm: the bucket's fused step "
                  "declined")
            steps[batch.bucket_key] = steps.get(batch.bucket_key, 0) + 1
            n += 1
        metric.update([batch.label[0].reshape((-1,))], mod.get_outputs())
        torch.cuda.synchronize()
        epoch_s.append((n, time.perf_counter() - t0))
        if epoch == 0:
            captures_first = {k: m._exec._steps.misses
                              for k, m in mod._buckets.items()}
    captures = {k: m._exec._steps.misses for k, m in mod._buckets.items()}
    check(sorted(captures) == sorted(cfg["buckets"]),
          f"lstm_lm: buckets bound {sorted(captures)}, want "
          f"{list(cfg['buckets'])}")
    check(all(v == 1 for v in captures.values())
          and captures == captures_first,
          f"lstm_lm (d): captures per bucket {captures} (after the first "
          f"epoch {captures_first}), want one each in the first epoch")
    ppl = metric.get()[1]
    check(math.isfinite(ppl), f"lstm_lm: bucketed perplexity {ppl}")
    n, secs = epoch_s[-1]
    return {"config": dict(cfg, **BUCKET_OPT, optimizer="sgd",
                           buckets=list(cfg["buckets"])),
            "source": "MXNet example/rnn/bucketing/lstm_bucketing.py "
                      "defaults; synthetic vocabulary 10,000",
            "captures_per_bucket": {str(k): v for k, v in
                                    sorted(captures.items())},
            "steps_per_bucket": {str(k): v for k, v in
                                 sorted(steps.items())},
            "last_epoch_steps": n, "last_epoch_s": secs,
            "steps_per_s": n / secs, "last_batch_perplexity": ppl,
            "card": smi}


def run_word_lm_example(argv, ctx=None):
    """`example/gluon/word_language_model.py` through the port with only
    its imports changed, under ``argv``. Returns its ``final
    perplexity``."""
    return run_example(example_namespace(WORD_LM_EXAMPLE, 3), argv, ctx)


def run_bucketing_example(argv, ctx=None):
    """`example/rnn/lstm_bucketing.py` through the port with its two
    imports changed and its module's ``context=mx.cpu()`` made the
    context it runs in (``ctx``, default the card). Returns its
    ``final-perplexity``."""
    ns = example_namespace(BUCKETING_EXAMPLE, 2, subs=[
        ("context=mx.cpu()", "context=mx.current_context()")])
    return run_example(ns, argv, ctx)


def lstm_lm_phase(torch, smi):
    """Slice 14's path: the full-width LSTM LM (`lstm_lm_full_width`,
    checks (a) and (d)), one more iteration under torch.profiler (host
    launch calls, idle share), check (c) (`rnn_route_check`), the
    bucketed path (`bucketing_path`, check (d)), the repo's two examples
    at their defaults through the port (e), and check (b): the small LSTM
    LM on the card against the CPU. (f): no kernel launch. Returns the
    line and the profile."""
    import numpy as np

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import rnn as rnn_ops

    reset_launches()
    full, one_more = lstm_lm_full_width(torch, mx, smi)
    bucketed = bucketing_path(torch, mx, smi)
    launches = read_launches()
    check(not any(launches.values()),
          f"the lstm_lm path launched kernels: {launches}")
    profile = profile_step(torch, one_more, must_run=("matmul",))
    full["host_launch_calls"] = profile["host_launch_calls"]
    full["idle_share"] = profile["idle_share"]
    full["profile"] = profile_summary(profile)
    routes = rnn_route_check(torch)
    rnn_ops.reset_routes()
    word_lm = run_word_lm_example(["--vocab", str(WORD_LM_VOCAB)],
                                  ctx=mx.gpu(0))
    bucket_ex = run_bucketing_example([], ctx=mx.gpu(0))
    example_routes = dict(rnn_ops.ROUTE_CALLS)
    vocab = WORD_LM_VOCAB
    check(word_lm.get("final perplexity", math.inf) < vocab / 4,
          f"lstm_lm (e): the word LM example's figures {word_lm}")
    check(bucket_ex.get("final-perplexity", math.inf) < BUCKETING_PPL,
          f"lstm_lm (e): the bucketing example's figures {bucket_ex}")
    card = word_lm_small_run(mx, mx.gpu(0))
    cpu = word_lm_small_run(mx, mx.cpu())
    worst = 0.0
    pairs = [("losses", np.asarray(card[0]), np.asarray(cpu[0]))]
    pairs += [(k, v, cpu[1][k]) for k, v in card[1].items()]
    for what, a, b in pairs:
        err = float(np.abs(a - b).max())
        worst = max(worst, err)
        check(np.allclose(a, b, **LM_SMALL_TOL),
              f"lstm_lm small card vs CPU: {what} max err {err} over "
              f"{LM_SMALL_TOL}")
    return {"full_width": full, "bucketing": bucketed,
            "routes_card": routes, "kernel_launches": launches,
            "examples": {"word_language_model": dict(
                word_lm, bound=vocab / 4, argv="--vocab 100, else its "
                "defaults: embed 64, hidden 128, 2 layers, batch 16, bptt "
                "16, 6 epochs"), "lstm_bucketing": dict(
                bucket_ex, bound=BUCKETING_PPL, argv="defaults: 1 layer, "
                "hidden 64, embed 32, vocab 60, 600 sentences, 3 epochs, "
                "adam"), "rnn_route_calls": example_routes},
            "small_card_vs_cpu": {"config": LM_SMALL,
                                  "compared": len(pairs),
                                  "max_abs_err": worst,
                                  "tol": LM_SMALL_TOL}}, profile


# the sparse storage path (slice 15): the repo's two sparse examples'
# models at the widths of MXNet 1.5's example/sparse configurations
SPARSE_LINEAR = {"features": 1_000_001, "batch": 8192, "nnz": 32, "lr": 0.5}
SPARSE_MF = {"users": 71_569, "items": 65_135, "factor": 128, "batch": 128,
             "lr": 1.0}
SPARSE_POOL = 4  # batches made once and cycled
SPARSE_WARMUP = 3
SPARSE_TIMED = 20
SPARSE_SMALL = {"linear": {"features": 301, "batch": 16, "nnz": 4,
                           "lr": 0.5},
                "mf": {"users": 200, "items": 150, "factor": 8, "batch": 32,
                       "lr": 1.0}}
SPARSE_SMALL_OPTS = {"sgd": {"momentum": 0.9, "wd": 1e-4},
                     "adam": {"learning_rate": 0.01, "wd": 1e-4}}
SPARSE_SMALL_STEPS = 2
SPARSE_SMALL_TOL = {"rtol": 1e-5, "atol": 1e-7}  # card against CPU
SPARSE_LAZY_TOL = {"rtol": 1e-6, "atol": 1e-7}   # lazy against dense
SPARSE_STORE_TOL = {"rtol": 1e-6, "atol": 1e-6}  # dist_sync against device
LINEAR_EXAMPLE = "example/sparse/linear_classification.py"
LINEAR_EXAMPLE_ACC = 0.9  # the example's own assert
MF_EXAMPLE = "example/recommenders/matrix_fact.py"
MF_EXAMPLE_EPOCHS = 25
# tests/python/unittest/test_examples.py:209-215 holds the JAX package to
# 0.6 at 25 epochs. It meets it because its initializers draw from a numpy
# RandomState that `mx.random.seed(0)` seeds (`mxnet_tpu/initializer.py:17`,
# `random.py:102`), the very stream the example's data come from
# (`np.random.RandomState(args.seed)`), so its user table starts at 0.1 x
# the true user factors. The port's draws are torch's: from unrelated
# initial weights the example ends at 0.49-0.90 after 25 epochs (eight
# draws on the CPU). It is held to half the RMSE of predicting zero
# (sqrt(rank 8) = 2.83 for unit factors), and 0.6 is reported beside it.
MF_EXAMPLE_RMSE_JAX = 0.6
MF_EXAMPLE_RMSE = 0.5 * math.sqrt(8)


def sparse_linear_data(cfg, n, seed=0):
    """`linear_classification.py`'s generator at ``cfg``'s width: ``n`` rows
    of ``nnz`` feature ids (float32, as its NDArrayIter feeds them) and the
    sign of a hidden weight's sum over them as the label."""
    import numpy as np

    rng = np.random.RandomState(seed)
    idx = rng.randint(0, cfg["features"], (n, cfg["nnz"])).astype(np.float32)
    w_true = rng.randn(cfg["features"]).astype(np.float32)
    y = (w_true[idx.astype(np.int64)].sum(axis=1) > 0).astype(np.float32)
    return [idx, y]


def sparse_mf_data(cfg, n, seed=0):
    """`matrix_fact.py`'s generator at ``cfg``'s width: N(0, 1) user and item
    factors of rank ``factor``, ``n`` random (user, item) pairs and their
    products plus N(0, 0.1) noise as ratings."""
    import numpy as np

    rng = np.random.RandomState(seed)
    u_true = rng.normal(0, 1, (cfg["users"], cfg["factor"]))
    v_true = rng.normal(0, 1, (cfg["items"], cfg["factor"]))
    users = rng.randint(0, cfg["users"], n)
    items = rng.randint(0, cfg["items"], n)
    ratings = ((u_true[users] * v_true[items]).sum(axis=1)
               + rng.normal(0, 0.1, n)).astype(np.float32)
    return [users.astype(np.float32), items.astype(np.float32), ratings]


def sparse_batches(kind, cfg, n, seed=0):
    """``n`` batches of the ``kind`` model's data, numpy: [ids, labels] or
    [users, items, ratings] each."""
    make = sparse_linear_data if kind == "linear" else sparse_mf_data
    cols = make(cfg, n * cfg["batch"], seed)
    b = cfg["batch"]
    return [[c[k * b:(k + 1) * b] for c in cols] for k in range(n)]


def sparse_model(mx, ctx, kind, cfg, opt="sgd", opt_params=None,
                 kvstore="device"):
    """The repo example's model on ``ctx`` at ``cfg``'s width, on either
    package: ``linear`` is `linear_classification.py`'s `SparseLinear` (a
    `SparseEmbedding(features, 1)` summed over the active features,
    initialized to zero), ``mf`` `matrix_fact.py`'s `MFNet` (four
    ``Embedding(sparse_grad=True)`` tables, Normal(0.1)); a `gluon.Trainer`
    at the config's rate with ``lazy_update``. Returns (net, trainer, loss
    function or None)."""
    port = mx.__name__ == "mxnet_tpu_torch"
    if kind == "linear":
        ns = example_namespace(LINEAR_EXAMPLE, 5, port=port)
        net = ns["SparseLinear"](cfg["features"])
        net.initialize(mx.init.Zero(), ctx=ctx)
        loss_fn = mx.gluon.loss.SigmoidBinaryCrossEntropyLoss()
    else:
        ns = example_namespace(MF_EXAMPLE, 3, port=port)
        net = ns["MFNet"](cfg["users"], cfg["items"], cfg["factor"])
        net.initialize(mx.init.Normal(0.1), ctx=ctx)
        loss_fn = None
    params = {"learning_rate": cfg["lr"], "lazy_update": True,
              **(opt_params or {})}
    trainer = mx.gluon.Trainer(net.collect_params(), opt, params,
                               kvstore=kvstore)
    return net, trainer, loss_fn


def sparse_forward_backward(mx, net, loss_fn, batch):
    """The examples' loop body up to the backward, on NDArray batches:
    ``linear`` the sigmoid cross-entropy of the summed weights, ``mf`` the
    mean squared error of the ratings. Returns the loss."""
    with mx.autograd.record():
        if loss_fn is not None:
            x, y = batch
            loss = loss_fn(net(x).reshape((-1,)), y)
        else:
            u, i, r = batch
            loss = ((net(u, i) - r) ** 2).mean()
    loss.backward()
    return loss


def sparse_rescale(kind, batch):
    """What the examples pass `trainer.step`: the batch size for
    ``linear`` (a per-sample loss), 1 for ``mf`` (a mean)."""
    return batch[0].shape[0] if kind == "linear" else 1


def sparse_opt_states(trainer, names):
    """{name: numpy} of the trainer's optimizer states on either package:
    ``mom <param>`` for SGD's momentum, ``mean`` / ``var`` for Adam's."""
    upd = getattr(trainer, "_updater", None) or trainer._updaters[0]
    out = {}
    for i, state in upd.states.items():
        if state is None:
            continue
        if isinstance(state, (tuple, list)):
            out[f"mean {names[i]}"] = _to_numpy(state[0])
            out[f"var {names[i]}"] = _to_numpy(state[1])
        else:
            out[f"mom {names[i]}"] = _to_numpy(state)
    return out


def sparse_small_run(mx, ctx, kind, opt, seed=0):
    """Check (b)'s run and the CPU test's: the ``kind`` model at
    `SPARSE_SMALL`'s width from uniform numpy weights of ``seed``,
    `SPARSE_SMALL_STEPS` steps of `SPARSE_SMALL_OPTS`'s ``opt`` over numpy
    batches. Returns (losses, {each weight, each optimizer state and each
    step's gradient indices: numpy})."""
    import numpy as np

    cfg = SPARSE_SMALL[kind]
    net, trainer, loss_fn = sparse_model(mx, ctx, kind, cfg, opt=opt,
                                         opt_params=SPARSE_SMALL_OPTS[opt])
    params = net._collect_params_with_prefix()
    rng = np.random.RandomState(seed)
    for name in sorted(params):
        p = params[name]
        p.set_data(mx.nd.array(rng.uniform(-0.5, 0.5, p.shape)
                               .astype(np.float32), ctx=ctx))
    state, losses = {}, []
    for s, batch in enumerate(sparse_batches(kind, cfg, SPARSE_SMALL_STEPS,
                                             seed + 1)):
        batch = [mx.nd.array(c, ctx=ctx) for c in batch]
        loss = sparse_forward_backward(mx, net, loss_fn, batch)
        losses.append(loss.asnumpy())
        for name, p in params.items():
            state[f"indices {name} {s}"] = p.grad().indices.asnumpy()
        trainer.step(sparse_rescale(kind, batch))
    for name, p in params.items():
        state[f"weight {name}"] = p.data().asnumpy()
    full = net.collect_params()
    structural = {id(p): k for k, p in params.items()}
    names = [structural[id(full[k])] for k in sorted(full.keys())]
    state.update(sparse_opt_states(trainer, names))
    return losses, state


def sparse_compare(what, got, want, tol):
    """Check every array of ``want`` against ``got``: index sets exactly,
    the rest within ``tol``. Returns (arrays compared, worst abs error)."""
    import numpy as np

    check(sorted(got) == sorted(want), f"{what}: keys {sorted(got)} vs "
          f"{sorted(want)}")
    worst = 0.0
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        check(a.shape == b.shape, f"{what}: {k} shape {a.shape} vs "
              f"{b.shape}")
        if k.startswith("indices"):
            check(np.array_equal(a, b), f"{what}: {k} {a} vs {b}")
            continue
        err = float(np.abs(a - b).max()) if a.size else 0.0
        worst = max(worst, err)
        check(np.allclose(a, b, **tol), f"{what}: {k} max err {err} over "
              f"{tol}")
    return len(want), worst


def count_syncs(torch, fn):
    """The host syncs a call of ``fn`` makes on the card: the warnings of
    `torch.cuda.set_sync_debug_mode("warn")` while it runs."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in seen)


def sparse_lookups(kind, cfg):
    """Rows each table's forward gathers a step."""
    return cfg["batch"] * (cfg["nnz"] if kind == "linear" else 1)


def sparse_full_width(torch, mx, kind, smi, kvstore="device", init=None):
    """The ``kind`` model at full width on the card (`SPARSE_LINEAR` or
    `SPARSE_MF`), fp32, through ``kvstore``, from the example's initializer
    after seed 0 or the tensors ``init`` (by structural name):
    `SPARSE_WARMUP` steps then `SPARSE_TIMED` timed ones over
    `SPARSE_POOL` batches cycled (the loss read each step); check (a).
    Returns the line, a function running one more step, the initial
    tensors and the final weights."""
    import statistics as stats

    import numpy as np

    from mxnet_tpu_torch import observatory
    from mxnet_tpu_torch.ndarray.sparse import RowSparseNDArray
    from mxnet_tpu_torch.optimizer.optimizer import (_sparse_sgd_update,
                                                     sgd_update)

    cfg = SPARSE_LINEAR if kind == "linear" else SPARSE_MF
    ctx = mx.gpu(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    mx.random.seed(0)
    net, trainer, loss_fn = sparse_model(mx, ctx, kind, cfg, kvstore=kvstore)
    params = net._collect_params_with_prefix()
    if init is not None:
        for name, p in params.items():
            p.set_data(mx.nd.NDArray(init[name]))
    w0 = {name: p.data()._data.detach().clone()
          for name, p in params.items()}
    pool_np = sparse_batches(kind, cfg, SPARSE_POOL, seed=0)
    pool = [[mx.nd.array(c, ctx=ctx) for c in b] for b in pool_np]
    # the rows some batch of the pool touches, by table
    touched = {}
    for name, p in params.items():
        col = 1 if name.startswith("item") else 0
        ids = np.unique(np.concatenate([b[col] for b in pool_np]))
        mask = torch.zeros(p.shape[0], dtype=torch.bool, device="cuda")
        mask[torch.as_tensor(ids.astype(np.int64), device="cuda")] = True
        touched[name] = mask
    state = {"i": 0}

    def one(after_backward=None):
        batch = pool[state["i"] % SPARSE_POOL]
        state["i"] += 1
        loss = sparse_forward_backward(mx, net, loss_fn, batch)
        if after_backward is not None:
            after_backward()
        trainer.step(sparse_rescale(kind, batch))
        return loss

    def check_grads(when):
        for name, p in params.items():
            g = p.grad()
            check(isinstance(g, RowSparseNDArray) and not g.densified(),
                  f"sparse {kind} (a): {name}'s gradient {type(g).__name__}"
                  f" densified={getattr(g, 'densified', lambda: None)()} "
                  f"{when}")

    rows, losses, wall, host = [], [], [], []

    def after_backward():
        check_grads("after backward")
        rows.append({name: p.grad().indices.shape[0]
                     for name, p in params.items()})

    for it in range(SPARSE_WARMUP + SPARSE_TIMED):
        t0 = time.perf_counter()
        loss = one(after_backward)
        t1 = time.perf_counter()
        losses.append(float(loss.mean().asnumpy()))
        t2 = time.perf_counter()
        check_grads("after trainer.step")
        if it >= SPARSE_WARMUP:
            host.append(t1 - t0)
            wall.append(t2 - t0)
    last_grads = {name: p.grad().copy() for name, p in params.items()}
    net.collect_params().zero_grad()
    check_grads("after zero_grad")
    check(all(p.grad().indices.shape[0] == 0 for p in params.values()),
          f"sparse {kind} (a): zero_grad left rows")
    peak = torch.cuda.max_memory_allocated()
    # (a): untouched rows bit-equal to their initial values; the loss falls
    for name, p in params.items():
        keep = ~touched[name]
        check(torch.equal(p.data()._data.detach()[keep], w0[name][keep]),
              f"sparse {kind} (a): untouched rows of {name} moved")
    check(all(math.isfinite(v) for v in losses),
          f"sparse {kind}: a non-finite loss in {losses}")
    timed = losses[SPARSE_WARMUP:]
    first, last = stats.mean(timed[:4]), stats.mean(timed[-4:])
    check(last < first, f"sparse {kind} (a): loss {first} over the first 4 "
          f"timed steps, {last} over the last 4")
    step_ms = stats.median(wall) * 1e3
    syncs = count_syncs(torch, lambda: one(after_backward))
    # what the lazy update avoids: a dense SGD update of the same tables
    # (weight and gradient read, weight written), on copies
    tables = [(p.data()._data.detach().clone(), last_grads[name])
              for name, p in params.items()]
    dense_grads = [torch.zeros_like(w) for w, _ in tables]

    def dense_update():
        for (w, _), g in zip(tables, dense_grads):
            w.copy_(sgd_update(w, g, lr=cfg["lr"]))

    def lazy_update():
        for w, g in tables:
            _sparse_sgd_update(w, g, None, cfg["lr"], 0.0, 1.0, None, 0.0)

    dense_ms = cuda_ms(dense_update)
    lazy_ms = cuda_ms(lazy_update)
    del tables, dense_grads
    timed_rows = rows[SPARSE_WARMUP:SPARSE_WARMUP + SPARSE_TIMED]
    med_rows = {name: stats.median(r[name] for r in timed_rows)
                for name in params}
    widths = {name: int(np.prod(p.shape[1:])) for name, p in params.items()}
    lookups = sparse_lookups(kind, cfg)
    step_bytes = sum((lookups + 2 * med_rows[n]) * widths[n] * 4
                     for n in params)
    copy_rate = observatory.peaks()["hbm_bytes_per_s"]
    bound_ms = step_bytes / copy_rate * 1e3
    samples = cfg["batch"]
    final = {name: p.data()._data.detach().clone()
             for name, p in params.items()}
    line = {
        "config": dict(cfg, dtype="float32", optimizer="sgd, lazy_update",
                       kvstore=kvstore),
        "parameters": {n: list(p.shape) for n, p in params.items()},
        "table_mib": sum(p.data()._data.numel() * 4
                         for p in params.values()) / 2 ** 20,
        "warmup": SPARSE_WARMUP, "timed": SPARSE_TIMED, "pool": SPARSE_POOL,
        "losses": losses, "loss_first_last": [first, last],
        "step_ms": [w * 1e3 for w in wall], "median_step_ms": step_ms,
        "steps_per_s": 1e3 / step_ms,
        "samples_per_s": samples / step_ms * 1e3,
        "median_host_ms": stats.median(host) * 1e3,
        "rows_touched_median": med_rows,
        "rows_touched_min_max": {n: [min(r[n] for r in timed_rows),
                                     max(r[n] for r in timed_rows)]
                                 for n in params},
        "rows_touched_per_step": rows,
        "lookups_per_table": lookups,
        "host_syncs_per_step": syncs,
        "dense_update_ms": dense_ms, "lazy_update_ms": lazy_ms,
        "step_bytes": step_bytes, "copy_bytes_per_s": copy_rate,
        "bound_ms": bound_ms, "bound_by": "bytes",
        "bound_is": "(rows gathered + rows updated + rows written) x width "
                    "x 4 B at the observatory's measured copy rate",
        "bound_share": bound_ms / step_ms,
        "peak_mem_gb": peak / 1e9, "held_at_start_gb": held / 1e9,
        "phase_peak_mem_gb": (peak - held) / 1e9, "card": smi}
    return line, one, w0, final


def lazy_vs_dense(torch, mx, opt, rows=128, seed=0):
    """Check (c): on the card, a lazy update of a row-sparse gradient
    against the dense update of the same gradient densified, two steps on
    the same ``rows`` (drawn, deduplicated) of a table of `SPARSE_MF`'s
    user table's shape, from a prefilled optimizer state: equal on the
    touched rows within `SPARSE_LAZY_TOL` (elsewhere the dense update moves
    rows by their momentum and weight decay), and the untouched rows of the
    weight and the states bit-equal to before. Returns the worst error on
    the touched rows."""
    from mxnet_tpu_torch.ndarray.sparse import RowSparseNDArray

    shape = (SPARSE_MF["users"], SPARSE_MF["factor"])
    gen = torch.Generator(device="cuda").manual_seed(seed)
    w0 = torch.randn(shape, generator=gen, device="cuda")
    params = {"learning_rate": 0.1, "wd": 1e-4, "lazy_update": True,
              **({"momentum": 0.9} if opt == "sgd" else {})}
    runs = {}
    for mode in ("lazy", "dense"):
        updater = mx.optimizer.get_updater(mx.optimizer.create(opt, **params))
        w = mx.nd.NDArray(w0.clone())
        updater.ensure_states([0], [w])
        st = updater.states[0]
        states = list(st) if isinstance(st, tuple) else [st]
        for t in states:  # a moment or momentum every row already has
            t.copy_(torch.rand(shape, generator=torch.Generator(
                device="cuda").manual_seed(seed + 1), device="cuda"))
        before = [t.clone() for t in states]
        g = torch.Generator(device="cuda").manual_seed(seed + 2)
        idx = torch.unique(torch.randint(0, shape[0], (rows,), generator=g,
                                         device="cuda"))
        for step in range(2):
            vals = torch.randn((idx.shape[0], shape[1]), generator=g,
                               device="cuda")
            grad = RowSparseNDArray(vals, idx, shape)
            if mode == "dense":
                grad = mx.nd.NDArray(grad._data)
            updater(0, grad, w)
        runs[mode] = (w._data, states, before)
    hit = torch.zeros(shape[0], dtype=torch.bool, device="cuda")
    hit[idx] = True
    (lw, ls, lb), (dw, ds, _) = runs["lazy"], runs["dense"]
    worst = 0.0
    for a, b in [(lw, dw)] + list(zip(ls, ds)):
        err = float((a[hit] - b[hit]).abs().max())
        worst = max(worst, err)
        check(torch.allclose(a[hit], b[hit], **SPARSE_LAZY_TOL),
              f"sparse (c) {opt}: lazy against dense on the touched rows, "
              f"max err {err} over {SPARSE_LAZY_TOL}")
    check(torch.equal(lw[~hit], w0[~hit]),
          f"sparse (c) {opt}: the lazy update moved untouched weight rows")
    for t, t0 in zip(ls, lb):
        check(torch.equal(t[~hit], t0[~hit]),
              f"sparse (c) {opt}: the lazy update moved untouched state rows")
    return worst


def run_linear_example(argv, ctx=None):
    """`example/sparse/linear_classification.py` through the port with only
    its five imports changed. Returns its ``final train accuracy`` (it
    asserts > 0.9 itself)."""
    return run_example(example_namespace(LINEAR_EXAMPLE, 5), argv, ctx)


def run_mf_example(argv, ctx=None):
    """`example/recommenders/matrix_fact.py` through the port with only its
    three imports changed. Returns its ``final_rmse`` and
    ``embedding_grad_stype``."""
    return run_example(example_namespace(MF_EXAMPLE, 3), argv, ctx,
                       parse=True, text_keys=("embedding_grad_stype",))


def sparse_phase(torch, smi):
    """Slice 15's path: `linear` and `mf` at full width (`sparse_full_width`,
    check (a)), `mf` again through a one-rank NCCL ``dist_sync`` store from
    the same weights (d), one more step of each under torch.profiler (host
    launch calls, idle share), the lazy updates against dense ones (c), the
    repo's two sparse examples through the port (e), and check (b): both
    small models with SGD and with Adam, card against CPU. (f): no kernel
    launch. Returns the line."""
    import numpy as np
    import torch.distributed as dist

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import telemetry

    reset_launches()
    linear, linear_one, _, _ = sparse_full_width(torch, mx, "linear", smi)
    mf, mf_one, mf_init, mf_final = sparse_full_width(torch, mx, "mf", smi)
    launches = read_launches()
    with one_rank_group_env() as env:
        try:
            tele_was = telemetry.enabled()
            telemetry.reset()
            telemetry.enable()
            mf_dist, mf_dist_one, _, dist_final = sparse_full_width(
                torch, mx, "mf", smi, kvstore="dist_sync", init=mf_init)
            pushed = counter("kvstore.push_bytes")
            telemetry.enable(tele_was)
            telemetry.reset()
            dist_profile = profile_step(torch, mf_dist_one, must_run=())
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
    dist_launches = read_launches()
    check(not any(launches.values()) and not any(dist_launches.values()),
          f"the sparse path launched kernels: {launches}, {dist_launches}")
    # (d): the dist store's weights equal the local ones; its push counts
    # the stored rows and indices only
    worst = 0.0
    for name, w in mf_final.items():
        err = float((dist_final[name] - w).abs().max())
        worst = max(worst, err)
        check(torch.allclose(dist_final[name], w, **SPARSE_STORE_TOL),
              f"sparse (d): {name} through dist_sync against device, max "
              f"err {err}")
    widths = {n: int(math.prod(shape[1:]))
              for n, shape in mf_dist["parameters"].items()}
    want = sum(r[n] * (widths[n] * 4 + 4)
               for r in mf_dist["rows_touched_per_step"] for n in widths)
    check(pushed == want, f"sparse (d): kvstore.push_bytes {pushed}, want "
          f"the pushed rows and indices' {want}")
    del mf_init, mf_final, dist_final
    mf_dist["push_bytes"] = pushed
    mf_dist["coordinator"] = env["MXNET_COORDINATOR"]
    for line, one in ((linear, linear_one), (mf, mf_one)):
        profile = profile_step(torch, one, must_run=())
        line["host_launch_calls"] = profile["host_launch_calls"]
        line["idle_share"] = profile["idle_share"]
        line["profile"] = profile_summary(profile)
    mf_dist["host_launch_calls"] = dist_profile["host_launch_calls"]
    mf_dist["idle_share"] = dist_profile["idle_share"]
    mf_dist["profile"] = profile_summary(dist_profile)
    lazy = {opt: lazy_vs_dense(torch, mx, opt) for opt in ("sgd", "adam")}
    linear_ex = run_linear_example([], ctx=mx.gpu(0))
    mf_ex = run_mf_example(["--epochs", str(MF_EXAMPLE_EPOCHS)],
                           ctx=mx.gpu(0))
    check(linear_ex.get("final train accuracy", 0) > LINEAR_EXAMPLE_ACC,
          f"sparse (e): the linear example's figures {linear_ex}")
    check(mf_ex.get("embedding_grad_stype") == "row_sparse"
          and mf_ex.get("final_rmse", math.inf) < MF_EXAMPLE_RMSE,
          f"sparse (e): the matrix factorization example's figures {mf_ex}")
    mf_ex["under_the_jax_bound"] = mf_ex["final_rmse"] < MF_EXAMPLE_RMSE_JAX
    small = {}
    for kind in ("linear", "mf"):
        for opt in ("sgd", "adam"):
            card = sparse_small_run(mx, mx.gpu(0), kind, opt)
            cpu = sparse_small_run(mx, mx.cpu(), kind, opt)
            got = dict(card[1], losses=np.stack(card[0]))
            ref = dict(cpu[1], losses=np.stack(cpu[0]))
            n, err = sparse_compare(f"sparse (b) {kind} {opt} card vs CPU",
                                    got, ref, SPARSE_SMALL_TOL)
            small[f"{kind} {opt}"] = {"compared": n, "max_abs_err": err}
    return {"linear": linear, "mf": mf, "mf_dist_sync": mf_dist,
            "dist_vs_device_max_abs_err": worst,
            "dist_vs_device_tol": SPARSE_STORE_TOL,
            "lazy_vs_dense_max_abs_err": lazy,
            "lazy_vs_dense_tol": SPARSE_LAZY_TOL,
            "kernel_launches": launches,
            "examples": {"linear_classification": dict(
                linear_ex, bound=LINEAR_EXAMPLE_ACC, argv="defaults: "
                "100,000 features, 32 active, batch 64, 3 epochs, lr 0.5"),
                "matrix_fact": dict(
                mf_ex, bound=MF_EXAMPLE_RMSE,
                jax_bound=MF_EXAMPLE_RMSE_JAX, argv=f"--epochs "
                f"{MF_EXAMPLE_EPOCHS}, else its defaults: 200 users, 150 "
                "items, rank 8, batch 256, lr 1.0")},
            "small_card_vs_cpu": {"config": SPARSE_SMALL,
                                  "optimizers": SPARSE_SMALL_OPTS,
                                  "steps": SPARSE_SMALL_STEPS,
                                  "tol": SPARSE_SMALL_TOL, **small},
            "card": smi}


# -- slice 16: the image input pipeline and the vision model zoo -------------

# BASELINE.json's second configuration, example/image-classification's
# ResNet-50 on ImageNet (Gluon, hybridized, kvstore=device): 512 records of
# 256 x 320 x 3 uint8 pixels (about ImageNet's 4:5 aspect), 1000 classes,
# batch 32 at 224 x 224; example/gluon/image_classification.py's SGD
VISION_RECORDS = 512
VISION_IMAGE = (256, 320, 3)
VISION_CLASSES = 1000
VISION_BATCH = 32
VISION_CROP = 224
VISION_OPT = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}
VISION_WARMUP = 3
VISION_TIMED = 20
VISION_POOL = 4          # device-resident batches of the ceiling run
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# each family at full width: (name, input size, the JAX package's pinned
# parameter count, tests/python/unittest/test_model_zoo_strict.py:33-66)
VISION_FAMILIES = (("alexnet", 224, 61_100_840), ("vgg16", 224, 138_357_544),
                   ("squeezenet1.1", 224, 1_235_496),
                   ("mobilenet1.0", 224, 4_253_864),
                   ("mobilenetv2_1.0", 224, 3_539_136),
                   ("densenet121", 224, 8_062_504),
                   ("inceptionv3", 299, 23_869_000))
VISION_FAMILY_TIMED = 10
# the families' SGD: VGG's published rate (Simonyan and Zisserman 2015,
# 0.01); at the record-fed run's 0.05 vgg16, with no BatchNorm, diverged
# on random data within 10 steps (on an H100)
VISION_FAMILY_OPT = {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4}
# check (c)'s small models: (constructor, input shape, mode). "predict"
# holds a net with Dropout in predict mode (its masks cannot be matched);
# "train" trains; "witness" trains and is held to a float64 witness
# (`vision_witness_step`): at Xavier init the mobilenets' fp32 gradients
# follow which side of a ReLU or ReLU6 kink each element falls on, and
# one element moved across one by an fp32 rounding moves a gradient by up
# to 18 % of its scale (tools/torch_vision_witness.py)
VISION_SMALL = {
    "alexnet": (lambda v: v.AlexNet(classes=10), (2, 3, 64, 64), "predict"),
    "vgg_bn": (lambda v: v.VGG([1, 1, 1, 1, 1], [8, 16, 16, 32, 32],
                               classes=10, batch_norm=True),
               (2, 3, 32, 32), "predict"),
    "squeezenet1.1": (lambda v: v.SqueezeNet("1.1", classes=10),
                      (2, 3, 224, 224), "predict"),
    "mobilenet0.25": (lambda v: v.MobileNet(0.25, classes=10),
                      (4, 3, 128, 128), "witness"),
    "mobilenetv2_0.25": (lambda v: v.MobileNetV2(0.25, classes=10),
                         (4, 3, 128, 128), "witness"),
    "densenet": (lambda v: v.DenseNet(16, 8, (2, 2, 2, 2), classes=10),
                 (2, 3, 224, 224), "train"),
    "inceptionv3": (lambda v: v.Inception3(classes=10), (1, 3, 299, 299),
                    "predict"),
}
# a witnessed net: its float64 step, card against CPU, within
# `ND_SMALL_TOL`, gradients too; its fp32 step on the card against the
# CPU's float64 one, each array's error over its scale (the scale at least
# `floor` of the largest gradient's: a gradient that is zero in exact
# arithmetic is rounding alone in fp32): the output and the loss within
# `forward`, every gradient within `grad`, which only a gross fault
# passes (a kink crossed: up to 0.18)
VISION_WITNESS_TOL = {"forward": 1e-4, "grad": 0.5, "floor": 1e-3}
# the record-fed step's small form: 8 records of 40 x 48 x 3, batch 4 at
# 32 x 32 into the gluon phase's small ResNet (`GLUON_SMALL`, 10 classes)
VISION_SMALL_RECORDS = {"n": 8, "image": (40, 48, 3), "crop": 32,
                        "batch": 4, "classes": 10}
# the pipeline's float image ops, card against CPU: within 1e-4 of the
# output's largest magnitude (a tenth of a uint8 step on pixels; the
# antialiased resize's weights round differently on the card, 2.2e-3 on
# 0-255 pixels on an H100)
VISION_OP_TOL = {"of_largest": 1e-4}
IMAGE_CLS_EXAMPLE = "example/gluon/image_classification.py"
TRAIN_IMAGENET_EXAMPLE = "example/image-classification/train_imagenet.py"
FIT_MODULE = "example/image-classification/common/fit.py"


def vision_records(mod, folder, n, image, classes, seed=0):
    """``n`` uint8 images of shape ``image`` from ``seed`` with a blob keyed
    to the label (`example/image-classification/common/fit.py:54-62`: the
    row (label x 3) mod H of channel 0 lit), written by ``mod``'s
    `recordio` (either package) as raw pixels, ``pack(IRHeader(0, label,
    i, 0), img.tobytes())``, into an indexed ``.rec``. Returns its path and
    the labels."""
    import numpy as np

    rng = np.random.RandomState(seed)
    labels = rng.randint(0, classes, n)
    rec = os.path.join(folder, "images.rec")
    w = mod.MXIndexedRecordIO(os.path.join(folder, "images.idx"), rec, "w")
    for i, label in enumerate(labels):
        img = rng.randint(0, 256, image, dtype=np.uint8)
        img[(int(label) * 3) % image[0], :, 0] = 255
        w.write_idx(i, mod.pack(mod.IRHeader(0, float(label), i, 0),
                                img.tobytes()))
    w.close()
    return rec, labels


class RawImageRecord:
    """A record of raw pixels (`vision_records`) as (HWC uint8 CPU array,
    label), in package ``pkg`` (``"mxnet_tpu_torch"`` or ``"mxnet_tpu"``):
    the transform `vision_dataset` reads records through. Picklable, for
    `DataLoader` worker processes."""

    def __init__(self, pkg, image):
        self.pkg, self.image = pkg, tuple(image)

    def __call__(self, record):
        import importlib

        import numpy as np

        mx = importlib.import_module(self.pkg)
        header, payload = mx.recordio.unpack(record)
        img = np.frombuffer(payload, np.uint8).reshape(self.image)
        return (mx.nd.array(img, ctx=mx.cpu(), dtype="uint8"),
                np.float32(header.label))


def imagenet_transform(mx, crop):
    """gluon-cv's ImageNet training chain (scripts/classification/imagenet/
    train_imagenet.py) at ``crop``."""
    T = mx.gluon.data.vision.transforms
    return T.Compose([T.RandomResizedCrop(crop), T.RandomFlipLeftRight(),
                      T.RandomColorJitter(0.4, 0.4, 0.4),
                      T.RandomLighting(0.1), T.ToTensor(),
                      T.Normalize(IMAGENET_MEAN, IMAGENET_STD)])


def vision_dataset(mx, rec, image, crop):
    """`RecordFileDataset` over ``rec``, each record unpacked to a CPU
    image (`RawImageRecord`), the image through `imagenet_transform`."""
    pkg = mx.__name__
    return mx.gluon.data.RecordFileDataset(rec).transform(
        RawImageRecord(pkg, image)).transform_first(
        imagenet_transform(mx, crop))


def endless(loader):
    """The loader's batches, epoch after epoch; closing it stops the
    current epoch's workers."""
    while True:
        it = iter(loader)
        try:
            yield from it
        finally:
            if hasattr(it, "close"):
                it.close()


def vision_record_step(mx, ctx, rec, params_file, cfg=VISION_SMALL_RECORDS,
                       **loader_kw):
    """Check (c)'s record-fed step, on either package: the first batch of
    `vision_dataset` over ``rec`` through a `DataLoader` read in the
    calling thread (Python's and numpy's streams seeded, so the random
    transforms draw alike), moved to ``ctx``, one SGD step of the gluon
    phase's small ResNet (`gluon_small_net`) from ``params_file``. Returns
    {name: numpy} of the batch, the loss, the output and the weights after
    the step."""
    import random

    import numpy as np

    random.seed(0)
    np.random.seed(0)
    loader = mx.gluon.data.DataLoader(
        vision_dataset(mx, rec, cfg["image"], cfg["crop"]),
        batch_size=cfg["batch"], shuffle=True, last_batch="discard",
        **loader_kw)
    x, y = next(iter(loader))
    x, y = x.as_in_context(ctx), y.as_in_context(ctx)
    with ctx:
        net = gluon_small_net(mx)()
        net.load_parameters(params_file, ctx=ctx)
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   dict(VISION_OPT))
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        with mx.autograd.record():
            out = net(x)
            loss = loss_fn(out, y)
        loss.backward()
        trainer.step(cfg["batch"])
    state = {"batch": x.asnumpy(), "label": y.asnumpy(),
             "loss": loss.asnumpy(), "output": out.asnumpy()}
    state.update({f"param {k}": p.data().asnumpy()
                  for k, p in net._collect_params_with_prefix().items()})
    return state


def vision_small_step(mx, ctx, name, params_file, dtype="float32"):
    """Check (c) for one family: its small model (`VISION_SMALL`) on
    ``ctx`` in ``dtype`` from ``params_file`` (made by the CPU run when
    missing), one SGD step on a batch from seed 0, in predict mode for a
    net with Dropout. Returns {name: numpy} of the loss, the output, the
    gradients of a witnessed net, and the weights after."""
    import numpy as np

    make, shape, mode = VISION_SMALL[name]
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, shape).astype(np.float32)
    y = rng.randint(0, 10, shape[0]).astype(np.float32)
    with ctx:
        net = make(mx.gluon.model_zoo.vision)
        if os.path.exists(params_file):
            net.load_parameters(params_file, ctx=ctx)
        else:
            mx.random.seed(0)
            net.initialize(mx.init.Xavier(), ctx=ctx)
            net(mx.nd.array(x))
            net.save_parameters(params_file)
        if dtype != "float32":
            net.cast(dtype)
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   dict(VISION_OPT))
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        with mx.autograd.record(train_mode=mode != "predict"):
            out = net(mx.nd.array(x, dtype=dtype))
            loss = loss_fn(out, mx.nd.array(y, dtype=dtype))
        loss.backward()
        params = net._collect_params_with_prefix()
        grads = {} if mode != "witness" else {
            f"grad {k}": p.grad().asnumpy() for k, p in params.items()
            if p.grad_req != "null"}
        trainer.step(shape[0])
    state = {"loss": loss.asnumpy(), "output": out.asnumpy(), **grads}
    state.update({f"param {k}": p.data().asnumpy()
                  for k, p in params.items()})
    return state


def vision_witness_errors(got, witness, floor):
    """{name: max |got - witness| over the witness's scale}, the scale at
    least ``floor`` of the largest gradient scale."""
    import numpy as np

    top = max(float(np.abs(v).max()) for k, v in witness.items()
              if k.startswith("grad "))
    errs = {}
    for k, w in witness.items():
        w = np.asarray(w, np.float64)
        scale = max(float(np.abs(w).max()) if w.size else 0.0, floor * top)
        errs[k] = float(np.abs(np.asarray(got[k], np.float64) - w).max()) \
            / scale if w.size else 0.0
    return errs


def vision_witness_step(mx, name, params_file, cpu32):
    """Check (c) for a witnessed net (`VISION_SMALL` mode "witness"): the
    float64 step on the card against the CPU within `ND_SMALL_TOL`, and
    the card's fp32 step (``cpu32`` is the CPU's) against the CPU's float64
    one within `VISION_WITNESS_TOL`. Returns the figures, with each fp32
    side's errors over scale."""
    tol = VISION_WITNESS_TOL
    w64 = vision_small_step(mx, mx.cpu(), name, params_file, "float64")
    with cudnn_deterministic():
        card64 = vision_small_step(mx, mx.gpu(0), name, params_file,
                                   "float64")
        card32 = vision_small_step(mx, mx.gpu(0), name, params_file)
    f64 = vision_compare(f"vision (c) {name} float64 card vs CPU", card64,
                         w64, ND_SMALL_TOL)
    figures = {}
    for side, state in (("card", card32), ("cpu", cpu32)):
        errs = vision_witness_errors(state, w64, tol["floor"])
        grads = {k: e for k, e in errs.items() if k.startswith("grad ")}
        figures[f"{side}_fp32_vs_float64"] = {
            "output": errs["output"], "loss": errs["loss"],
            "worst_grad": max(grads.values()),
            "worst_grad_array": max(grads, key=grads.get),
            "grads_over_1e-3": sum(e > 1e-3 for e in grads.values()),
            "grads": len(grads)}
    card = figures["card_fp32_vs_float64"]
    check(max(card["output"], card["loss"]) <= tol["forward"],
          f"vision (c) {name}: the card's fp32 forward parts from float64 "
          f"by {card['output']} (output), {card['loss']} (loss) of scale")
    check(card["worst_grad"] <= tol["grad"], f"vision (c) {name}: the "
          f"card's fp32 {card['worst_grad_array']} parts from float64 by "
          f"{card['worst_grad']} of scale")
    return {"float64_card_vs_cpu": f64, **figures, "tol": tol}


def vision_compare(what, got, want, tol):
    """Raise unless two {name: numpy} states agree within ``tol``; returns
    the count compared and the largest error."""
    import numpy as np

    check(sorted(got) == sorted(want), f"{what}: the arrays differ")
    worst = 0.0
    for k in got:
        a, b = np.asarray(got[k], np.float64), np.asarray(want[k], np.float64)
        err = float(np.abs(a - b).max()) if a.size else 0.0
        worst = max(worst, err)
        check(a.shape == b.shape and np.allclose(a, b, **tol),
              f"{what}: {k} max err {err} over {tol}")
    return {"compared": len(got), "max_abs_err": worst}


def vision_train_loop(torch, mx, net, loss_fn, trainer, fetch, warmup,
                      timed, at_timed=None):
    """``warmup`` + ``timed`` iterations: ``fetch()`` a batch on the card
    (its wait timed), forward and backward under `record()`, the SGD step,
    the loss read; ``at_timed()`` runs between the two. Returns the timed
    walls and waits (s), the losses and the captures made after the
    warm-up."""
    walls, waits, losses = [], [], []
    captures = None
    for i in range(warmup + timed):
        if i == warmup:
            if at_timed is not None:
                at_timed()
            captures = net._cached_op.captures + loss_fn._cached_op.captures
        t0 = time.perf_counter()
        x, y = fetch()
        t1 = time.perf_counter()
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(x.shape[0])
        losses.append(float(loss.mean().asnumpy()))
        t2 = time.perf_counter()
        if i >= warmup:
            walls.append(t2 - t0)
            waits.append(t1 - t0)
    after = net._cached_op.captures + loss_fn._cached_op.captures
    return walls, waits, losses, after - captures


def vision_loader_alone(loader):
    """A fresh epoch of ``loader`` with no model: seconds to its first
    batch (the workers' start included), and batches a second over the
    rest of the epoch."""
    t0 = time.perf_counter()
    it = iter(loader)
    next(it)
    t1 = time.perf_counter()
    n = sum(1 for _ in it)
    t2 = time.perf_counter()
    return {"first_batch_s": t1 - t0, "batches": n,
            "batches_per_s": n / (t2 - t1),
            "img_per_s": n * loader._batch_sampler._batch_size / (t2 - t1)}


def vision_record_fed(torch, mx, smi, folder):
    """Part (a): the record-fed ResNet-50 (BASELINE's second
    configuration). Writes `VISION_RECORDS` records, reads them through
    `vision_dataset` and a pinned-memory `DataLoader` of `vision_workers()`
    threads, then processes, into `resnet50_v1(classes=1000)`, hybridized,
    trained by `gluon.Trainer` (SGD, ``kvstore="device"``), fp32; then the
    same net from device-resident batches, the ceiling. Each run: median
    iteration, img/s, the wait on the loader, the loader alone, the idle
    share of a second window made like the timed one (a fresh epoch and
    `VISION_TIMED` iterations) under torch.profiler, bytes
    copied a batch, peak memory, captures after warm-up (must be 0).
    Returns the lines."""
    import numpy as np

    from mxnet_tpu_torch import recordio

    ctx = mx.gpu(0)
    t0 = time.perf_counter()
    rec, _ = vision_records(recordio, folder, VISION_RECORDS, VISION_IMAGE,
                            VISION_CLASSES)
    write_s = time.perf_counter() - t0
    workers = min(16, (os.cpu_count() or 4) - 2)
    ds = vision_dataset(mx, rec, VISION_IMAGE, VISION_CROP)
    mx.random.seed(0)
    net = mx.gluon.model_zoo.vision.resnet50_v1(classes=VISION_CLASSES)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    net.hybridize()
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    loss_fn.hybridize()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", dict(VISION_OPT),
                               kvstore="device")
    runs = {}
    for mode, thread_pool in (("threads", True), ("processes", False),
                              ("device_resident", None)):
        loader = mx.gluon.data.DataLoader(
            ds, batch_size=VISION_BATCH, shuffle=True, last_batch="discard",
            pin_memory=True, num_workers=workers,
            thread_pool=bool(thread_pool))
        nbytes = []
        feed = {}
        if thread_pool is None:
            pool = [(x.as_in_context(ctx), y.as_in_context(ctx))
                    for x, y in (b for b, _ in zip(loader,
                                                   range(VISION_POOL)))]
            state = {"i": 0}

            def fetch():
                state["i"] += 1
                return pool[state["i"] % VISION_POOL]
        else:
            feed["batches"] = endless(loader)

            def fresh_epoch():
                # the timed window starts with an empty pipeline: nothing
                # the workers made during the warm-up's captures is timed
                feed["batches"].close()
                feed["batches"] = endless(loader)

            feed["at_timed"] = fresh_epoch

            def fetch():
                x, y = next(feed["batches"])
                nbytes.append(x.size * x.dtype.itemsize)
                check(x._data.is_pinned(), f"vision {mode}: an unpinned "
                      "batch")
                return x.as_in_context(ctx), y.as_in_context(ctx)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls, waits, losses, captured = vision_train_loop(
            torch, mx, net, loss_fn, trainer, fetch, VISION_WARMUP,
            VISION_TIMED, at_timed=feed.get("at_timed"))
        peak = torch.cuda.max_memory_allocated()
        check(all(math.isfinite(v) for v in losses),
              f"vision {mode}: a non-finite loss in {losses}")
        check(captured == 0, f"vision {mode}: {captured} captures after "
              "the warm-up")

        def window():
            for _ in range(VISION_TIMED):
                x, y = fetch()
                with mx.autograd.record():
                    loss = loss_fn(net(x), y)
                loss.backward()
                trainer.step(x.shape[0])
                loss.mean().asnumpy()

        if "at_timed" in feed:
            # made like the timed window: a fresh epoch, as many iterations
            feed["at_timed"]()
        profile = profile_step(torch, window, must_run=("convolution",))
        if "batches" in feed:
            feed["batches"].close()
        iter_ms = statistics.median(walls) * 1e3
        line = {"iteration_ms": [w * 1e3 for w in walls],
                "median_iteration_ms": iter_ms,
                "img_per_s": VISION_BATCH * len(walls) / sum(walls),
                # an epoch is 16 batches: the window holds two epoch
                # starts, whose worker start and pipeline fill the median
                # iteration leaves out
                "steady_img_per_s": VISION_BATCH / iter_ms * 1e3,
                "wait_on_loader_ms": [w * 1e3 for w in waits],
                "median_wait_ms": statistics.median(waits) * 1e3,
                "wait_share": sum(waits) / sum(walls),
                "losses": losses,
                "idle_share": profile["idle_share"],
                "profiled_window_img_per_s":
                    VISION_BATCH * VISION_TIMED / profile["step_wall_ms"]
                    * 1e3,
                "host_launch_calls": profile["host_launch_calls"],
                "profile": profile_summary(profile),
                "peak_mem_gb": peak / 1e9, "captures_after_warmup": captured}
        if thread_pool is not None:
            want = VISION_BATCH * 3 * VISION_CROP ** 2 * 4
            check(set(nbytes) == {want}, f"vision {mode}: batch bytes "
                  f"{sorted(set(nbytes))}, want {want}")
            line["bytes_to_card_per_batch"] = want
            line["loader_alone"] = vision_loader_alone(loader)
        runs[mode] = line
        del loader
    return {"config": {"records": VISION_RECORDS, "image_hwc": VISION_IMAGE,
                       "rec_mib": os.path.getsize(rec) / 2 ** 20,
                       "classes": VISION_CLASSES, "batch": VISION_BATCH,
                       "crop": VISION_CROP, "workers": workers,
                       "cpu_count": os.cpu_count(),
                       "transforms": "RandomResizedCrop(224), "
                       "RandomFlipLeftRight, RandomColorJitter(0.4, 0.4, "
                       "0.4), RandomLighting(0.1), ToTensor, Normalize",
                       "loader": "shuffle, last_batch discard, pin_memory",
                       "model": "resnet50_v1, hybridized, fp32, TF32 off",
                       "trainer": dict(VISION_OPT, optimizer="sgd",
                                       kvstore="device"),
                       "warmup": VISION_WARMUP, "timed": VISION_TIMED},
            "source": "BASELINE.json config 2, example/image-"
                      "classification ResNet-50 ImageNet; gluon-cv's "
                      "ImageNet training transforms",
            "records_write_s": write_s, **runs, "card": smi}, net


def step_flop(mx, net, loss_fn, x, y):
    """One eager forward and backward of ``net`` counted under
    `FlopCounterMode` (`compile_cache.measure_cost`, as the observatory
    counts a program)."""
    from mxnet_tpu_torch.compile_cache import measure_cost

    def step():
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        return loss._data

    _, cost = measure_cost(step)
    check(cost, "vision: the FLOP counter failed")
    return cost["flops"]


def vision_family(torch, mx, name, size, count, peak_fp32, smi):
    """Part (b) for one family: `get_model(name, classes=1000)` at batch
    `VISION_BATCH` x ``size``², from `VISION_POOL` device-resident batches,
    fp32: the step's FLOPs counted eagerly (`step_flop`), then hybridized,
    SGD, `VISION_WARMUP` + `VISION_FAMILY_TIMED` iterations. Returns its
    line."""
    import numpy as np

    ctx = mx.gpu(0)
    rng = np.random.RandomState(0)
    pool = [(mx.nd.array(rng.uniform(-1, 1, (VISION_BATCH, 3, size, size)),
                         ctx=ctx),
             mx.nd.array(rng.randint(0, VISION_CLASSES, VISION_BATCH),
                         ctx=ctx, dtype="float32"))
            for _ in range(VISION_POOL)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    mx.random.seed(0)
    net = mx.gluon.model_zoo.vision.get_model(name, classes=VISION_CLASSES)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    flop = step_flop(mx, net, loss_fn, *pool[0])
    params = sum(p.data().size for p in net.collect_params().values())
    check(params == count, f"vision {name}: {params} parameters, the JAX "
          f"package's {count}")
    net.hybridize()
    loss_fn.hybridize()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               dict(VISION_FAMILY_OPT))
    state = {"i": 0}

    def fetch():
        state["i"] += 1
        return pool[state["i"] % VISION_POOL]

    t0 = time.perf_counter()
    walls, _, losses, captured = vision_train_loop(
        torch, mx, net, loss_fn, trainer, fetch, VISION_WARMUP,
        VISION_FAMILY_TIMED)
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(v) for v in losses),
          f"vision {name}: a non-finite loss in {losses}")
    check(captured == 0, f"vision {name}: {captured} captures after the "
          "warm-up")
    step_ms = statistics.median(walls) * 1e3
    bound_ms = flop / peak_fp32 * 1e3
    line = {"input": [VISION_BATCH, 3, size, size],
            "trainer": dict(VISION_FAMILY_OPT, optimizer="sgd"),
            "params": params,
            "pinned_params": count, "step_flop": flop,
            "step_ms": [w * 1e3 for w in walls], "median_step_ms": step_ms,
            "img_per_s": VISION_BATCH / step_ms * 1e3,
            "bound_ms": bound_ms, "bound_by": "operations",
            "bound_share": bound_ms / step_ms, "losses": losses,
            "captures_after_warmup": captured, "run_s": wall_s,
            "peak_mem_gb": (peak - held) / 1e9}
    del net, trainer, loss_fn, pool
    return line


def vision_ops_card_vs_cpu(mx, rec):
    """Check (c): the deterministic image ops and transforms of the
    pipeline on 4 of the records' images on the card against the CPU:
    ``_image_resize`` (float, to the short side 256 and to 224²),
    ``_image_crop``, the flips, ``_image_to_tensor``, ``_image_normalize``,
    ``_image_adjust_lighting``; and the transforms `ToTensor`, `Normalize`,
    `Resize`, `CenterCrop`, `CropResize` on a card array (a CPU array out).
    uint8 results equal, float ones within `VISION_OP_TOL` of their largest
    magnitude. Returns the count compared and the largest error."""
    import numpy as np

    T = mx.gluon.data.vision.transforms
    reader = mx.recordio.MXIndexedRecordIO(rec[:-4] + ".idx", rec, "r")
    imgs = np.stack([np.frombuffer(mx.recordio.unpack(reader.read_idx(k))[1],
                                   np.uint8).reshape(VISION_IMAGE)
                     for k in reader.keys[:4]])
    reader.close()
    chw = imgs[:, :3].transpose(0, 3, 1, 2)

    def ops(ctx):
        x8 = mx.nd.array(imgs, ctx=ctx, dtype="uint8")
        xf = x8.astype("float32")
        img = mx.nd.array(imgs[0], ctx=ctx, dtype="uint8")
        t = mx.nd.image.to_tensor(x8)
        return [mx.nd.image.resize(xf, size=256, keep_ratio=True),
                mx.nd.image.resize(xf, size=(224, 224)),
                mx.nd.image.resize(xf, size=(224, 224), interp=0),
                mx.nd.image.crop(x8, x=48, y=16, width=224, height=224),
                mx.nd.image.flip_left_right(x8),
                mx.nd.image.flip_top_bottom(x8), t,
                mx.nd.image.normalize(t, mean=IMAGENET_MEAN,
                                      std=IMAGENET_STD),
                mx.nd.image.adjust_lighting(xf, alpha=(0.05, -0.1, 0.02)),
                T.ToTensor()(img),
                T.Normalize(IMAGENET_MEAN, IMAGENET_STD)(
                    mx.nd.array(chw[0] / 255.0, ctx=ctx)),
                T.Resize(224, keep_ratio=True)(img), T.CenterCrop(224)(img),
                T.CropResize(10, 20, 200, 180, size=(64, 48))(img)]

    got, want = ([o.asnumpy() for o in ops(ctx)]
                 for ctx in (mx.gpu(0), mx.cpu()))
    worst = 0.0
    for k, (a, b) in enumerate(zip(got, want)):
        check(a.dtype == b.dtype and a.shape == b.shape,
              f"vision (c) op {k}: {a.dtype}{a.shape} vs {b.dtype}{b.shape}")
        if a.dtype == np.uint8:
            check(np.array_equal(a, b), f"vision (c) op {k}: uint8 differs")
            continue
        err = float(np.abs(a.astype(np.float64) - b).max())
        bound = VISION_OP_TOL["of_largest"] * float(np.abs(b).max())
        worst = max(worst, err)
        check(err <= bound, f"vision (c) op {k}: max err {err} over "
              f"{bound}")
    return {"compared": len(got), "max_abs_err": worst, "tol": VISION_OP_TOL}


def logged_figures(fn):
    """``fn()`` with the root logger's records captured: returns its
    result and the messages logged."""
    import logging

    records = []
    handler = logging.Handler()
    handler.emit = lambda r: records.append(r.getMessage())
    root = logging.getLogger()
    old = root.level
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    try:
        return fn(), records
    finally:
        root.removeHandler(handler)
        root.setLevel(old)


def run_image_classification_example(argv, ctx=None):
    """`example/gluon/image_classification.py` through the port with only
    its five imports changed. Returns the messages it logged (each epoch's
    accuracy and img/s)."""
    ns = example_namespace(IMAGE_CLS_EXAMPLE, 5)
    _, logged = logged_figures(lambda: run_example(ns, argv, ctx))
    return logged


def run_train_imagenet_example(argv, ctx=None):
    """`example/image-classification/train_imagenet.py` through the port
    with only its import changed, and its `common.fit` with its own: the
    port's `fit` module stands as ``common`` while it runs. Returns its
    figures (``benchmark-img-per-sec``) and the messages it logged."""
    import types

    fit = example_namespace(FIT_MODULE, 1)
    common = types.ModuleType("common")
    common.fit = types.SimpleNamespace(**{k: v for k, v in fit.items()
                                          if not k.startswith("__")})
    saved = {k: sys.modules.get(k) for k in ("common", "common.fit")}
    sys.modules["common"], sys.modules["common.fit"] = common, common.fit
    try:
        ns = example_namespace(TRAIN_IMAGENET_EXAMPLE, 1)
        check(ns["fit"] is common.fit, "train_imagenet.py did not take the "
              "port's fit module")
        return logged_figures(lambda: run_example(ns, argv, ctx))
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


def vision_checks(torch, mx, folder, rec):
    """Check (c): every family's small model and the record-fed step on
    the card (cuDNN deterministic) against the CPU from one weight file;
    the pipeline's deterministic ops (`vision_ops_card_vs_cpu`); the two
    examples through the port. Returns their figures."""
    from mxnet_tpu_torch import recordio

    small = {}
    for name in VISION_SMALL:
        params_file = os.path.join(folder, f"small_{name}.params")
        want = vision_small_step(mx, mx.cpu(), name, params_file)
        if VISION_SMALL[name][2] == "witness":
            small[name] = vision_witness_step(mx, name, params_file, want)
            continue
        with cudnn_deterministic():
            got = vision_small_step(mx, mx.gpu(0), name, params_file)
        small[name] = vision_compare(f"vision (c) {name} card vs CPU", got,
                                     want, ND_SMALL_TOL)
    cfg = VISION_SMALL_RECORDS
    sub = os.path.join(folder, "small_records")
    os.makedirs(sub, exist_ok=True)
    small_rec, _ = vision_records(recordio, sub, cfg["n"], cfg["image"],
                                  cfg["classes"], seed=1)
    params_file = os.path.join(folder, "small_resnet.params")
    with mx.cpu():
        mx.random.seed(0)
        net = gluon_small_net(mx)()
        net.initialize(mx.init.Xavier())
        net(mx.nd.zeros((1, 3, cfg["crop"], cfg["crop"])))
        net.save_parameters(params_file)
    want = vision_record_step(mx, mx.cpu(), small_rec, params_file)
    with cudnn_deterministic():
        got = vision_record_step(mx, mx.gpu(0), small_rec, params_file,
                                 pin_memory=True)
    small["record_fed_small_resnet"] = vision_compare(
        "vision (c) record-fed step card vs CPU", got, want,
        ND_SMALL_TOL)
    ops = vision_ops_card_vs_cpu(mx, rec)
    cls_logged = run_image_classification_example(
        ["--model", "mobilenetv2_1.0", "--image-shape", "3,224,224",
         "--batch-size", "8", "--num-batches", "2", "--epochs", "1"],
        ctx=mx.gpu(0))
    check(any(m.startswith("epoch 0:") for m in cls_logged),
          f"vision (c): image_classification.py logged {cls_logged}")
    figures, imagenet_logged = run_train_imagenet_example(
        ["--network", "densenet121", "--benchmark", "1", "--image-shape",
         "3,224,224", "--batch-size", "8", "--num-batches", "2"],
        ctx=mx.gpu(0))
    check(figures.get("benchmark-img-per-sec", 0) > 0,
          f"vision (c): train_imagenet.py's figures {figures}")
    return {"small_card_vs_cpu": dict(small, tol=ND_SMALL_TOL),
            "ops_card_vs_cpu": ops,
            "examples": {
                "image_classification": {
                    "argv": "--model mobilenetv2_1.0 --image-shape "
                            "3,224,224 --batch-size 8 --num-batches 2 "
                            "--epochs 1", "logged": cls_logged},
                "train_imagenet": dict(
                    figures, argv="--network densenet121 --benchmark 1 "
                    "--image-shape 3,224,224 --batch-size 8 "
                    "--num-batches 2", logged=imagenet_logged[-3:])}}


def vision_phase(torch, smi):
    """Slice 16's path: (a) the record-fed ResNet-50 in both worker modes
    beside the device-resident ceiling (`vision_record_fed`), (b) each new
    family at full width (`vision_family`), (c) the checks
    (`vision_checks`) and no kernel launched. fp32, TF32 off. Returns the
    line."""
    import gc

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import observatory

    with tempfile.TemporaryDirectory() as folder:
        reset_launches()
        t0 = time.perf_counter()
        try:
            record_fed, net = vision_record_fed(torch, mx, smi, folder)
        finally:
            mx.gluon.data.dataloader.shutdown_worker_processes()
        del net
        gc.collect()
        record_s = time.perf_counter() - t0
        peak_fp32 = observatory.peaks()["matmul_flops"]["float32"]
        families = {}
        for name, size, count in VISION_FAMILIES:
            families[name] = vision_family(torch, mx, name, size, count,
                                           peak_fp32, smi)
            gc.collect()
            torch.cuda.empty_cache()
        launches = read_launches()
        check(not any(launches.values()),
              f"the vision path launched kernels: {launches}")
        families_s = time.perf_counter() - t0 - record_s
        checks = vision_checks(torch, mx, folder,
                               os.path.join(folder, "images.rec"))
    return {"record_fed_resnet50": record_fed, "families": families,
            "peak_fp32_flops": peak_fp32, "kernel_launches": launches,
            "checks": checks, "record_fed_s": record_s,
            "families_s": families_s, "card": smi}


def profiler_session(torch, lm_state, settle=True):
    """One `mx.profiler` session around one full-width train step (bf16,
    8 x 2048) under a span, with telemetry and tracing on, dumped to a
    file. With ``settle``, the session runs one tiny kernel and waits for
    the card before the step and after it, so the step's kernels lie well
    inside the session (one whole run on an H100 lost a K1 event from the
    trace without it; `tools/torch_profiler_repeat.py` counts such
    losses). Returns the step's
    K1 launches, the trace's K1 kernel events, its telemetry counter
    events, its ``train.step`` spans, its event count and the loss."""
    from mxnet_tpu_torch import profiler, telemetry, tracing

    lm, step, state, tokens, targets = lm_state

    def settled():
        if settle:
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "profile.json")
        profiler.set_config(filename=path)
        # a first tiny session starts the tracer (the step's is complete)
        profiler.start()
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        profiler.stop()
        profiler.dumps(reset=True)
        with planes_on():
            telemetry.counter("chip_smoke.profiled_steps").inc()
            reset_launches()
            profiler.start()
            settled()
            with tracing.span("train.step", cat="train"):
                loss = step(state, tokens, targets, TRAIN_STEPS + 1)
                torch.cuda.synchronize()
            settled()
            profiler.stop()
            profiler.dump()
            launched = read_launches()["flash_attention_fwd"]
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    k1 = [e for e in events if e.get("cat") == "kernel" and any(
        key in e.get("name", "") for key, group in KERNEL_GROUPS
        if group == PORT_GROUPS["flash_attention_fwd"])]
    counters = [e for e in events if e.get("ph") == "C"
                and e.get("cat") == "telemetry"]
    spans = [e for e in events if e.get("name") == "train.step"
             and e.get("ph") == "X"]
    return {"launched": launched, "k1": k1, "counters": counters,
            "spans": spans, "events": len(events), "loss": float(loss)}


def profiler_phase(torch, lm_state, smi):
    """``mx.profiler`` on the card (`profiler_session`). The dumped trace
    must hold the step's 4 K1 launches by the kernel's name, a telemetry
    counter event and the span. Runs last: the profiler session and a
    torch.profiler session never overlap, and no graph is captured or
    replayed after it."""
    run = profiler_session(torch, lm_state)
    k1, launched = run["k1"], run["launched"]
    want = lm_state[0].cfg.n_layers
    check(len(k1) == launched == want,
          f"profiler: {len(k1)} K1 kernels in the trace, {launched} "
          f"launched, want {want}")
    check(run["counters"], "profiler: no telemetry counter event in the "
          "trace")
    check(len(run["spans"]) == 1, f"profiler: {len(run['spans'])} "
          "train.step spans")
    check(math.isfinite(run["loss"]), "profiler: non-finite loss")
    return {"events": run["events"], "k1_kernels": len(k1),
            "k1_device_us": sum(e.get("dur", 0) for e in k1),
            "telemetry_counter_events": len(run["counters"]),
            "spans": len(run["spans"]), "card": smi}


def attention_case(torch, fa, F, *, b, l, h, d, dtype, causal, tol, timed):
    """Kernel vs plain version on inputs shaped as the transformer makes
    them: q, k, v strided views of one [B, L, 3*H*D] projection."""
    gen = torch.Generator(device="cuda").manual_seed(l * d + causal)
    qkv = torch.randn(b, l, 3 * h * d, device="cuda", generator=gen,
                      dtype=torch.float32).to(getattr(torch, dtype))
    q, k, v = (t.view(b, l, h, d) for t in qkv.split(h * d, dim=-1))
    scale = 1.0 / math.sqrt(d)
    out = fa.flash_attention_fwd_kernel(q, k, v, causal, scale)
    ref = fa.reference_attention(q, k, v, causal, scale)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    # allclose with atol = rtol = tol, the JAX package's kernel-test bound
    ok = bool((diff <= tol + tol * ref.float().abs()).all())
    name = f"{dtype} B={b} L={l} H={h} D={d} {'causal' if causal else 'full'}"
    check(out.shape == q.shape and out.dtype == q.dtype, f"{name}: output")
    check(ok, f"{name}: kernel vs plain max abs err {err} beyond {tol}")
    case = {"case": name, "variant": fa.kernel_variant(q.dtype),
            "max_abs_err": err, "tol": tol}
    if timed:
        bound_ms, bound_by, flop = attention_bound(b, l, l, h, d, dtype,
                                                   causal)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def kernel():
            return fa.flash_attention_fwd_kernel(q, k, v, causal, scale)

        ms = cuda_ms(kernel)
        case.update(
            ms=ms, call_ms=call_ms(kernel),
            plain_ms=cuda_ms(lambda: fa.reference_attention(
                q, k, v, causal, scale)),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, scale=scale)),
            library="torch.nn.functional.scaled_dot_product_attention",
            bound_ms=bound_ms, bound_by=bound_by, **rates(ms, bound_ms, flop))
    return case


def quantize_case(torch, gcm, *, shape, dtype, threshold, timed, nan=False):
    """K3 vs its plain version on one gradient and a nonzero fp32 residual:
    the packed words and the new residual must be equal bit for bit (NaN
    where the plain version has NaN)."""
    n = math.prod(shape)
    gen = torch.Generator(device="cuda").manual_seed(n + int(threshold * 10))
    grad = torch.randn(shape, generator=gen, device="cuda").to(
        getattr(torch, dtype))
    if nan:
        grad.view(-1)[::7] = float("nan")
    residual = (torch.rand(shape, generator=gen, device="cuda") * 2 - 1) \
        * threshold
    want, want_res = gcm.quantize_2bit(grad, residual, threshold)
    packed, res = gcm.quantize_2bit_kernel(grad, residual.clone(), threshold)
    torch.cuda.synchronize()
    name = f"{dtype} {'x'.join(map(str, shape))} t={threshold}" + (
        " with NaN" if nan else "")
    check(packed.shape == want.shape and packed.dtype == torch.int32,
          f"{name}: packed words {packed.shape} {packed.dtype}")
    words_equal = bool(torch.equal(packed, want))
    same = (res.view(torch.int32) == want_res.view(torch.int32)) | (
        res.isnan() & want_res.isnan())
    finite = ~want_res.isnan()
    err = float((res[finite] - want_res[finite]).abs().max()) \
        if bool(finite.any()) else 0.0
    check(words_equal, f"{name}: packed words differ from the plain version")
    check(bool(same.all()), f"{name}: residual differs from the plain "
          f"version (max abs err {err})")
    case = {"case": name, "n": n, "words_equal": words_equal,
            "residual_bit_equal": True, "max_abs_err": err}
    if timed:
        elt = grad.element_size()
        nbytes = n * (elt + 4 + 4) + 4 * gcm.compressed_size(n)
        t_bytes = nbytes / PEAK_BYTES_PER_S
        t_ops = 3 * n / PEAK_FLOPS["float32"]  # an add and two compares
        scratch = residual.clone()
        bound_ms = max(t_bytes, t_ops) * 1e3

        def kernel():
            return gcm.quantize_2bit_kernel(grad, scratch, threshold)

        ms = cuda_ms(kernel)
        case.update(
            ms=ms, call_ms=call_ms(kernel),
            plain_ms=cuda_ms(lambda: gcm.quantize_2bit(grad, residual,
                                                       threshold)),
            bytes=nbytes, bound_ms=bound_ms,
            bound_by="bytes" if t_bytes > t_ops else "operations",
            **rates(ms, bound_ms, 3 * n))
    return case


def hop_bias(torch, kind, lq, lk):
    """One hop's (Lq, Lk) fp32 bias on the card, or None. The causal kinds
    are the ring's mask for query rows q0.. and keys k0.. (0 where
    q >= k, else -1e30). The ring's hops of equal blocks are of three kinds:
    "diagonal", a position's own block; "past", a block wholly before the
    queries, whose bias is all zeros (6 of the 16 hops a layer at sp = 4);
    "masked", a block wholly in the queries' future. "offset", keys starting
    half a block before the queries, is a partly masked off-diagonal hop that
    blocks of unequal length would give."""
    if kind == "none":
        return None
    if kind == "random":
        gen = torch.Generator(device="cuda").manual_seed(lq + lk)
        return torch.randn(lq, lk, generator=gen, device="cuda")
    q0, k0 = {"offset": (lk, lk // 2), "diagonal": (0, 0),
              "past": (lk, 0), "masked": (0, lq)}[kind]
    q_pos = q0 + torch.arange(lq, device="cuda")[:, None]
    k_pos = k0 + torch.arange(lk, device="cuda")[None, :]
    return torch.where(q_pos >= k_pos, 0.0, -1e30).float()


def partials_case(torch, fa, F, *, b, lq, lk, h, d, dtype, bias, tol, timed):
    """K2 vs its plain version (`_block_attn`) on inputs shaped as the ring
    gives them: q, k, v strided views of one [B, L, 3*H*D] projection. m and
    l must agree to rtol 1e-4 (fp32 statistics of scores summed in another
    order), the normalized output o / l to `tol`."""
    from mxnet_tpu_torch.parallel.ring_attention import _block_attn

    gen = torch.Generator(device="cuda").manual_seed(lq * d + lk)
    qkv = torch.randn(b, max(lq, lk), 3 * h * d, device="cuda",
                      generator=gen).to(getattr(torch, dtype))
    q = qkv[:, :lq, :h * d].view(b, lq, h, d)
    k, v = (t.view(b, lk, h, d)
            for t in qkv[:, :lk, h * d:].split(h * d, dim=-1))
    bias_t = hop_bias(torch, bias, lq, lk)
    scale = 1.0 / math.sqrt(d)
    # the bias as `flash_block_partials` hands it to the kernel: rows
    # `bias_pitch` apart (padded for the bf16 kernel when Lk % 4 != 0)
    kbias = bias_t
    pitch = fa.bias_pitch(lk, fa.kernel_variant(q.dtype))
    if bias_t is not None and pitch != lk:
        kbias = torch.zeros(lq, pitch, device="cuda")[:, :lk].copy_(bias_t)
    o, m, l = fa.flash_block_partials_kernel(q, k, v, kbias, scale)
    ro, rm, rl = _block_attn(q, k, v, bias_t, scale)
    torch.cuda.synchronize()
    name = f"{dtype} B={b} Lq={lq} Lk={lk} H={h} D={d} bias={bias}"
    check(o.shape == q.shape and o.dtype == q.dtype and m.shape == l.shape
          == (b, h, lq, 1), f"{name}: output shapes")
    # relative errors (absolute where |m| < 1); m is -1e30 in fully masked
    # rows
    m_err = float(((m - rm).abs() / rm.abs().clamp_min(1.0)).max())
    l_err = float(((l - rl).abs() / rl.abs()).max())
    out = o.float() / l.permute(0, 2, 1, 3)
    ref = ro.float() / rl.permute(0, 2, 1, 3)
    diff = (out - ref).abs()
    err = float(diff.max())
    check(m_err <= 1e-4 and l_err <= 1e-4,
          f"{name}: m rel err {m_err}, l rel err {l_err} beyond 1e-4")
    # allclose with atol = rtol = tol, the JAX package's kernel-test bound
    check(bool((diff <= tol + tol * ref.abs()).all()),
          f"{name}: o / l max abs err {err} beyond {tol}")
    case = {"case": name, "variant": fa.kernel_variant(q.dtype),
            "max_abs_err": err, "tol": tol,
            "m_rel_err": m_err, "l_rel_err": l_err, "stats_rtol": 1e-4}
    if timed:
        bound_ms, bound_by, flop = attention_bound(
            b, lq, lk, h, d, dtype, causal=False, bias=bias_t is not None,
            stats=True)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mask = None if bias_t is None else bias_t.to(q.dtype)

        def kernel():
            return fa.flash_block_partials_kernel(q, k, v, kbias, scale)

        ms = cuda_ms(kernel)
        case.update(
            ms=ms, call_ms=call_ms(kernel), **rates(ms, bound_ms, flop),
            plain_ms=cuda_ms(lambda: _block_attn(q, k, v, bias_t, scale)),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, scale=scale)),
            library="torch.nn.functional.scaled_dot_product_attention with "
            "the bias as attn_mask: the same work, normalized output (no "
            "single PyTorch call returns the unnormalized partials)",
            bound_ms=bound_ms, bound_by=bound_by)
    return case


def timed_fields(case):
    """A kernel's entry on the kernels line from its timed main case."""
    keys = ("case", "variant", "max_abs_err", "tol", "ms", "call_ms",
            "plain_ms", "library_ms", "library", "bound_ms", "bound_by",
            "bound_share", "tflops")
    return {k: case[k] for k in keys if k in case}


def kernels_phase(torch, fa, gcm, launches):
    """The kernels line; `launches` maps each path to its launch counts."""
    import torch.nn.functional as F

    main = attention_case(torch, fa, F, b=TRAIN_BATCH, l=TRAIN_LEN, h=8, d=64,
                          dtype="bfloat16", causal=True, tol=2e-2, timed=True)
    extra = [  # every head dim of the bf16 tensor-core kernel, ragged L
        attention_case(torch, fa, F, b=2, l=77, h=3, d=32, dtype="bfloat16",
                       causal=True, tol=2e-2, timed=False),
        attention_case(torch, fa, F, b=2, l=1000, h=4, d=64, dtype="bfloat16",
                       causal=False, tol=2e-2, timed=False),
        attention_case(torch, fa, F, b=1, l=300, h=2, d=128, dtype="bfloat16",
                       causal=True, tol=2e-2, timed=False),
        # and the fp32 FMA kernel
        attention_case(torch, fa, F, b=2, l=1000, h=4, d=64, dtype="float32",
                       causal=False, tol=1e-5, timed=True),
        attention_case(torch, fa, F, b=2, l=77, h=3, d=32, dtype="float32",
                       causal=True, tol=1e-5, timed=False),
        attention_case(torch, fa, F, b=1, l=130, h=2, d=128, dtype="float32",
                       causal=False, tol=1e-5, timed=False),
    ]
    k1 = {
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "mxnet_tpu_torch/ops/csrc/flash_attention_fwd.cu",
        "replaces": "mxnet_tpu/ops/pallas_attention.py:66",
        "launches": launches["train"]["flash_attention_fwd"],
        "launches_by_path": {p: c["flash_attention_fwd"]
                             for p, c in launches.items()},
        **timed_fields(main), "extra_cases": extra,
    }
    # the largest key of the trainer path: embed's gradient, [32768, 512] bf16
    q_main = quantize_case(torch, gcm, shape=(32768, 512), dtype="bfloat16",
                           threshold=COMPRESSION["threshold"], timed=True)
    q_extra = [quantize_case(torch, gcm, shape=(n,), dtype="float32",
                             threshold=t, timed=False)
               for t in (0.5, 0.1) for n in (1, 100, 2048, 2049, 33 * 65)]
    q_extra.append(quantize_case(torch, gcm, shape=(33, 65), dtype="bfloat16",
                                 threshold=0.1, timed=False, nan=True))
    k3 = {
        "name": "quantize_2bit", "route": "cuda",
        "source": "mxnet_tpu_torch/ops/csrc/quantize_2bit.cu",
        "replaces": "mxnet_tpu/gradient_compression.py:106",
        "launches": launches["trainer"]["quantize_2bit"],
        "launches_by_path": {p: c["quantize_2bit"]
                             for p, c in launches.items()},
        **timed_fields(q_main), "tol": 0.0,
        "exact": "packed words and residual bit-equal to the plain version",
        "library_ms": None,
        "library": "none: no single PyTorch call computes this function",
        "extra_cases": q_extra,
    }
    # one ring hop at the ring path's shapes, Lq = Lk = 2048 / sp, with the
    # bias the ring passes most: a past block's all-zero mask
    hop = TRAIN_LEN // RING_SP
    p_main = partials_case(torch, fa, F, b=TRAIN_BATCH, lq=hop, lk=hop, h=8,
                           d=64, dtype="bfloat16", bias="past", tol=2e-2,
                           timed=True)
    # timed without a bias too: what reading the bias costs the hop
    p_extra = [
        partials_case(torch, fa, F, b=TRAIN_BATCH, lq=hop, lk=hop, h=8, d=64,
                      dtype="bfloat16", bias=kind, tol=2e-2,
                      timed=kind == "none")
        for kind in ("masked", "diagonal", "offset", "none", "random")]
    p_extra += [  # ragged blocks and every head dim of the bf16 kernel
        partials_case(torch, fa, F, b=2, lq=100, lk=300, h=3, d=64,
                      dtype="bfloat16", bias="masked", tol=2e-2, timed=False),
        partials_case(torch, fa, F, b=2, lq=100, lk=300, h=3, d=64,
                      dtype="bfloat16", bias="offset", tol=2e-2, timed=False),
        partials_case(torch, fa, F, b=2, lq=100, lk=300, h=3, d=64,
                      dtype="float32", bias="offset", tol=1e-5, timed=False),
        partials_case(torch, fa, F, b=2, lq=100, lk=300, h=3, d=64,
                      dtype="float32", bias="masked", tol=1e-5, timed=False),
        partials_case(torch, fa, F, b=2, lq=256, lk=256, h=4, d=32,
                      dtype="bfloat16", bias="diagonal", tol=2e-2,
                      timed=False),
        partials_case(torch, fa, F, b=2, lq=256, lk=256, h=4, d=128,
                      dtype="bfloat16", bias="offset", tol=2e-2, timed=False),
        partials_case(torch, fa, F, b=1, lq=130, lk=70, h=2, d=128,
                      dtype="float32", bias="random", tol=1e-5, timed=False),
        # an odd Lk: the bias read element by element, not in pairs
        partials_case(torch, fa, F, b=1, lq=130, lk=71, h=2, d=64,
                      dtype="bfloat16", bias="random", tol=2e-2, timed=False),
    ]
    k2 = {
        "name": "flash_block_partials", "route": "cuda",
        "source": "mxnet_tpu_torch/ops/csrc/flash_block_partials.cu",
        "replaces": "mxnet_tpu/ops/pallas_attention.py:188",
        "launches": launches["ring"]["flash_block_partials"],
        "launches_by_path": {p: c["flash_block_partials"]
                             for p, c in launches.items()},
        **timed_fields(p_main), "m_rel_err": p_main["m_rel_err"],
        "l_rel_err": p_main["l_rel_err"], "extra_cases": p_extra,
    }
    return [k1, k2, k3]


# the port's kernels by wrapper name -> their group in a profile
PORT_GROUPS = {"flash_attention_fwd": "K1 flash_attention_fwd",
               "flash_block_partials": "K2 flash_block_partials",
               "quantize_2bit": "K3 quantize_2bit"}
KERNEL_GROUPS = (  # substring of a device kernel's name -> its group
    # fp32 FMA kernels, and the bf16 tensor-core kernel by its policy
    # (`sm90::attention_sm90_kernel<D, ...Policy>`)
    ("flash_attention_fwd_kernel", PORT_GROUPS["flash_attention_fwd"]),
    ("FlashAttentionFwdPolicy", PORT_GROUPS["flash_attention_fwd"]),
    ("flash_block_partials_kernel", PORT_GROUPS["flash_block_partials"]),
    ("FlashBlockPartialsPolicy", PORT_GROUPS["flash_block_partials"]),
    ("quantize_2bit_kernel", PORT_GROUPS["quantize_2bit"]),
    ("nccl", "NCCL collectives"),
    # cuDNN's convolutions (fprop / dgrad / wgrad engines) and torch's
    # BatchNorm and pooling kernels: the nd path's
    ("fprop", "convolution"), ("dgrad", "convolution"),
    ("wgrad", "convolution"), ("convolve", "convolution"),
    ("conv2d", "convolution"), ("batch_norm", "batchnorm"),
    ("pool", "pooling"),
    # cuDNN's recurrent kernels (the lstm_lm path's fused route)
    ("LSTM", "recurrent"), ("RNN_", "recurrent"), ("lstm", "recurrent"),
    ("gemm", "matmul"), ("nvjet", "matmul"), ("xmma", "matmul"),
    ("softmax", "softmax"), ("SoftMax", "softmax"),
    ("reduce", "reductions"), ("Reduce", "reductions"),
    ("Memcpy", "copies"), ("copy", "copies"),
)
# the host's calls that put work on the card: a graph replay is one
HOST_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                 "cudaMemsetAsync")
RANGES = ("_FlashAttentionBackward", "_FlashAttention",
          "_BlockPartialsBackward", "_BlockPartials", "forward_backward",
          "trainer.step")


def profile_step(torch, step_fn, must_run):
    """One more step of a path under torch.profiler: device time by kernel
    and by group, the inclusive device and host time of the attention
    forward and backward and of the step's ranges, and the device's idle
    share of the step's wall time (which the profiler itself lengthens).
    The step is profiled alone, with no schedule, after a tiny profile that
    starts the tracer, and the profile must hold every launch of the port's
    kernels that the step made."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    before = read_launches()
    with profile(activities=activities) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launched = {name: count - before[name]
                for name, count in read_launches().items()}
    kernels, host_calls = {}, {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CPU and ev.name in HOST_LAUNCHES:
            host_calls[ev.name] = host_calls.get(ev.name, 0) + 1
        # device work only: skip user ranges on the device track
        if (ev.device_type == DeviceType.CUDA
                and not getattr(ev, "is_user_annotation", False)):
            row = kernels.setdefault(ev.name, {"name": ev.name,
                                               "device_ms": 0.0, "count": 0})
            row["device_ms"] += ev.time_range.elapsed_us() / 1e3
            row["count"] += 1
    rows = sorted(kernels.values(), key=lambda r: -r["device_ms"])
    busy = sum(r["device_ms"] for r in rows)
    groups, counts = {}, {}
    for r in rows:
        group = next((g for key, g in KERNEL_GROUPS if key in r["name"]),
                     "elementwise and other")
        groups[group] = groups.get(group, 0.0) + r["device_ms"]
        counts[group] = counts.get(group, 0) + r["count"]
    ranges = {}
    for ev in prof.key_averages():
        for name in RANGES:
            if ev.key.endswith(name):
                # a user range appears twice, on the host track and on the
                # device track: keep the larger of each time
                r = ranges.setdefault(name, {"device_ms": 0.0,
                                             "host_ms": 0.0})
                r["device_ms"] = max(r["device_ms"],
                                     ev.device_time_total / 1e3)
                r["host_ms"] = max(r["host_ms"], ev.cpu_time_total / 1e3)
    for group in must_run:
        check(groups.get(group, 0) > 0, f"the profiled step ran no {group}")
    for name in launched:
        group = PORT_GROUPS[name]
        check(counts.get(group, 0) == launched[name],
              f"the profile holds {counts.get(group, 0)} of the step's "
              f"{launched[name]} launches of {name}")
    return {"step_wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": max(0.0, 1 - busy / wall_ms),
            "device_kernels": sum(counts.values()),
            "host_launch_calls": host_calls,
            "kernel_launches": launched,
            "groups_ms": groups, "groups_launches": counts,
            "ranges": ranges, "kernels": rows}


def profile_summary(profile):
    """A profile without its full kernel list, with the top 8 kernels."""
    out = {k: v for k, v in profile.items() if k != "kernels"}
    out["top"] = [{"name": r["name"][:80], "device_ms": r["device_ms"],
                   "count": r["count"]} for r in profile["kernels"][:8]]
    return out


def hgmma_counts(build, names):
    """{source: the count of HGMMA (wgmma) instructions in its library's
    SASS}, or a note that cuobjdump is missing: the check never fails."""
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    if not os.path.isfile(tool):
        return "cuobjdump not found beside nvcc"
    counts = {}
    for name in names:
        sass = subprocess.run([tool, "-sass", str(build._output(name))],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        counts[name] = sass.count("HGMMA")
    return counts


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="OUT.json",
                        help="also profile one step of each path into "
                        "OUT.json")
    parser.add_argument("--deadline", type=float, default=1100,
                        metavar="SECONDS", help="dump every thread's stack "
                        "and exit 1 if the run is not over by then")
    args = parser.parse_args(argv)
    faulthandler.dump_traceback_later(args.deadline, exit=True)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card",
              file=sys.stderr)
        return 2
    from mxnet_tpu_torch import gradient_compression as gcm
    from mxnet_tpu_torch.ops import _build
    from mxnet_tpu_torch.ops import flash_attention as fa

    # fp32 comparisons on the card are full fp32, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = card_line()
    emit(card={"nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
               "torch": torch.__version__, "cuda": torch.version.cuda,
               "capability": list(torch.cuda.get_device_capability(0)),
               "device_count": torch.cuda.device_count()})

    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    built = _build.build(names)
    build_s = time.perf_counter() - t0
    ptxas = [line.strip() for n in names for line in _build.build_log(n)
             .splitlines() if "registers" in line or "spill" in line]
    emit(build={"seconds": build_s, "sources": names, "built": built,
                "ptxas": ptxas, "hgmma": hgmma_counts(_build, names)})

    train, lm_state = train_phase(torch)
    small = small_reference_phase(torch)
    progress("train")
    ring, ring_state = ring_phase(torch, train)
    small_ring = small_reference_phase(torch, sp=RING_SP)
    progress("ring")
    # before any profiler: the engines' worker threads replay graphs
    small_generate = small_generate_phase(torch)
    generate, generate_profile, generated = generate_phase(
        torch, smi, profile=bool(args.profile))
    progress("generate")
    lanes = generate_lanes(torch, smi, generated)
    trainer, trainer_profile = trainer_phase(torch, profile=bool(args.profile))
    progress("trainer")
    nd, nd_steps = nd_phase(torch, smi)
    progress("nd")
    with tempfile.TemporaryDirectory() as workdir:
        gluon, gluon_steps = gluon_phase(torch, smi, workdir)
        progress("gluon")
        module, module_profiles = module_phase(torch, smi, workdir,
                                               profile=bool(args.profile))
        progress("module")
        serve, serve_profiles = serve_phase(torch, smi, workdir,
                                            profile=bool(args.profile))
        progress("serve")
        observe = observe_phase(torch, smi, workdir)
        progress("observe")
        overlap = overlap_phase(torch, smi, workdir, generated)
    del generated
    progress("overlap")
    gan, gan_profile = gan_phase(torch, smi)
    progress("gan")
    lstm_lm, lstm_lm_profile = lstm_lm_phase(torch, smi)
    progress("lstm_lm")
    sparse = sparse_phase(torch, smi)
    progress("sparse")
    vision = vision_phase(torch, smi)
    progress("vision")
    kernels = kernels_phase(torch, fa, gcm, {
        "train": train["kernel_launches"],
        "ring": ring["kernel_launches"],
        "trainer": trainer["kernel_launches"],
        "generate": generate["kernel_launches"],
        **{name: line["kernel_launches"] for name, line in lanes.items()},
        "nd": nd["kernel_launches"],
        "gluon": gluon["kernel_launches"],
        "module": module["kernel_launches"],
        "serve": serve["kernel_launches"],
        "overlap": overlap["kernel_launches"],
        "gan": gan["kernel_launches"],
        "lstm_lm": lstm_lm["kernel_launches"],
        "sparse": sparse["kernel_launches"],
        "vision": vision["kernel_launches"]})
    emit(kernels=kernels)
    emit(train=train, small_reference=small)
    emit(ring=ring, small_reference=small_ring)
    emit(trainer=trainer)
    emit(generate=generate, small_reference=small_generate)
    for name, line in lanes.items():
        emit(**{name: line})
    emit(nd=nd)
    emit(gluon=gluon)
    emit(module=module)
    emit(serve=serve)
    emit(observe=observe)
    emit(overlap=overlap)
    emit(gan=gan)
    emit(lstm_lm=lstm_lm)
    emit(sparse=sparse)
    emit(vision=vision)
    if args.profile:
        def one_more_step(state_of_path):
            _, step, state, tokens, targets = state_of_path
            return lambda: step(state, tokens, targets, TRAIN_STEPS)

        profiles = {
            "train": profile_step(torch, one_more_step(lm_state),
                                  must_run=("K1 flash_attention_fwd",)),
            "ring": profile_step(torch, one_more_step(ring_state),
                                 must_run=("K2 flash_block_partials",)),
            "trainer": trainer_profile, "generate": generate_profile,
            **{f"nd_{dtype}": profile_step(torch, step, must_run=(
                "convolution", "batchnorm"))
               for dtype, step in nd_steps.items()},
            **{f"gluon_{name}": profile_step(torch, step, must_run=() if
                                             name.startswith("update") else (
                "convolution", "batchnorm"))
               for name, step in gluon_steps.items()},
            **module_profiles, **serve_profiles, "gan": gan_profile,
            "lstm_lm": lstm_lm_profile}
        with open(args.profile, "w") as f:
            json.dump(profiles, f, indent=1)
        emit(profile={"path": args.profile, **{
            k: profile_summary(v) for k, v in profiles.items()}})
    # last: its sessions follow every capture and every other session
    emit(profiler=profiler_phase(torch, lm_state, smi))
    progress("profiler")
    emit(card_line=smi)
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
