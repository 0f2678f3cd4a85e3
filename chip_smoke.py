"""Smoke run of ``mxnet_tpu_torch`` on one NVIDIA GPU: build the CUDA
kernels from source, hold each against its plain PyTorch version, serve
a GPT-2-small-width transformer through the port's ``ModelServer`` with
paged-KV continuous batching (in process, then over HTTP beside a
predictor, under the load generator, through a live reload and through
``python -m mxnet_tpu_torch.serving``), check the numbers against the
dense reference, drive the imperative ``mx.nd`` / ``mx.autograd`` / ``mx.rtc``
path at (4096, 4096) float32 against numpy in float64, train
ResNet-50 v1 at full width through ``FusedTrainStep`` (bf16 timed,
float64 and float32 held against the CPU in float64), and train the
GPT-2-small-width transformer LM through ``TransformerTrainStep``
(the flash-attention forward and backward kernels on every layer;
``fit`` with a checkpoint resumed bit for bit; float32 held against
the CPU in float64), then train both data-parallel, one process per
card (each checked against one device, with planted faults), and
train ResNet under the memory tier: the remat scopes, the mirror and
gradient accumulation (peak memory against none; float64 against the
CPU and against none, with planted faults), then the LM
sequence-parallel (ring and Ulysses attention over an sp axis, the
flash kernels on every step; float32 against the CPU in float64, with
planted faults) and the multi-context ``Module`` with ``group2ctx``
placement, then ResNet-50 tensor-parallel over a dp x mp mesh and over
the parameter server (``dist_sync``, 2-bit compression), each held
against one device in float64 with planted faults, then sparse storage
(LibSVM CSR batches, the sparse products, lazy row updates) and the
recommender tier at full width on the local store and over
``dist_sync``, held against its dense control, the CPU and one worker,
with planted faults.  After the first ResNet phases it trains ResNet-50 fed from
records through the input tier (the decode pool and the pinned,
stream-ordered device stage).  Then come the observability tier's
phases: ``mx.profiler``'s spans and counters, ``traceview``'s device
traces of the training and serving windows, and the asynchronous
checkpoint writer; the tuning tier; and last the recurrent tier:
BASELINE config 3 (the bucketing LSTM language model) trained three
ways at full width, and the ``RNN`` op, the sequence ops and
``BucketingModule`` in float64 against the CPU, with planted faults;
then the detection tier: BASELINE config 4 (SSD-512 on ResNet-50)
trained at full width from records, detection through the NMS kernel
and the example SSD's learning check, and every detection op in
float64 against the CPU, with planted faults.

    python3 chip_smoke.py

Each phase prints one JSON line; any failure raises and the script exits
non-zero.  Before the kernel lines, ``{"phase": "phase_seconds", ...}``
gives every phase's wall seconds.  The line before the last is
``{"kernels": [...]}`` (per kernel: launches on its path, error, times,
bound); the last line is ``{"ok": true, "device": {...}}``.  Needs a CUDA device, the
CUDA toolkit (``nvcc``) and the rest of this repository beside it; it
imports nothing of JAX.

Phases:
  device   card name, power limit (nvidia-smi), TF32 off
  build    nvcc of every ``mxnet_tpu_torch/csrc/*.cu``, all at once;
           ptxas's register report; ``cuobjdump -sass`` counts of HGMMA
           (wgmma) and UTMALDG (TMA loads) and ``cuobjdump -res-usage``
           per flash kernel, forward and backward (fails if a wgmma
           kernel, ``flash_fwd_wgmma``, ``flash_bwd_dq_wgmma`` or
           ``flash_bwd_dkv_wgmma`` at D 64 or 128, has none, if a
           wgmma or backward kernel uses local memory: a spill, or if
           ptxas serialized the wgmma of a kernel it built)
  kernel:flash_attention_fwd
           the kernel against the plain version at the prefill's
           shapes, bf16 on the ``wgmma`` route (D 64 and 128, ragged T,
           the strided fused-projection view) and float32 on the
           ``simt`` route: error (absolute, and row-scaled: each
           row's error over that row's magnitude), route,
           kernel/plain/library times
           (10 calls back to back, hot L2), one call's time with the
           host's launch, device time from a CUDA graph, bound
  kernel:flash_attention_bwd
           the backward kernels (``csrc/flash_attn_bwd.cu``, from the
           forward kernel's output and log-sum-exp; the ``wgmma`` route
           for bf16, ``simt`` for float32) against their plain
           version ``flash_attention_bwd_reference`` and against
           autograd of ``attention_reference`` in float32, at the
           train_lm shape (8, 1024, 1024, 12, 64) causal bf16 (the
           wgmma forward), D 128, ragged T 1000 (D 64) and 200 (D
           128), Tq 384 < Tk 512, full, the strided fused-projection
           views, Tq > Tk in bf16 (fully masked rows: dq exactly 0) and
           float32 (simt); errors over each head's largest magnitude
           (``BWD_*_RTOL``), and a second call bitwise equal to the
           first; at the first shape the kernel (10 calls), CUDA-graph,
           plain and library (SDPA's backward alone, host-timed through
           autograd) times, the device time of both under
           torch.profiler (the sum of their kernels' durations, and
           SDPA's kernels by name: its backend), the bound (5 products
           over the unmasked pairs, or the bytes), and the forward with
           and without the log-sum-exp
  kernel:rtc_add
           NVRTC compile of ``csrc/rtc/add.cu`` through
           ``rtc.CudaModule`` (timed), the kernel against
           ``rtc.add_reference`` at (8, 128), 2**20+3 and 2**26 float32
           elements (exact) and 2**20+3 bfloat16; kernel/plain/library
           (``torch.add``) times and the bound at 2**26
  serve    vocab 32000, 12 layers, d_model 768, 12 heads, d_ff 3072,
           bf16, random weights from seed 0; slots 8, KV blocks of 16
           tokens, prompts up to 512, context up to 1024, prefill
           batches of 4; 16 requests with prompts over 16..512 and 32
           new tokens each, through ``submit_generation``; every
           prefill launch of the flash kernel on the ``wgmma`` route
  serve_http
           the same generator and 16 prompts through ``ModelServer`` +
           ``HttpFrontend`` on 127.0.0.1 (SIGTERM hook installed), 8
           streamed (one client resets after 4 tokens) and 8 blocking,
           beside the ``bench_serve`` predictor (dim 64, hidden 128,
           max batch 32: bench.py:758); then ``:predict`` of 32
           instances.  15/15 full replies, stream tokens = terminal
           count, the reset one ``cancelled`` and its blocks freed,
           ``:predict`` = ``runtime.execute``, probes 200, ``/metrics``
           valid with the request counters at the counts sent, every
           prefill flash launch on ``wgmma``; tokens/s, TTFT and TPOT
           p50/p99 (server side, as ``serve``; and at the streaming
           client) beside the ``serve`` phase's
  loadgen  ``gen_tokens_at_slo`` on the same generator (p99 TPOT SLO
           200 ms, bench.py:835; 4 req/s doubling to 64, 1 s
           windows): tokens/s at the SLO, TTFT p50/p99 there, the p99
           attribution of the ramp's slowest requests; then the
           continuous vs whole-batch A/B of bench.py:866-892 (16
           requests, every 8th at 32 new tokens, the rest 4-8) against
           a ``continuous=False`` twin sharing the weights, best of 2
  reload   the predictor under ``BackgroundLoad`` (300 req/s): weights
           of step 2 saved with ``checkpoint.save_checkpoint`` and
           reloaded (canary 50 %, 8 batches) must promote with zero
           dropped or failed requests; step 3 under chaos
           ``bad_version`` for version 3 must roll back while version
           2 keeps serving; time to promote, canary counts
  serve_cli
           ``python -m mxnet_tpu_torch.serving --self-test`` on the card
           (``"self_test_ok": true``), then ``--serve --port 0``: one
           ``:generate`` over HTTP, SIGTERM, exit code 83
  numerics the same width at 2 layers in float32: prefill logits through
           the kernel (``simt`` route) against ``apply`` with dense
           attention (1e-3 abs), and greedy tokens against the dense
           greedy reference
  ndarray  the imperative path on ``mx.gpu(0)``, twice (the first pass
           pays one-time costs): (4096, 4096) float32 operands, the rtc
           ``add`` kernel launched on them through ``CudaKernel.launch``,
           one 4096**3 ``dot``, a chain of elementwise, broadcast,
           reduce and matrix ops under ``autograd.record()`` and one
           ``backward()``; every result against numpy in float64 (error
           over the largest magnitude, 1e-4), ``nd.save``/``nd.load``
           round trips bitwise
  train    ResNet-50 v1 training at full width and depth (1000 classes,
           224x224, Xavier from numpy seed 0, SoftmaxCrossEntropyLoss,
           SGD lr 0.05 momentum 0.9) through ``FusedTrainStep.run_steps``
           in bf16 at batch 32 and at batch 128: 3 warm-up steps, then
           5 timed steps (synchronized); images/s, step ms, first and
           last losses (finite), peak memory, achieved TFLOP/s (3
           forwards of 2 x 4.09 G multiply-adds an image against the
           989 TFLOP/s bf16 peak); one float32
           step at batch 128 from the same weights and batch, whose loss
           the bf16 first loss must match within 2e-2 relative.  This
           path runs no hand-written kernel: convolutions and GEMMs are
           cuDNN/cuBLAS through torch, as the JAX package left them to XLA
  train_numerics
           ResNet-50 v1 at batch 4, 224x224: two ``FusedTrainStep``
           steps on the card and the same port on the CPU in float64
           from the same weights and batches.  The card in float64:
           losses within 1e-10 relative and the parameters' update
           within 1e-8 of its size, where a skipped step 2 or a step 2
           without momentum reads ~0.3-0.7 (checked from the reference
           trajectory).  The card in float32 (TF32 off): step 1's loss
           within 1e-4 relative; step 2's loss and the update within 5
           times the distance of the CPU's own float32 run from float64
           (see ``NUMERICS_FP32_FACTOR``)
  input    the input tier: >= 1024 seeded records (``bench.py:531-538``:
           256x256x3 JPEG quality 90; raw 224x224x3 HWC payloads where
           the native library was built without libjpeg: ``codec``),
           rounded up to whole batches of 128 a worker; the native
           ``ImageRecordIter`` on one thread (``decode_ips_1thread``),
           the decode pool at W = min(8, cores - 1) (``pool_ips``), one
           uint8 batch to the card from pageable, pinned and registered
           slot memory (``h2d_GBps``); the card's first 4 batches, two
           pool runs and a stream resumed at batch 3 held bitwise
           (digests); ResNet-50 v1 bf16 batch 128 through
           ``FusedTrainStep`` fed by ``InputPipeline`` (2 epochs, the
           first discarded: ``e2e_ips``, ``feed_efficiency`` over the
           ``train`` phase's img/s, the idle share of 6 traced steps);
           cores, W, slot bytes, the size of ``/dev/shm``, ``codec``
  train_lm GPT-2-small width (vocab 32000, 12 layers, d_model 768, 12
           heads, d_ff 3072), bf16 compute over float32 parameters,
           ``TransformerTrainStep`` (SGD lr 0.01 momentum 0.9, remat
           none) on ``LMTokenIter`` batches of 8 x 1024 tokens: 3 warm
           steps, 5 timed windows of 4 steps (tokens/s and step ms from
           the median window, peak memory, TFLOP/s of 6 x N x tokens
           plus attention), 12 forward (all ``wgmma``) and 12 backward
           (all ``wgmma``) kernel launches a step; 2 steps under
           torch.profiler after a traced warm-up step (device busy ms
           and the idle share of the untraced step, device ms by kernel
           group); ``fit`` for 20 steps
           (finite, the last loss below the first), then 10 steps
           writing a checkpoint at step 10 and a fresh step resuming it
           to step 20: losses and parameters bitwise the 20-step run's
  train_lm_numerics
           2 layers, d_model 128, 2 heads, d_ff 512, vocab 512, batch 4
           x 256: 3 steps on the card in float32 (both kernels on the
           simt route) against the port on the CPU in float64 from the
           same parameters (``LM_NUM_*`` limits, the CPU's own float32
           distance beside); one bf16 step, its loss within 2e-2 of the
           float32 first loss
  dp       data parallel, one process per visible card over NCCL
           (``dist.launch``, spawn; the kernels are built before any
           rank starts): ResNet-50 v1 bf16 at batch 128 a rank, 224x224,
           the one-device step beside the bucketed, ZeRO-1 and
           monolithic exchanges, timed in turns: images/s in total and
           a rank, step ms, peak memory, dp_efficiency (against the
           ``train`` row and against the one-device step of the same
           process), the buckets, momenta bytes a rank; from rank 0's
           torch.profiler trace the NCCL launches, device ms and the
           all-reduce ms no other kernel overlaps, a step
  dp_numerics
           ResNet-50 v1 cut to batch 4 a rank, 64x64, 10 classes,
           float64, two ranks sharing cuda:0 over gloo (NCCL takes one
           rank a card), 2 steps: against the one-device step at the
           global batch (1e-10 of the update, aux included), bucketed
           = monolithic bitwise, ZeRO-1 = replicated bitwise at lr 0 and
           within 1e-12 otherwise, accum_steps=2 (bucketed and ZeRO-1)
           against one device accumulating the same microbatches,
           stage against one device, the collectives of a step, and
           two planted faults (a rank's gradient not reduced; sync BN's
           backward without its all-reduce) above the limit; over NCCL
           on two cards where the machine has them, else a line saying
           it did not run
  remat    the train cell (ResNet-50 v1 bf16, batch 128, 224x224) under
           MXNET_REMAT_POLICY none, stage, conv_block and the mirror
           (MXNET_BACKWARD_DO_MIRROR): step ms, images/s, peak allocated
           bytes over steps 2+, memory ratio (none / policy) and
           slowdown; fails unless each policy lowers the peak
  memory_remat
           bench.py:1325's row: ResNet-18 v1, batch 16, 128x128, bf16,
           the mirror off and on: memory ratio and slowdown (reported;
           only the losses are held)
  large_batch_remat
           bench.py:1421's row: ResNet-50 v1 at an effective batch of
           128 in 4 microbatches of 32, bf16, stage, beside its none
           twin at the same accumulation: images/s, TFLOP/s, both peaks
           and their ratio, images/s against the train row
  remat_numerics
           a marked conv net in float64 (see REMAT_NUM): each policy
           and accum_steps=2 on the card against the CPU within 1e-10 of
           the update, each against none on the card bit for bit with
           BatchNorm and Dropout inside a stage, the symbolic executor's
           stage fit against its none fit, two gloo ranks at stage +
           accum 2 against one device; three planted faults above the
           limit
  train_lm_dp
           the train_lm cell a rank with ZeRO-1 over NCCL: tokens/s,
           efficiency against ``train_lm``, momenta bytes a rank
           (sharded, replicated), 12 forward and 12 backward ``wgmma``
           launches a step a rank, fit 20 steps and a step-10 ZeRO-1
           checkpoint resumed bitwise
  train_lm_dp_numerics
           train_lm_numerics's cut on two gloo ranks on cuda:0 in
           float32: the trajectory against the CPU float64 one (the
           LM_NUM_* limits), a dp=2 ZeRO-1 checkpoint restaged to dp=1
           continuing the dp=2 run; planted faults above the limit
  train_lm_sp
           the train_lm width sequence-parallel: a global batch of 2 x
           8192 tokens over sp=2, two gloo ranks sharing cuda:0 (K/V,
           the all-to-alls and the gradients cross through host
           buffers), ring then Ulysses, one warm-up and 3 timed steps:
           tokens/s, step ms, peak memory a rank, flash launches a step
           a rank (ring: 12 and 24 forward and backward on ranks 0 and
           1; Ulysses 12 and 12; all wgmma), the first loss within 2e-2
           of the one-device step's at the same batch and parameters;
           over NCCL where there are two cards, else a line saying it
           did not run
  train_lm_sp_numerics
           train_lm_numerics's cut in float32 (simt): ring and Ulysses
           at sp=2 (two gloo ranks) and dp=2 x sp=2 (four) on cuda:0
           against the CPU float64 one-device trajectory (the LM_NUM_*
           limits), ZeRO-1 with sp = replicated bitwise at lr 0, a
           dp=2 x sp=2 ZeRO-1 checkpoint continued on one device, three
           ring faults planted (the diagonal unmasked, the merge
           dropped, dk/dv not brought home) above the limit
  module_dp_numerics
           fit_numerics's symbol at batch 4 a rank, float64:
           Module(context=[gpu(0), gpu(1)]) on two gloo ranks on cuda:0
           against the one-device Module at the global batch (1e-10 of
           the update, aux included) under kvstore local, tpu and nccl;
           the list collapsed in one process = one device bitwise; a
           rank's gradient left unreduced above the limit; group2ctx
           placement (a group on the host, one on the card) against the
           unplaced run, across two cards where there are two
  tp       ResNet-50 v1 bf16 at batch 128, 224^2, tensor-parallel over
           a dp=1 x mp=2 mesh (two gloo ranks on cuda:0): the classifier
           and every conv of >= 256 output channels over mp
           (``__graft_entry__.py:136-149``'s rule); img/s and step ms
           (two ranks share the card: not comparable with ``train``),
           the parameter + momenta bytes a rank against the replicated
           step's, the mp collectives a step by verb
  tp_numerics
           a float64 conv net with BatchNorm (a column-parallel conv
           with its bias, a column- and a row-parallel Dense, parameters
           gathered on use) at dp=1 x mp=2 and dp=2 x mp=2 on cuda:0
           against the one-device step at the global batch: 1e-10 of
           the update, aux included; two planted faults above it (the
           input gradient's mp all-reduce skipped, a shard's gradient
           not reduced over dp); a global read = the one-device values
  dist     a loopback parameter-server cluster from the port's launcher
           (2 workers on cuda:0, 1 server): ResNet-50 v1 bf16 at batch
           32 a worker through gluon.Trainer over dist_sync with the
           server's SGD, img/s a worker, step ms, push and pull bytes a
           step from the counters, seconds a step in push, pull and on
           the server; again under MXNET_GRADIENT_COMPRESSION=2bit (the
           push bytes are the 2-bit codes, the pull bytes dense)
  dist_numerics
           a float64 conv net: 2 workers x batch 8 over dist_sync
           against one process at batch 16 under local (1e-10 of the
           update); a worker's push dropped from a round above it; the
           card's 2-bit codes and residuals = the host's byte for byte
           over steps; dist_async applies every push once
  sparse   a seeded LibSVM file (8192 rows over 2**20 features, 8-56
           nonzeros a row: example/sparse/linear_classification's shape
           at a million features) through ``LibSVMIter`` at batch 512
           (parse rows/s); on the card ``sparse.dot(csr, W)`` and
           ``dot(csr.T, G)`` with W (2**20, 16) float32 against float64
           numpy (1e-5 of each output row's magnitude); SGD momentum
           0.9, Adam and AdaGrad lazy updates over two batches' columns
           (touched rows against float64 numpy at 1e-5, untouched rows
           and states bitwise); rsp add / subtract / retain exact; a
           ``.params`` file with a CSR and a row-sparse array round
           trip bitwise; the products' and the lazy update's times
           beside their bytes bounds, the dense product of the
           densified batch, ``torch.sparse.mm`` and a dense
           ``sgd_mom_update`` on the same weight
  recommender
           bench.py:1121's row at RecommenderConfig's full width (8
           fields of 65536 x 16, MLP (64, 32), batch 128, 4 shards a
           table) on the local store on the card: 10 timed steps of the
           sparse tier, then of the dense control (SGD lr 0.05,
           clickstream seed 7): samples/s, speedup, mean unique rows,
           the pulled bytes and their ratio (<= 2x the ideal); the lr 0
           pin over 4 steps bitwise; two identical runs of each held
           side by side (bitwise or not: reported); 5 sparse steps under
           torch.profiler (device busy, idle share) and the host syncs a
           step; then dist_sync, 2 workers on cuda:0 and 2 servers, each
           worker on its part of the stream: 4 steps (samples/s a
           worker, row-sparse bytes a step against the formula, the
           shard keys on both servers), then 2 under 2-bit compression
           (push bytes = ``rows_wire_nbytes``)
  recommender_numerics
           tests/test_sparse.py:485-524's configuration (3 fields,
           vocab 500, dim 4, MLP (8,), batch 16, 3 shards, 8 steps),
           float32: sparse against the dense control (bitwise at lr 0;
           1e-6 / 1e-7 at lr 0.05), the card against the port on the
           CPU (losses 1e-6, update 1e-5), 2 workers at batch 8 over
           dist_sync against one local worker at batch 16 (1e-5); two
           planted faults above 1e-2 (momentum decayed on untouched
           rows; pushed rows permuted against their ids)
  profiler ``mx.profiler`` on the card: host us per ``nd.invoke`` over
           a 2000-op chain stopped and running (profile_sync); the
           ndarray chain at (4096, 4096) and 3 batches of the ``fit``
           cell (symbolic ResNet-50, batch 32, local kvstore, SGD) with
           the profiler on and profile_memory: the dump holds the op
           names, ``Forward<...>`` / ``Backward<...>``,
           ``Module::update``, ``SGD::update``, the kvstore verbs and
           ``NDArrayIter::next``; ``kvstore:push_bytes`` = the
           parameters' bytes x 3 exactly
  traceview
           ``MXNET_TRACE_DIR`` + ``MXNET_TRACE_STEPS=3`` on ``train_lm``
           at full width: a summary of 3 steps whose windows hold 12
           ``flash_fwd`` and 12 ``flash_bwd`` (dkv and dq) launches, all
           ``wgmma``, and whose attributed device-busy ms a step is
           within 10 % of ``lm_profile``'s for the same step right
           after (the ``train_lm`` row's is reported beside); one
           window each of ResNet-50 ``FusedTrainStep`` at batch 32
           (phases), of the serving generation tier at the serve
           cell's width (its prefill tick's flash launches, a multiple
           of 12, all wgmma) and of the ``dp`` cell at one NCCL rank,
           bucketed (its bucket scopes against the plan, the bucket
           reduces found, ``plan_match``, the collectives by name)
  ckpt_async
           ``TransformerTrainStep.fit`` at the train_lm width, 6 steps
           with a checkpoint every 2, on the asynchronous writer and
           then blocking: save()'s return s, the blocking save's s,
           wait()'s s, step ms with a write in flight against steady
           steps; the asynchronous shard bitwise the blocking one and
           verified, a resume from its step 4 bitwise the blocking run;
           a SIGTERM to a child ``Module.fit`` (this script,
           ``--ckpt-child``) while its writer holds a ``.tmp`` shard:
           exit 83, every step verified, no ``.tmp`` left
  tuning   ``parallel.scaling.sweep((1, 2))``: ResNet-18 at 8 classes,
           two gloo ranks on cuda:0, the trajectory against one rank
           and the collectives a step by verb; the ``dp`` cell at batch
           32 on a one-rank NCCL group (a ``dist.launch`` child), one
           traced window a run, the summary tuned (``autotune.tune``, the
           link bandwidth explicit, with its source), the plan saved,
           the step re-run under ``MXNET_AUTOTUNE_PLAN`` and under
           ``MXNET_AUTOTUNE_DIR``: ``mxbkt`` scopes in each trace = the
           tuned plan's buckets, ``plan_meta``'s ``autotune`` block,
           losses bitwise the untuned run's; ``audit_recorded_steps()``
           over ``train_lm``, ``FusedTrainStep`` and the bulk fit (and
           the NCCL step in the child); ``python -m
           mxnet_tpu_torch.analysis --self-test`` and ``autotune
           --self-test``; the sweep and the child run beside the audit
  rnn      BASELINE config 3, example/rnn/bucketing/lstm_bucketing.py's
           defaults: 2 LSTM layers of 200, embed 200, vocabulary 10000
           (PTB's), batch 32, buckets 10-60, invalid label 0, SGD lr
           0.01, wd 1e-5, float32, on a seeded synthetic corpus (a Zipf
           draw, half the words followed by their successor) that fills
           every bucket: (a) the unrolled ``mx.rnn.LSTMCell`` stack and
           (b) ``FusedRNNCell`` (the ``RNN`` op, cuDNN) through
           ``BucketingModule.fit``, two batches a bucket; (c)
           ``gluon.rnn.LSTM(200, num_layers=2, dropout=0.2)`` between
           ``Embedding`` and ``Dense``, bptt 35, 20 ``Trainer`` SGD
           steps with the global norm clipped.  Each: tokens/s, step
           ms, held-out perplexity before and after (must fall), the
           RNN op's calls by route and dtype (all cudnn in b and c; one
           fused pass a layer under c's dropout), 3 traced windows
           (traceview: device-busy ms, idle share, device launches a
           step); (a) and (b): all six buckets visited, every bucket's
           executor on the same parameter storage
  rnn_numerics
           float64 on the card against the port on the CPU (1e-10): the
           RNN op on its route and on the scan, every mode, 1 and 2
           layers, one and two directions, without state outputs, and
           under the state clip (the scan route), forward and
           gradients; one call each in float32 / float64 / bfloat16
           with the CUDA kernels it ran; the sequence ops with lengths;
           three batches of ``BucketingModule.fit`` over two buckets,
           unrolled and fused; planted faults: the i and f gates
           swapped in the cuDNN route's weights, the scan's reverse
           direction left unflipped, a bucket bound to its own copy of
           the parameters
  ssd      BASELINE config 4, example/ssd's ``--network resnet50
           --data-shape 512``: (a) SSD-512 on the port's
           ``resnet50_v1`` (features[6] and [7], four extra layers, six
           heads, 6,132 anchors, 20 classes), Xavier, SGD lr 0.004,
           momentum 0.9, wd 5e-4, batch 32, float32, from seeded JPEG
           records through ``ImageDetRecordIter`` (force-resized to
           512²): images/s and step ms on device-resident batches, the
           iterator's rate, peak memory, a torch.profiler window (idle
           share, launches a step, MultiBoxTarget's device ms), the
           loss on one fixed batch over the first 10 steps from Xavier,
           its targets taken at the first (must fall), then
           MultiBoxDetection (0.01, NMS 0.45, top 400) on 32 held-out
           images: its ms at (32, 6132), rows kept, the VOC07 mAP
           (printed, not judged), the NMS kernel (``csrc/box_nms.cu``)
           against its plain version at the detection's shapes; (b) the
           example's SSDNet through tests/test_ssd_e2e.py's learning
           check and bars (4 epochs, batch 16, lr 0.06, 40²)
  ssd_numerics
           float64 on the card against the port on the CPU (1e-10;
           fft / ifft 1e-5): every op of DET_CASES (the 42 names of the
           detection tier) forward and backward; box_nms at (32, 6132)
           (keep sets equal; the kernel against its plain version); the
           RPN's NMS at MultiProposal's defaults, (2, 6000) float32
           without ids, the kernel against its plain version; one
           step of examples/rcnn/mini_rcnn.py's network; planted
           faults: priors half a cell off, NMS across classes, the
           encoder's variances swapped
  phase_seconds
           every phase's wall seconds; the recurrent and the detection
           phases' sums and the whole run against their budgets (90 s,
           60 s, 850 s)
  kernels  every kernel and its status
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

# published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12     # float32 outside the tensor cores
PEAK_BYTES_S = 3.35e12

GPT2_SMALL = dict(vocab_size=32000, n_layers=12, d_model=768, n_heads=12,
                  d_ff=3072)
SERVE = dict(slots=8, block_tokens=16, max_prompt=512, max_context=1024,
             prefill_batch=4, max_new=32)
N_REQUESTS = 16

# the repo's headline training row (bench.py:111 batch 32, :132 batch 128;
# bench_model at bench.py:283-305)
RESNET_BATCHES = (32, 128)
TRAIN_WARMUP, TRAIN_STEPS = 3, 5
TRAIN_LR, TRAIN_MOMENTUM = 0.05, 0.9
# ResNet-50 v1 does 4.09 G multiply-adds a 224x224 forward (He et al.
# 2015, table 1; bench.py:185 lists them as GFLOP): 2 FLOP each
RESNET50_GFLOP = 2 * 4.09    # forward GFLOP a 224x224 image
TRAIN_FLOP_FACTOR = 3.0     # forward + dgrad + wgrad
BF16_LOSS_RTOL = 2e-2       # bf16 activations against float32, step 1
NUMERICS_BATCH = 4
# train_numerics holds the card's SGD-momentum trajectory, two steps in
# float64, against the same port on the CPU in float64: cuDNN's and the
# CPU's convolutions sum in other orders, and the gradients below the
# last block amplify that ~1e5-fold (the folded BatchNorm, below), so
# float64 agrees to ~1e-11 where float32 cannot tell a fault from its
# own rounding.  Errors: losses relative; parameters as ||card - cpu||
# over ||cpu - start|| (the size of the update) after each step
TRAJ_LOSS_RTOL = 1e-10
TRAJ_UPDATE_TOL = 1e-8
# the same two steps in float32 on the card are held to the CPU float64
# run too.  Step 1's loss is one forward: 1e-4 relative.  After that the
# float32 gradient of this net at this initialisation is ill-conditioned:
# the reference's BatchNorm folds its normalisation into a scale and a
# shift (ops/nn.py:465-471), so d/dscale = sum(dy*x) - mean*sum(dy), a
# difference of two large sums; on the CPU, float32 lies 1-3 % (norm)
# from float64 in the gradients below the last block, and the JAX
# package's float32 further (tools/resnet_fp32_conditioning.py).  So the
# float32 update and step 2's float32 loss are held to
# NUMERICS_FP32_FACTOR times how far the CPU's own float32 run of the
# same steps lies from float64, and never looser than these floors
TRAIN_LOSS_RTOL = 1e-4
TRAIN_UPDATE_TOL = 1e-3
NUMERICS_FP32_FACTOR = 5.0

# the largest error of an output row over the largest magnitude of that
# row of the plain version, per dtype: bf16 rounding of the output (and
# of P on the wgmma route) stays near 2**-9 of a row, where an absolute
# limit would let a late causal row (magnitude ~0.1) be wrong by tens of
# per cent; a row that should be all zero is held to zero
ROW_RTOL = {torch.bfloat16: 1e-2, torch.float32: 1e-3}
# (B, Tq, Tk, H, D, causal, dtype, atol, layout); the first is the
# serving path's largest prefill cell (4 prompts padded to 512);
# layout "fused": q, k and v are strided views of one fused projection
KERNEL_SHAPES = [
    (4, 512, 512, 12, 64, True, torch.bfloat16, 2e-2, "dense"),
    (4, 512, 512, 12, 128, True, torch.bfloat16, 2e-2, "dense"),
    (2, 200, 200, 12, 64, True, torch.bfloat16, 2e-2, "dense"),
    (4, 512, 512, 12, 64, True, torch.bfloat16, 2e-2, "fused"),
    (1, 200, 200, 12, 64, True, torch.float32, 1e-4, "dense"),
    (2, 64, 192, 12, 64, True, torch.float32, 1e-4, "dense"),
    (2, 128, 128, 12, 64, False, torch.float32, 1e-4, "dense"),
]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters: int = 25, warmup: int = 3, inner: int = 1) -> float:
    """Median device time of ``fn`` over ``iters`` runs (CUDA events);
    with ``inner`` > 1 each run is that many calls back to back, divided
    out, so the host's launch overhead hides behind the device work."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def graph_ms(fn, inner: int = 10) -> float:
    """Device time of one ``fn`` call: ``inner`` calls captured in a
    CUDA graph, the replay timed as :func:`time_ms` does, divided by
    ``inner``.  No host launch cost is in it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    return time_ms(graph.replay) / inner


def row_scaled_err(got, want) -> float:
    """Largest error of a row of ``got`` (over its last dim) divided by
    the largest magnitude of the same row of ``want``."""
    err = (got.float() - want).abs().amax(-1)
    return (err / want.abs().amax(-1).clamp_min(1e-30)).max().item()


def attention_bound(B, Tq, Tk, H, D, causal, dtype):
    """(bound_ms, bound_by) for attention over these inputs: the larger
    of the bytes (q, k, v read once, o written once) over the memory
    rate and the FLOPs of the unmasked (q, k) pairs (two products of
    2*D each) over the peak rate of the input type."""
    if causal:
        shift = Tk - Tq
        pairs = sum(max(min(Tk, i + shift + 1), 0) for i in range(Tq))
    else:
        pairs = Tq * Tk
    flops = 4.0 * B * H * D * pairs
    elem = torch.finfo(dtype).bits // 8
    nbytes = elem * B * H * D * (2 * Tq + 2 * Tk)
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def phase_device():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "allow_tf32": False})


def _kernel_label(mangled: str) -> str:
    """``flash_fwd_wgmma<64>``, ``flash_fwd_kernel<bf16,128>`` and so on
    from a mangled kernel name."""
    m = re.search(r"(flash_(?:fwd|bwd)_\w+?)I(13__nv_bfloat16|f)?Li(\d+)E",
                  mangled)
    if not m:
        return mangled
    dt = {"13__nv_bfloat16": "bf16,", "f": "f32,"}.get(m.group(2), "")
    return "%s<%s%s>" % (m.group(1), dt, m.group(3))


def _cuobjdump(lib: Path, flag: str) -> str:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([tool, flag, str(lib)], capture_output=True,
                          text=True, timeout=120, check=True).stdout


def _sass_counts(sass: str):
    """{kernel: {"HGMMA": n, "UTMALDG": n, "UTMASTG": n}} from the
    output of ``cuobjdump -sass``."""
    out, cur = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = _kernel_label(m.group(1))
            out[cur] = {"HGMMA": 0, "UTMALDG": 0, "UTMASTG": 0}
        elif cur:
            for op in out[cur]:
                out[cur][op] += op in ln
    return out


def _res_usage(text: str):
    """{kernel: {"REG": n, "STACK": n, "LOCAL": n}} from the output of
    ``cuobjdump -res-usage`` (a spill lands in LOCAL and STACK)."""
    out, cur = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function (\S+?):", ln)
        if m:
            cur = _kernel_label(m.group(1))
            out[cur] = {}
        if cur:
            for key in ("REG", "STACK", "LOCAL"):
                m = re.search(r"\b%s:(\d+)" % key, ln)
                if m:
                    out[cur][key] = int(m.group(1))
    return out


def phase_build():
    from mxnet_tpu_torch import _build

    t0 = time.perf_counter()
    secs = _build.build()
    wall = time.perf_counter() - t0
    # ptxas speaks only when nvcc ran (printed, not read); cuobjdump
    # reads any built library, a cached one too
    ptxas = {n: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
             for n, log in _build.build_logs.items()}
    # "wgmma.mma_async instructions are serialized": every wgmma of the
    # kernel then waits for the one before (the backward ran 1.5x slower)
    serialized = [ln.strip() for log in _build.build_logs.values()
                  for ln in log.splitlines() if "are serialized" in ln]
    lib = _build._lib_path(_build.sources()["flash_attn_fwd"])
    sass = _sass_counts(_cuobjdump(lib, "-sass"))
    usage = _res_usage(_cuobjdump(lib, "-res-usage"))
    bwd_lib = _build._lib_path(_build.sources()["flash_attn_bwd"])
    bwd_sass = _sass_counts(_cuobjdump(bwd_lib, "-sass"))
    bwd_usage = _res_usage(_cuobjdump(bwd_lib, "-res-usage"))
    emit({"phase": "build", "seconds": round(wall, 3),
          "per_source_s": {k: round(v, 3) for k, v in secs.items()},
          "ptxas": ptxas, "wgmma_serialized": serialized,
          "flash_sass": sass, "flash_res_usage": usage,
          "flash_bwd_sass": bwd_sass, "flash_bwd_res_usage": bwd_usage})
    wgmma = ["flash_fwd_wgmma<64>", "flash_fwd_wgmma<128>"]
    bwd_wgmma = ["flash_bwd_%s_wgmma<%d>" % (part, d)
                 for part in ("dq", "dkv") for d in (64, 128)]
    all_sass = dict(sass, **bwd_sass)
    if not all(all_sass.get(k, {}).get("HGMMA") and all_sass[k]["UTMALDG"]
               for k in wgmma + bwd_wgmma):
        raise RuntimeError("build: the wgmma flash kernels lack HGMMA or "
                           "UTMALDG instructions: %r" % all_sass)
    spills = {k: usage.get(k) for k in wgmma
              if usage.get(k, {}).get("LOCAL", 1) or usage[k].get("STACK", 1)}
    bwd = ["flash_bwd_%s<%s,%d>" % (part, dt, d) for part in ("dq", "dkv")
           for dt in ("f32", "bf16") for d in (64, 128)] + bwd_wgmma
    spills.update({k: bwd_usage.get(k) for k in bwd
                   if bwd_usage.get(k, {}).get("LOCAL", 1)
                   or bwd_usage[k].get("STACK", 1)})
    if serialized:
        raise RuntimeError("build: ptxas serialized wgmma: %r" % serialized)
    if spills:
        raise RuntimeError("build: the wgmma or backward flash kernels "
                           "spill (or their resource usage is unreadable): "
                           "%r" % spills)


def phase_kernel():
    from mxnet_tpu_torch.parallel.attention import (flash_attention,
                                                    flash_attention_fwd,
                                                    kernel_route)

    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(0)
    rows = []
    for B, Tq, Tk, H, D, causal, dtype, atol, layout in KERNEL_SHAPES:
        if layout == "fused":
            # the prefill's q/k/v: column blocks of one projection
            qkv = torch.randn((B, Tq, 3 * H * D), generator=g).to(dev, dtype)
            q, k, v = (x.reshape(B, Tq, H, D)
                       for x in torch.split(qkv, H * D, dim=-1))
        else:
            q, k, v = (torch.randn((B, T, H, D), generator=g).to(dev, dtype)
                       for T in (Tq, Tk, Tk))
        n0 = flash_attention_fwd.launches
        by0 = dict(flash_attention_fwd.launches_by_route)
        out = flash_attention_fwd(q, k, v, causal=causal)
        torch.cuda.synchronize()
        route = [r for r, n in flash_attention_fwd.launches_by_route.items()
                 if n != by0[r]]
        want_route = kernel_route(dtype, D)
        if flash_attention_fwd.launches != n0 + 1 or route != [want_route]:
            raise RuntimeError("flash_attention_fwd did not count one "
                               "launch on the %s route: %r"
                               % (want_route, route))
        qf, kf, vf = q.float(), k.float(), v.float()
        want = flash_attention(qf, kf, vf, causal=causal)
        if out.shape != q.shape or out.dtype != dtype:
            raise RuntimeError("kernel output %s %s" % (out.shape,
                                                        out.dtype))
        if not torch.isfinite(out).all():
            raise RuntimeError("kernel output is not finite")
        err = (out.float() - want).abs().max().item()
        row_err = row_scaled_err(out, want)
        # the library yardstick: one PyTorch call for the same function
        # (BHTD layout; an explicit mask for the aligned diagonal)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        if causal and Tq != Tk:
            mask = torch.ones((Tq, Tk), dtype=torch.bool,
                              device=dev).tril(Tk - Tq)
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, attn_mask=mask)
        else:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=causal)
        lib_err = (lib().transpose(1, 2).float() - want).abs().max().item()
        bound_ms, bound_by = attention_bound(B, Tq, Tk, H, D, causal,
                                             dtype)
        kern = lambda: flash_attention_fwd(q, k, v,  # noqa: E731
                                           causal=causal)
        # device times over runs of 10 back-to-back calls on inputs that
        # stay in the 50 MB L2 (hot); single_call_ms is one call between
        # two events, host launch cost included, as serving pays it
        row = {
            "shape": [B, Tq, Tk, H, D], "causal": causal,
            "dtype": str(dtype).replace("torch.", ""), "layout": layout,
            "route": want_route, "max_err": err, "atol": atol,
            "row_err": row_err, "row_rtol": ROW_RTOL[dtype], "l2": "hot",
            "kernel_ms": time_ms(kern, inner=10),
            "plain_ms": time_ms(lambda: flash_attention(
                qf, kf, vf, causal=causal), inner=10),
            "library_ms": time_ms(lib, inner=10),
            "single_call_ms": time_ms(kern),
            "library_single_call_ms": time_ms(lib),
            "graph_ms": graph_ms(kern), "library_graph_ms": graph_ms(lib),
            "library_max_err": lib_err,
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        emit(dict({"phase": "kernel:flash_attention_fwd"}, **row))
        if not (err <= atol and row_err <= ROW_RTOL[dtype]):
            raise RuntimeError("flash_attention_fwd disagrees with the "
                               "plain version at %s: error %g (limit %g), "
                               "row-scaled %g (limit %g)"
                               % (row["shape"], err, atol, row_err,
                                  ROW_RTOL[dtype]))
        rows.append(row)
    return rows


# (B, Tq, Tk, H, D, causal, dtype, layout); the first is the train_lm
# phase's attention (GPT-2-small width, batch 8, seq 1024, bf16: the
# wgmma forward); layout "fused": q, k and v are the strided views of
# one fused projection that transformer/model.py _qkv makes
BWD_SHAPES = [
    (8, 1024, 1024, 12, 64, True, torch.bfloat16, "dense"),
    (2, 512, 512, 12, 128, True, torch.bfloat16, "dense"),
    (2, 1000, 1000, 12, 64, True, torch.bfloat16, "dense"),
    (2, 384, 512, 12, 64, True, torch.bfloat16, "dense"),
    (2, 512, 512, 12, 64, False, torch.bfloat16, "dense"),
    (8, 1024, 1024, 12, 64, True, torch.bfloat16, "fused"),
    (2, 300, 200, 12, 64, True, torch.bfloat16, "dense"),
    (2, 200, 200, 12, 128, True, torch.bfloat16, "dense"),
    (2, 512, 512, 12, 64, True, torch.float32, "dense"),
    (2, 300, 200, 12, 64, True, torch.float32, "dense"),
]
# a gradient's error over the largest magnitude of its head (each (b, h)
# slice): the scale of its rounding (a row can cancel to ~0, as causal
# row 0 of dq does exactly, so a row's own magnitude is no scale).
# Against the plain backward on the same inputs (the kernel's own o and
# lse): float32 is another summation order; bf16 (the wgmma route) rounds
# P and dS to bf16 for their products and the gradients on output.
# Against autograd of attention_reference in float32: bf16 also carries
# the wgmma forward's bf16 P in o
BWD_HEAD_RTOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
BWD_AUTOGRAD_RTOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def head_scaled_err(got, want) -> float:
    """Largest error of a (B, T, H, D) tensor within each (b, h) head
    over the largest magnitude of ``want`` in that head."""
    err = (got.float() - want.float()).abs().amax(dim=(1, 3))
    return (err / want.float().abs().amax(dim=(1, 3)).clamp_min(1e-30)
            ).max().item()


def causal_pairs(Tq, Tk, causal):
    if not causal:
        return Tq * Tk
    shift = Tk - Tq
    return sum(max(min(Tk, i + shift + 1), 0) for i in range(Tq))


def attention_bwd_bound(B, Tq, Tk, H, D, causal, dtype):
    """(bound_ms, bound_by) of the attention backward: the larger of the
    bytes (q, k, v, o, dO and lse read once, dq, dk and dv written once)
    over the memory rate, and five products of 2*D FLOPs over the
    unmasked (q, k) pairs over the input type's peak."""
    elem = torch.finfo(dtype).bits // 8
    nbytes = elem * B * H * D * (4 * Tq + 4 * Tk) + 4 * B * H * Tq
    flops = 5 * 2.0 * B * H * D * causal_pairs(Tq, Tk, causal)
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def profiled_ms(fn, calls: int = 10):
    """Device time of one ``fn`` call under torch.profiler: the summed
    durations of the CUDA kernels (and copies) that ``calls`` calls
    launch, over ``calls``; and the same by kernel name, largest
    first."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    per = defaultdict(float)
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA and \
                not getattr(ev, "is_user_annotation", False):
            per[ev.name] += ev.device_time_total / 1e3 / calls
    names = sorted(per.items(), key=lambda kv: -kv[1])
    return sum(per.values()), [[n[:120], ms] for n, ms in names]


def phase_kernel_bwd():
    """The backward kernel against its plain version and against
    autograd of ``attention_reference``, at the training path's shape
    and the edge cases; times at the first shape."""
    from mxnet_tpu_torch.parallel.attention import (
        attention_reference, bwd_route, flash_attention_bwd,
        flash_attention_bwd_reference, flash_attention_fwd, kernel_route)

    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(1)
    rows = []
    for i, (B, Tq, Tk, H, D, causal, dtype, layout) in enumerate(BWD_SHAPES):
        if layout == "fused":
            qkv = torch.randn((B, Tq, 3 * H * D), generator=g).to(dev, dtype)
            q, k, v = (x.reshape(B, Tq, H, D)
                       for x in torch.split(qkv, H * D, dim=-1))
        else:
            q, k, v = (torch.randn((B, T, H, D), generator=g).to(dev, dtype)
                       for T in (Tq, Tk, Tk))
        do = torch.randn((B, Tq, H, D), generator=g).to(dev, dtype)
        o, lse = flash_attention_fwd(q, k, v, causal=causal,
                                     return_lse=True)
        route = bwd_route(q, k, v, o, do)
        want_route = "wgmma" if dtype == torch.bfloat16 else "simt"
        n0 = flash_attention_bwd.launches_by_route[route]
        got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        torch.cuda.synchronize()
        if route != want_route or \
                flash_attention_bwd.launches_by_route[route] != n0 + 1:
            raise RuntimeError("flash_attention_bwd did not count one "
                               "launch on the %s route (%s)"
                               % (want_route, route))
        # no atomics: a second call gives the same bits
        again = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        del again
        f32 = [t.float() for t in (q, k, v, o, do)]
        want = flash_attention_bwd_reference(f32[0], f32[1], f32[2], f32[3],
                                             lse, f32[4], causal=causal)
        leaves = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
        # attention_reference gives a row that sees no key (causal, Tq >
        # Tk) the mean of V where flash attention gives 0: no gradient
        # flows from such a row in the function the kernel computes
        do_ref = f32[4].clone()
        if causal and Tq > Tk:
            do_ref[:, :Tq - Tk] = 0
        ref = torch.autograd.grad(
            attention_reference(*leaves, causal=causal), leaves, do_ref)
        del leaves, do_ref
        bad = [n for n, t in zip(("dq", "dk", "dv"), got)
               if t.dtype != dtype or t.shape != (q if n == "dq" else k).shape
               or not torch.isfinite(t).all()]
        if bad:
            raise RuntimeError("flash_attention_bwd: bad %s at %s"
                               % (bad, (B, Tq, Tk, H, D)))
        row = {"shape": [B, Tq, Tk, H, D], "causal": causal,
               "dtype": str(dtype).replace("torch.", ""), "layout": layout,
               "forward_route": kernel_route(dtype, D), "route": route,
               "max_err": max((a.float() - b).abs().max().item()
                              for a, b in zip(got, want)),
               "head_err": {n: head_scaled_err(a, b) for n, a, b in
                            zip(("dq", "dk", "dv"), got, want)},
               "head_rtol": BWD_HEAD_RTOL[dtype],
               "autograd_head_err": {n: head_scaled_err(a, b) for n, a, b in
                                     zip(("dq", "dk", "dv"), got, ref)},
               "autograd_head_rtol": BWD_AUTOGRAD_RTOL[dtype],
               "bitwise_repeat": bitwise}
        if causal and Tq > Tk:
            row["masked_rows_dq_nonzero"] = int(
                torch.count_nonzero(got[0][:, :Tq - Tk]))
        if i == 0:
            bound_ms, bound_by = attention_bwd_bound(B, Tq, Tk, H, D,
                                                     causal, dtype)
            kern = lambda: flash_attention_bwd(  # noqa: E731
                q, k, v, o, lse, do, causal=causal)
            # the library yardstick: SDPA's backward alone (BHTD), its
            # forward run once outside the timing
            qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_(True)
                          for t in (q, k, v))
            out_t = F.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=causal)
            do_t = do.transpose(1, 2)
            lib = lambda: torch.autograd.grad(  # noqa: E731
                out_t, (qt, kt, vt), do_t, retain_graph=True)
            dev_ms, dev_kernels = profiled_ms(kern)
            lib_dev_ms, lib_kernels = profiled_ms(lib)
            row.update({
                "kernel_ms": time_ms(kern, iters=10),
                "graph_ms": graph_ms(kern, inner=3),
                "plain_ms": time_ms(lambda: flash_attention_bwd_reference(
                    f32[0], f32[1], f32[2], f32[3], lse, f32[4],
                    causal=causal), iters=5, warmup=1),
                "library_ms": time_ms(lib, iters=10),
                "device_ms": dev_ms, "device_kernels": dev_kernels,
                # SDPA's backward as device time, on the same basis
                "library_graph_ms": lib_dev_ms,
                "library_graph_basis": "torch.profiler: summed kernel "
                                       "durations a call, 10 calls",
                "library_kernels": lib_kernels,
                "fwd_lse_ms": time_ms(lambda: flash_attention_fwd(
                    q, k, v, causal=causal, return_lse=True), inner=10),
                "fwd_ms": time_ms(lambda: flash_attention_fwd(
                    q, k, v, causal=causal), inner=10),
                "bound_ms": bound_ms, "bound_by": bound_by})
            del out_t, qt, kt, vt
        emit(dict({"phase": "kernel:flash_attention_bwd"}, **row))
        if max(row["head_err"].values()) > BWD_HEAD_RTOL[dtype] or \
                max(row["autograd_head_err"].values()) > \
                BWD_AUTOGRAD_RTOL[dtype] or row.get("masked_rows_dq_nonzero") \
                or not bitwise:
            raise RuntimeError("flash_attention_bwd disagrees at %s: %r"
                               % (row["shape"], row))
        rows.append(row)
        del q, k, v, o, lse, do, got, want, ref, f32
    return rows


def _add_grid(n: int):
    """Grid of the rtc add kernel: 256 threads a block, 4 elements a
    thread, at most 8 blocks per SM (the loop strides over the rest)."""
    return (max(1, min(-(-n // (256 * 4)), 132 * 8)), 1, 1), (256, 1, 1)


def _add_source() -> str:
    import mxnet_tpu_torch

    return (Path(mxnet_tpu_torch.__file__).resolve().parent / "csrc"
            / "rtc" / "add.cu").read_text()


ADD_SIG = "const {0} *x, const {0} *y, {0} *out, long n"
# (elements, dtype, kernel name, C type)
RTC_ADD_SIZES = [
    ((8, 128), torch.float32, "add", "float"),
    ((2 ** 20 + 3,), torch.float32, "add", "float"),
    ((2 ** 26,), torch.float32, "add", "float"),
    ((2 ** 20 + 3,), torch.bfloat16, "add_bf16", "__nv_bfloat16"),
]


def phase_rtc_add():
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import rtc

    t0 = time.perf_counter()
    mod = rtc.CudaModule(_add_source())
    nvrtc_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for shape, dtype, name, ctype in RTC_ADD_SIZES:
        k = mod.get_kernel(name, ADD_SIG.format(ctype))
        x, y = (mx.nd.NDArray.from_raw(
            torch.randn(shape, generator=g, device=dev).to(dtype),
            mx.gpu(0)) for _ in range(2))
        out = mx.nd.zeros(shape, ctx=mx.gpu(0), dtype=dtype)
        n = x.size
        grid, block = _add_grid(n)
        n0 = rtc.launches[name]

        def launch():
            k.launch([x, y, out, n], mx.gpu(0), grid, block)

        launch()
        torch.cuda.synchronize()
        if rtc.launches[name] != n0 + 1:
            raise RuntimeError("rtc add did not count its launch")
        want = rtc.add_reference(x._data, y._data)
        err = (out._data.float() - want.float()).abs().max().item()
        row = {"shape": list(shape), "dtype": str(dtype).replace(
            "torch.", ""), "kernel": name, "grid": list(grid),
            "max_err": err, "atol": 0.0,
            "bitwise_equal": bool(torch.equal(out._data, want))}
        if n == 2 ** 26:
            row.update({
                "kernel_ms": time_ms(launch, inner=10),
                "plain_ms": time_ms(lambda: rtc.add_reference(
                    x._data, y._data), inner=10),
                "library_ms": time_ms(lambda: torch.add(x._data, y._data),
                                      inner=10),
                "single_call_ms": time_ms(launch),
                # bytes: x and y read once, out written once; one add a
                # element is far below the card's operations per byte
                "bound_ms": 3 * n * x._data.element_size()
                / PEAK_BYTES_S * 1e3,
                "bound_by": "bytes"})
        emit(dict({"phase": "kernel:rtc_add"}, **row))
        if not row["bitwise_equal"]:
            raise RuntimeError("rtc add disagrees with add_reference at %s "
                               "%s: max error %g" % (shape, dtype, err))
        rows.append(row)
    emit({"phase": "kernel:rtc_add", "nvrtc_s": nvrtc_s,
          "nvrtc": rtc._nvrtc.path, "nvrtc_version": rtc._nvrtc.version(),
          "arch": rtc.ARCH, "cubin_bytes": len(mod.cubin)})
    return rows


ND_N = 4096
ND_RTOL = 1e-4


def _rel_err(got, want):
    """Largest error over the largest magnitude of ``want`` (float64)."""
    got = np.asarray(got, dtype=np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(got - want).max()) / scale


def phase_ndarray():
    """The imperative path at (4096, 4096) float32 on the card: the rtc
    add, a 4096**3 dot, elementwise/broadcast/reduce/matrix ops, one
    recorded backward, save/load; numpy float64 on the host checks."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import rtc

    nd, n = mx.nd, ND_N
    rng = np.random.RandomState(0)
    a = rng.randn(n, n).astype(np.float32)
    b = rng.randn(n, n).astype(np.float32)
    bias = rng.randn(1, n).astype(np.float32)
    ctx = mx.gpu(0)
    mod = rtc.CudaModule(_add_source())      # cached by the kernel phase
    add = mod.get_kernel("add", ADD_SIG.format("float"))

    def drive():
        """One pass of the path; returns its arrays, op count and the
        host-clock seconds of the upload and of the ops (each synced)."""
        ops = 0

        def op(f, *args, **kw):
            nonlocal ops
            ops += 1
            return f(*args, **kw)

        t0 = time.perf_counter()
        x = nd.array(a, ctx=ctx)
        w = nd.array(b, ctx=ctx)
        c = nd.array(bias, ctx=ctx)
        x.attach_grad()
        w.attach_grad()
        nd.waitall()
        t1 = time.perf_counter()
        s = op(nd.zeros, (n, n), ctx=ctx)
        grid, block = _add_grid(s.size)
        op(add.launch, [x, w, s, s.size], ctx, grid, block)  # s = x + w
        with mx.autograd.record():
            h = op(nd.dot, x, w) / float(n // 64)             # 4096**3
            ops += 1
            g = op(nd.sigmoid, s)
            z = op(nd.relu, op(nd.broadcast_add, h, c)) * g
            ops += 1
            m = op(z.mean, axis=1)
            loss = op((m * m).sum)
            ops += 1
        loss.backward()
        out = dict(x=x, w=w, s=s, h=h, z=z, m=m, loss=loss,
                   zmax=op(z.max, axis=0), arg=op(nd.argmax, z, axis=1),
                   zt=op(nd.transpose, z)[::3, 1:257],
                   top=op(z.topk, axis=1, k=4, ret_typ="value"))
        ops += 1
        nd.waitall()
        return out, ops, t1 - t0, time.perf_counter() - t1

    torch.cuda.synchronize()
    # the path, twice (the first pass pays one-time costs): counts start
    # at 0 here and are read just after
    rtc.launches.clear()
    passes = []
    for _ in range(2):
        t0 = time.perf_counter()
        res, ops, upload_s, ops_s = drive()
        passes.append({"wall_s": time.perf_counter() - t0,
                       "upload_s": upload_s, "ops_s": ops_s})
    launches = dict(rtc.launches)
    x, w, s, h, z, m, loss = (res[k] for k in "x w s h z m loss".split())
    zmax, arg, zt, top = (res[k] for k in ("zmax", "arg", "zt", "top"))

    # numpy float64 on the host
    a64, b64, c64 = (v.astype(np.float64) for v in (a, b, bias))
    s64 = a64 + b64
    h64 = a64 @ b64 / (n // 64)
    g64 = 1.0 / (1.0 + np.exp(-s64))
    pre = h64 + c64
    z64 = np.maximum(pre, 0.0) * g64
    m64 = z64.mean(axis=1)
    z32 = z.asnumpy()
    dz = np.broadcast_to((2.0 * m64 / n)[:, None], z64.shape)
    # relu's branch as the card took it (z > 0 exactly where h + c > 0):
    # an element within float32 rounding of 0 may fall on the other side
    # in float64, and one such flip moves a whole gradient row by ~1e-2
    dh = dz * g64 * (z32 > 0) / (n // 64)
    checks = {
        "rtc_add": _rel_err(s.asnumpy(), s64),
        "dot": _rel_err(h.asnumpy(), h64),
        "z": _rel_err(z32, z64),
        "mean": _rel_err(m.asnumpy(), m64),
        "loss": _rel_err(loss.asnumpy(), np.asarray((m64 * m64).sum())),
        "max": _rel_err(zmax.asnumpy(), z64.max(axis=0)),
        "transpose_slice": _rel_err(zt.asnumpy(), z64.T[::3, 1:257]),
        "topk": _rel_err(top.asnumpy(), -np.sort(-z64, axis=1)[:, :4]),
        "grad_x": _rel_err(x.grad.asnumpy(), dh @ b64.T),
        "grad_w": _rel_err(w.grad.asnumpy(), a64.T @ dh),
    }
    # argmax: ties aside, the float32 result's argmax must pick a value
    # within the tolerance of the float64 row maximum
    picked = z64[np.arange(n), arg.asnumpy().astype(np.int64)]
    checks["argmax"] = _rel_err(picked, z64.max(axis=1))
    rtc_exact = bool(np.array_equal(s.asnumpy(), a + b))

    # save / load round trips, bitwise, in both formats
    build = Path(mx.__file__).resolve().parent / "_build"
    build.mkdir(parents=True, exist_ok=True)
    saved = {}
    with tempfile.TemporaryDirectory(dir=str(build)) as d:
        for fmt in ("params", "npz"):
            path = str(Path(d) / ("nd." + fmt))
            payload = {"z": z, "w": w, "arg": arg,
                       "bf16": s.astype("bfloat16")}
            if fmt == "params":
                payload.pop("bf16")      # the container has no bfloat16
            t1 = time.perf_counter()
            nd.save(path, payload)
            back = nd.load(path, ctx=ctx)
            saved[fmt] = {
                "bitwise": all(torch.equal(back[k]._data, v._data)
                               for k, v in payload.items()),
                "bytes": Path(path).stat().st_size,
                "seconds": time.perf_counter() - t1}
    row = {"phase": "ndarray", "n": n, "dtype": "float32", "ops": ops,
           "passes": passes, "rtol": ND_RTOL, "rel_err": checks,
           "rtc_add_exact": rtc_exact, "rtc_launches": launches,
           "save_load": saved}
    emit(row)
    bad = {k: v for k, v in checks.items() if not v <= ND_RTOL}
    if bad:
        raise RuntimeError("ndarray: results differ from numpy float64 "
                           "beyond %g: %r" % (ND_RTOL, bad))
    if not rtc_exact:
        raise RuntimeError("ndarray: the rtc add is not x + y exactly")
    if launches.get("add", 0) != len(passes):
        raise RuntimeError("ndarray: the rtc add ran %r times on the path"
                           % launches)
    if not all(v["bitwise"] for v in saved.values()):
        raise RuntimeError("ndarray: save/load is not bitwise: %r" % saved)
    return row


def _pct(xs, p):
    return float(np.percentile(np.asarray(xs), p)) if xs else None


def phase_serve():
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.parallel.attention import flash_attention_fwd
    from mxnet_tpu_torch.transformer import model as tm

    cfg = tm.TransformerConfig(dtype="bfloat16", param_dtype="bfloat16",
                               **GPT2_SMALL)
    torch.cuda.reset_peak_memory_stats()
    params = tm.init_params(torch.Generator().manual_seed(0), cfg)
    rt = serving.GenerationRuntime("gpt2_small", params, cfg, **SERVE)
    srv = serving.ModelServer()
    t0 = time.perf_counter()
    srv.add_generator(rt)       # warms every prefill and decode cell
    warm_s = time.perf_counter() - t0

    rng = np.random.RandomState(0)
    lens = rng.permutation(np.linspace(16, SERVE["max_prompt"],
                                       N_REQUESTS).astype(int))
    prompts = [rng.randint(1, cfg.vocab_size, size=n) for n in lens]
    # the serving path: counts start at 0 here and are read just after
    flash_attention_fwd.launches = 0
    flash_attention_fwd.launches_by_route = {"wgmma": 0, "simt": 0}
    batches0 = rt.engine.prefill_batches
    t0 = time.perf_counter()
    reqs = [srv.submit_generation("gpt2_small", p,
                                  max_new=SERVE["max_new"],
                                  deadline_ms=None) for p in prompts]
    results = [r.wait(600.0) for r in reqs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_attention_fwd.launches
    by_route = dict(flash_attention_fwd.launches_by_route)
    batches = rt.engine.prefill_batches - batches0
    kv = rt.kv.stats()
    drain = srv.drain(timeout_s=60.0)

    ok = [r for r in results if len(r["tokens"]) == SERVE["max_new"]
          and all(0 <= t < cfg.vocab_size for t in r["tokens"])]
    ttft = [r.ttft_s() * 1e3 for r in reqs if r.ttft_s() is not None]
    tpot = [d * 1e3 for r in reqs for d in r.tpot_s()]
    tokens = sum(len(r["tokens"]) for r in ok)
    row = {
        "phase": "serve", "config": dict(GPT2_SMALL, dtype="bfloat16"),
        "serve": SERVE, "requests": N_REQUESTS, "requests_ok": len(ok),
        "prompt_tokens": int(lens.sum()), "tokens_out": tokens,
        "wall_s": wall, "tokens_per_s": tokens / wall,
        "ttft_ms_p50": _pct(ttft, 50), "ttft_ms_p99": _pct(ttft, 99),
        "tpot_ms_p50": _pct(tpot, 50), "tpot_ms_p99": _pct(tpot, 99),
        "warmup_s": warm_s,
        "warmup_cells": len(rt.prefill_plan) + len(rt.decode_plan),
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "prefill_batches": batches, "flash_launches": launches,
        "flash_launches_by_route": by_route,
        "decode_ticks": rt.engine.ticks, "kv": kv, "drain": drain,
    }
    emit(row)
    if len(ok) != N_REQUESTS:
        raise RuntimeError("serve: %d of %d requests ok"
                           % (len(ok), N_REQUESTS))
    if launches == 0 or launches != cfg.n_layers * batches:
        raise RuntimeError("serve: %d flash launches for %d prefill "
                           "batches of %d layers" % (launches, batches,
                                                     cfg.n_layers))
    if by_route["wgmma"] != launches:
        raise RuntimeError("serve: the prefill's bf16 attention left the "
                           "wgmma route: %r" % by_route)
    if kv["blocks_live"] != 0 or not drain["drained"]:
        raise RuntimeError("serve: leaked KV blocks or undrained: %r %r"
                           % (kv, drain))
    return row, rt, prompts


# ---------------------------------------------------------------------
# the serving tier over HTTP, the load generator, live reload, the CLI
# ---------------------------------------------------------------------
def _flash_counts_reset():
    from mxnet_tpu_torch.parallel.attention import flash_attention_fwd

    flash_attention_fwd.launches = 0
    flash_attention_fwd.launches_by_route = {"wgmma": 0, "simt": 0}


def _flash_counts():
    from mxnet_tpu_torch.parallel.attention import flash_attention_fwd

    return (flash_attention_fwd.launches,
            dict(flash_attention_fwd.launches_by_route))


def _stream_generate(host, port, model, body, stop_after=None):
    """POST a streaming ``:generate`` on a raw socket and de-chunk the
    reply: returns ``(t_sent, [(t_arrival, line_obj), ...])``.  With
    ``stop_after`` the client reads that many token lines and then
    resets the connection (a client that went away)."""
    import socket
    import struct

    data = json.dumps(dict(body, stream=True)).encode()
    sk = socket.create_connection((host, port), timeout=600)
    buf = b""
    lines = []
    t_sent = time.perf_counter()
    sk.sendall(b"POST /v1/models/%s:generate HTTP/1.1\r\nHost: smoke\r\n"
               b"Content-Type: application/json\r\nContent-Length: %d"
               b"\r\n\r\n" % (model.encode(), len(data)) + data)

    def fill():
        chunk = sk.recv(65536)
        if not chunk:
            raise RuntimeError("stream closed early")
        return chunk

    while b"\r\n\r\n" not in buf:
        buf += fill()
    head, buf = buf.split(b"\r\n\r\n", 1)
    if not head.startswith(b"HTTP/1.0 200") and \
            not head.startswith(b"HTTP/1.1 200"):
        raise RuntimeError("stream: %r" % head[:200])
    while True:
        while b"\r\n" not in buf:
            buf += fill()
        size_line, buf = buf.split(b"\r\n", 1)
        size = int(size_line, 16)
        if size == 0:
            break
        while len(buf) < size + 2:
            buf += fill()
        obj = json.loads(buf[:size])
        buf = buf[size + 2:]
        lines.append((time.perf_counter(), obj))
        if stop_after is not None and len(lines) >= stop_after:
            sk.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                          struct.pack("ii", 1, 0))  # close sends RST
            break
    sk.close()
    return t_sent, lines


def _post_json(base, path, payload, timeout=600):
    import urllib.request

    req = urllib.request.Request(
        base + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def _get(base, path):
    import urllib.request

    with urllib.request.urlopen(base + path, timeout=60) as resp:
        return resp.status, resp.read().decode()


def _counter_values(diag, prefix="mxnet_serve_requests_total"):
    return {k: v["value"] for k, v in diag.metrics.dump_json()[
        "metrics"].items() if k.startswith(prefix)}


def http_clients(host, port, model, prompts, max_new):
    """One client thread a prompt against ``:generate``: even ones
    stream (the first resets after 4 tokens), odd ones block.  Returns
    the JSON-able ``{"results", "errors", "wall_s"}``; times are this
    process's ``perf_counter``."""
    import threading

    base = "http://%s:%d" % (host, port)
    results = [None] * len(prompts)
    errors = []

    def client(i, p):
        try:
            body = {"prompt": p, "max_new": max_new, "deadline_ms": None}
            if i % 2 == 0:   # streamed
                results[i] = ("stream",) + _stream_generate(
                    host, port, model, body,
                    stop_after=4 if i == 0 else None)
            else:
                t0 = time.perf_counter()
                st, out = _post_json(base, "/v1/models/%s:generate"
                                     % model, body)
                results[i] = ("blocking", t0, (time.perf_counter(), st, out))
        except Exception as e:  # reported to the caller
            errors.append(repr(e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i, p))
               for i, p in enumerate(prompts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    return {"results": results, "errors": errors,
            "wall_s": time.perf_counter() - t0}


def phase_serve_http(rt, prompts, serve_row):
    """The serve phase's generator and 16 prompts through
    ``ModelServer`` + ``HttpFrontend`` on 127.0.0.1: 8 streamed (one
    client resets after 4 tokens), 8 blocking, sent from a client
    process, then one ``:predict`` of 32 instances to the
    ``bench_serve`` predictor beside it."""
    from mxnet_tpu_torch import diagnostics as diag
    from mxnet_tpu_torch import serving

    pred = serving.demo_runtime("bench_serve", dim=64, hidden=128,
                                max_batch=32)
    srv = serving.ModelServer()
    srv.add_model(pred)
    srv.add_generator(rt)          # already warm
    srv.install_preemption_hook()
    fe = serving.HttpFrontend(srv, host="127.0.0.1", port=0)
    host, port = fe.start()
    base = "http://%s:%d" % (host, port)
    name = rt.name
    max_new = SERVE["max_new"]
    try:
        ready0 = _get(base, "/readyz")[0]
        healthy = _get(base, "/healthz")[0]
        # the server side of each request: the same TTFT/TPOT clock as
        # the serve phase (enqueue -> emitted token)
        gen_reqs = []
        submit = srv.submit_generation

        def recording_submit(*a, **k):
            r = submit(*a, **k)
            gen_reqs.append(r)
            return r
        srv.submit_generation = recording_submit
        counts0 = _counter_values(diag)
        batches0 = rt.engine.prefill_batches
        # the clients run in a process of their own, as callers do: in
        # this one they would wait on the interpreter lock behind the
        # engine thread, and their late sends would read as latency
        _flash_counts_reset()
        args = {"host": host, "port": port, "model": name,
                "prompts": [[int(t) for t in p] for p in prompts],
                "max_new": max_new}
        proc = subprocess.run(
            [sys.executable, "-c", "import json, sys, chip_smoke; print("
             "json.dumps(chip_smoke.http_clients(**json.loads("
             "sys.argv[1]))))", json.dumps(args)],
            cwd=str(Path(__file__).resolve().parent), capture_output=True,
            text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError("serve_http: clients failed:\n%s"
                               % proc.stderr[-4000:])
        clients = json.loads(proc.stdout.strip().splitlines()[-1])
        results, errors, wall = (clients["results"], clients["errors"],
                                 clients["wall_s"])
        torch.cuda.synchronize()
        launches, by_route = _flash_counts()
        if errors:
            raise RuntimeError("serve_http: client errors %r" % errors)
        batches = rt.engine.prefill_batches - batches0
        # the reset client's request is reaped on the next tick
        deadline = time.monotonic() + 30.0
        while (rt.kv.stats()["blocks_live"]
               or not all(r.done() for r in gen_reqs)) and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        kv = rt.kv.stats()
        x = np.random.RandomState(5).randn(32, 64).astype(np.float32)
        st, pred_out = _post_json(base, "/v1/models/bench_serve:predict",
                                  {"instances": x.tolist()})
        want_cls, want_logits = pred.execute(x)
        got_logits = np.asarray(pred_out["predictions"][1])
        pred_err = float(np.abs(got_logits - want_logits).max() /
                         np.abs(want_logits).max())
        prom = _get(base, "/metrics")[1]
        counts1 = _counter_values(diag)
    finally:
        srv.submit_generation = submit
        drain = srv.drain(timeout_s=60.0)
        srv.uninstall_preemption_hook()
        fe.stop()

    full, stream_ok, ttft_c, tpot_c = 0, True, [], []
    for i, res in enumerate(results):
        if res[0] == "stream":
            _, t_sent, lines = res
            toks = [o for _, o in lines if "token" in o]
            if i == 0:
                continue
            done = lines[-1][1]
            ok = done.get("done") is True and done["tokens"] == len(toks) \
                == max_new
            stream_ok &= ok
            full += ok
            ts = [t for t, o in lines if "token" in o]
            ttft_c.append((ts[0] - t_sent) * 1e3)
            tpot_c += [(b - a) * 1e3 for a, b in zip(ts, ts[1:])]
        else:
            _, _, (_, st_, out) = res
            full += st_ == 200 and len(out["tokens"]) == max_new
    delta = {k: counts1.get(k, 0.0) - counts0.get(k, 0.0)
             for k in counts1}

    def count(model, outcome):
        return delta.get('mxnet_serve_requests_total{model="%s",outcome='
                         '"%s",version="v1"}' % (model, outcome), 0.0)
    cancelled = [r for r in gen_reqs
                 if type(r.error).__name__ == "Cancelled"]
    ttft = [r.ttft_s() * 1e3 for r in gen_reqs if r.ttft_s() is not None]
    tpot = [d * 1e3 for r in gen_reqs for d in r.tpot_s()]
    tokens = sum(len(r.tokens) for r in gen_reqs
                 if r.error is None)
    # the server's own wall, first admission to last reply: the clients'
    # connects spread the arrivals, which the in-process phase has not
    first_in = min(r.enqueue_ts for r in gen_reqs)
    server_wall = max(r.done_ts for r in gen_reqs) - first_in
    row = {
        "phase": "serve_http", "requests": len(prompts),
        "streamed": len(prompts) // 2, "full_replies": int(full),
        "wall_s": wall, "tokens_out": tokens,
        "tokens_per_s": tokens / wall,
        "server_wall_s": server_wall,
        "server_tokens_per_s": tokens / server_wall,
        "arrival_spread_ms": (max(r.enqueue_ts for r in gen_reqs)
                              - first_in) * 1e3,
        "ttft_ms_p50": _pct(ttft, 50), "ttft_ms_p99": _pct(ttft, 99),
        "tpot_ms_p50": _pct(tpot, 50), "tpot_ms_p99": _pct(tpot, 99),
        "client_stream_ttft_ms_p50": _pct(ttft_c, 50),
        "client_stream_ttft_ms_p99": _pct(ttft_c, 99),
        "client_stream_tpot_ms_p50": _pct(tpot_c, 50),
        "client_stream_tpot_ms_p99": _pct(tpot_c, 99),
        "serve_phase": {k: serve_row[k] for k in (
            "tokens_per_s", "ttft_ms_p50", "ttft_ms_p99", "tpot_ms_p50",
            "tpot_ms_p99")},
        "cancelled": len(cancelled), "kv": kv,
        "readyz_before": ready0, "healthz": healthy,
        "predict_status": st, "predict_max_rel_err": pred_err,
        "prom_problems": diag.validate_prom_text(prom),
        "requests_total_delta": {
            "generate_ok": count(name, "ok"),
            "generate_cancelled": count(name, "cancelled"),
            "predict_ok": count("bench_serve", "ok")},
        "prefill_batches": batches, "flash_launches": launches,
        "flash_launches_by_route": by_route, "drain": drain,
    }
    emit(row)
    n = len(prompts)
    if full != n - 1 or not stream_ok:
        raise RuntimeError("serve_http: %d of %d full replies (streams "
                           "consistent: %s)" % (full, n - 1, stream_ok))
    if len(cancelled) != 1 or row["requests_total_delta"] != {
            "generate_ok": n - 1, "generate_cancelled": 1,
            "predict_ok": 1}:
        raise RuntimeError("serve_http: outcome counts %r, cancelled %d"
                           % (row["requests_total_delta"],
                              len(cancelled)))
    if kv["blocks_live"] != 0 or not drain["drained"]:
        raise RuntimeError("serve_http: KV or drain: %r %r" % (kv, drain))
    if (ready0, healthy, st) != (200, 200, 200) or row["prom_problems"]:
        raise RuntimeError("serve_http: probes/metrics: %r" % row)
    if not np.array_equal(np.asarray(pred_out["predictions"][0]),
                          want_cls) or pred_err > 2.0 ** -8:
        raise RuntimeError("serve_http: :predict != runtime.execute "
                           "(rel err %r)" % pred_err)
    if launches == 0 or launches != rt.cfg.n_layers * batches or \
            by_route["wgmma"] != launches:
        raise RuntimeError("serve_http: flash launches %d (%r) for %d "
                           "prefill batches" % (launches, by_route,
                                                batches))
    return row, pred


LOAD_SLO_TPOT_MS = 200.0     # bench.py:835 bench_generation's default
LOAD_MAX_QPS = 64.0          # the ramp's cap: 4, 8, 16, 32, 64
LOAD_WINDOW_S = 1.0          # a rate's window (1.5 s before PR 19)
AB_REPEATS = 2


def phase_loadgen(rt):
    """``gen_tokens_at_slo`` over the full-width generator (p99 TPOT SLO
    200 ms, from 4 req/s doubling to the cap, 1 s windows), then the
    continuous vs whole-batch A/B of bench.py:866-892 on its
    mixed-length work list through a ``continuous=False`` twin that
    shares the weights."""
    import random

    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.serving import reqtrace

    reqtrace.reset(capacity=512, topk=16)
    srv = serving.ModelServer(queue_max=256, default_deadline_ms=30000)
    srv.add_generator(rt)
    _flash_counts_reset()
    t0 = time.perf_counter()
    rep = serving.gen_tokens_at_slo(
        srv, rt.name, slo_p99_tpot_ms=LOAD_SLO_TPOT_MS, start_qps=4.0,
        max_qps=LOAD_MAX_QPS, window_s=LOAD_WINDOW_S)
    ramp_s = time.perf_counter() - t0
    launches, by_route = _flash_counts()
    slowest = reqtrace.top_slowest()
    shares = reqtrace.attribution_shares(slowest)
    slowest_line = reqtrace.attribution(slowest[0]) if slowest else None
    reqtrace.reset()
    drain = srv.drain(timeout_s=120.0)

    # the A/B: one work list, each engine driven to idle on this thread
    t0 = time.perf_counter()
    whole = serving.GenerationRuntime(
        rt.name + "_whole", rt._params, rt.cfg, continuous=False, **SERVE)
    whole.compile()
    twin_warm_s = time.perf_counter() - t0
    rng = random.Random(0)
    work = [([rng.randrange(1, rt.cfg.vocab_size)
              for _ in range(rng.randint(2, SERVE["max_prompt"]))],
             SERVE["max_new"] if i % SERVE["slots"] == 0
             else rng.randint(4, 8)) for i in range(16)]

    def drive_once(r):
        before = r.engine.tokens_out
        for prompt, max_new in work:
            r.engine.enqueue(serving.GenRequest(r.name, prompt, max_new))
        torch.cuda.synchronize()
        t = time.perf_counter()
        while not r.engine.idle():
            r.engine.step()
        torch.cuda.synchronize()
        return time.perf_counter() - t, r.engine.tokens_out - before

    walls = {"whole": [], "continuous": []}
    for _ in range(AB_REPEATS):
        walls["whole"].append(drive_once(whole))
        walls["continuous"].append(drive_once(rt))
    whole_s, ab_tokens = min(walls["whole"])
    cont_s, _ = min(walls["continuous"])
    row = {
        "phase": "loadgen", "slo_p99_tpot_ms": LOAD_SLO_TPOT_MS,
        "max_qps": LOAD_MAX_QPS,
        "tokens_per_s_at_slo": rep["tokens_per_s_at_slo"],
        "tpot_p99_ms_at_slo": rep["tpot_p99_ms_at_slo"],
        "ttft_p50_ms_at_slo": rep["ttft_p50_ms_at_slo"],
        "ttft_p99_ms_at_slo": rep["ttft_p99_ms_at_slo"],
        "ramp": rep["ramp"], "ramp_s": ramp_s,
        "p99_attribution": shares, "slowest": slowest_line,
        "flash_launches": launches, "flash_launches_by_route": by_route,
        "continuous_vs_whole_batch": {
            "work": len(work), "tokens": ab_tokens,
            "whole_s": whole_s, "continuous_s": cont_s,
            "whole_tokens_per_s": ab_tokens / whole_s,
            "continuous_tokens_per_s": ab_tokens / cont_s,
            "speedup": whole_s / cont_s, "repeats": AB_REPEATS,
            "twin_warmup_s": twin_warm_s},
        "kv": rt.kv.stats(), "drain": drain,
    }
    emit(row)
    if not rep["ramp"] or not rep["ramp"][0]["met_slo"]:
        raise RuntimeError("loadgen: the first ramp step missed the SLO")
    if rt.kv.stats()["blocks_live"] or whole.kv.stats()["blocks_live"] \
            or not drain["drained"]:
        raise RuntimeError("loadgen: leaked KV blocks or undrained")
    if by_route["wgmma"] != launches or launches == 0:
        raise RuntimeError("loadgen: flash left the wgmma route: %r"
                           % by_route)
    return row


def phase_reload(pred):
    """Live reload of the ``bench_serve`` predictor under
    ``BackgroundLoad``: step 2 from a checkpoint promotes with zero
    dropped or failed requests; step 3 under chaos ``bad_version`` for
    version 3 rolls back while version 2 keeps serving."""
    import os
    import shutil

    from mxnet_tpu_torch import chaos, checkpoint, serving

    ckdir = tempfile.mkdtemp(prefix="smoke-reload-")
    srv = serving.ModelServer(max_batch=32, queue_max=256,
                              batch_deadline_ms=2,
                              default_deadline_ms=10_000, canary_pct=50,
                              canary_min_n=8)
    srv.add_model(pred)
    x = np.random.RandomState(6).randn(1, 64).astype(np.float32)
    want = serving.demo_runtime("v2", dim=64, hidden=128, max_batch=32,
                                seed=2).execute(x)[1]
    try:
        out = {}
        for version, seed, chaos_spec in (
                (2, 2, None),
                (3, 3, "bad_version:model=bench_serve,version=3,"
                 "count=100000")):
            d = os.path.join(ckdir, "v%d" % version)
            checkpoint.save_checkpoint(d, version,
                                       params=serving.demo_params(
                                           dim=64, hidden=128, seed=seed))
            if chaos_spec:
                os.environ["MXNET_CHAOS"] = chaos_spec
            chaos.reset()
            try:
                load = serving.BackgroundLoad(srv, "bench_serve", qps=300,
                                              duration_s=3.0).start()
                time.sleep(0.3)
                srv.reload("bench_serve", d)
                st = srv.wait_reload("bench_serve", timeout_s=60.0)
                res = load.join(120.0)
                injected = chaos.injected_total("bad_version")
            finally:
                os.environ.pop("MXNET_CHAOS", None)
                chaos.reset()
            serving_v = srv.stats()["bench_serve"]["version"]
            same_as_v2 = bool(np.array_equal(
                srv.predict("bench_serve", x)[1], want))
            out["v%d" % version] = {
                "state": st["state"], "swap_s": st.get("swap_s"),
                "canary_stats": st.get("canary_stats"),
                "stable_stats": st.get("stable_stats"),
                "serving_version": serving_v, "serves_v2": same_as_v2,
                "bad_version_injected": injected,
                "load": {k: res[k] for k in (
                    "offered", "admitted", "ok", "errors", "expired",
                    "hung", "shed_total", "p50_ms", "p99_ms")}}
    finally:
        drain = srv.drain(timeout_s=30.0)
        shutil.rmtree(ckdir, ignore_errors=True)
    row = dict({"phase": "reload", "drain": drain}, **out)
    emit(row)
    v2, v3 = out["v2"], out["v3"]
    for tag, v in out.items():
        ld = v["load"]
        if ld["ok"] != ld["admitted"] or ld["errors"] or ld["hung"] or \
                ld["expired"]:
            raise RuntimeError("reload %s: requests dropped or failed: %r"
                               % (tag, ld))
    if v2["state"] != "promoted" or v2["serving_version"] != 2 or \
            not v2["serves_v2"]:
        raise RuntimeError("reload: step 2 did not promote: %r" % v2)
    if v3["state"] != "rolled_back" or v3["serving_version"] != 2 or \
            not v3["serves_v2"] or not v3["bad_version_injected"]:
        raise RuntimeError("reload: version 3 did not roll back: %r" % v3)
    return row


def phase_serve_cli():
    """``python -m mxnet_tpu_torch.serving --self-test`` on the card,
    then ``--serve --port 0``: one ``:generate`` over HTTP, SIGTERM,
    exit code 83."""
    import os
    import signal

    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent))
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.serving"]
    # the self-test and the server run side by side (each its own
    # process on the card)
    t0 = time.perf_counter()
    selftest = subprocess.Popen(cmd + ["--self-test"], stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, env=env)
    proc = subprocess.Popen(cmd + ["--serve", "--port", "0"],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    try:
        banner = json.loads(proc.stdout.readline())
        st, out = _post_json("http://127.0.0.1:%d" % banner["port"],
                             "/v1/models/demo_gen:generate",
                             {"prompt": [5, 9, 2], "max_new": 6}, 120)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        st_out, st_err = selftest.communicate(timeout=300)
        self_test_s = time.perf_counter() - t0
    finally:
        for p in (proc, selftest):
            if p.poll() is None:
                p.kill()
                p.wait()
    err = proc.stderr.read()
    res = subprocess.CompletedProcess(selftest.args, selftest.returncode,
                                      st_out, st_err)
    try:
        payload = json.loads(res.stdout.strip().splitlines()[-1])
    except (ValueError, IndexError):
        payload = {}
    failed = sorted(k for k, v in payload.get("checks", {}).items()
                    if not v)
    row = {"phase": "serve_cli", "self_test_rc": res.returncode,
           "self_test_ok": payload.get("self_test_ok"),
           "self_test_checks": len(payload.get("checks", {})),
           "self_test_failed": failed, "self_test_s": self_test_s,
           "serve_device": banner.get("device"), "generate_status": st,
           "generate_tokens": len(out.get("tokens", [])),
           "sigterm_rc": rc}
    emit(row)
    if res.returncode != 0 or payload.get("self_test_ok") is not True:
        raise RuntimeError("serve_cli: self-test failed: %r\n%s"
                           % (failed, res.stderr[-4000:]))
    if st != 200 or row["generate_tokens"] != 6 or rc != 83 or \
            not str(banner.get("device")).startswith("cuda"):
        raise RuntimeError("serve_cli: --serve: %r\n%s"
                           % (row, err[-4000:]))
    return row


def phase_numerics():
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.parallel.attention import flash_attention_fwd
    from mxnet_tpu_torch.transformer import model as tm

    cfg = tm.TransformerConfig(dtype="float32", param_dtype="float32",
                               **dict(GPT2_SMALL, n_layers=2))
    params = tm.init_params(torch.Generator().manual_seed(0), cfg)
    rt = serving.GenerationRuntime("gpt2_small_f32", params, cfg,
                                   **SERVE)
    dev = rt.device
    rng = np.random.RandomState(1)
    mp = SERVE["max_prompt"]
    prompts = [rng.randint(1, cfg.vocab_size, size=n)
               for n in (min(37, mp), mp * 2 // 5, mp)]

    def dense_logits(toks):
        t = torch.as_tensor(np.asarray(toks)[None], device=dev)
        with torch.no_grad():
            return tm.apply(params, t, cfg,
                            attn_fn=tm.dense_causal_attn)[0, -1]

    # prefill through the kernel, in the plan cell the engine would pick
    bt, tb = rt.block_tokens, SERVE["max_prompt"]
    bb = 4
    tokens = np.zeros((bb, tb), dtype=np.int64)
    plens = np.ones((bb,), dtype=np.int64)
    tables = np.zeros((bb, tb // bt), dtype=np.int64)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = p
        plens[i] = len(p)
        rt.kv.alloc("n%d" % i, len(p))
        tables[i] = rt.kv.block_table("n%d" % i, tb // bt)
    n0 = flash_attention_fwd.launches_by_route["simt"]
    got = rt.prefill(tokens, plens, tables)[:len(prompts)]
    if flash_attention_fwd.launches_by_route["simt"] - n0 != cfg.n_layers:
        raise RuntimeError("numerics: the float32 prefill did not run the "
                           "simt kernel")
    want = torch.stack([dense_logits(p) for p in prompts])
    for i in range(len(prompts)):
        rt.kv.free("n%d" % i)
    if not torch.isfinite(got).all() or got.shape != want.shape:
        raise RuntimeError("numerics: bad prefill logits %s"
                           % (tuple(got.shape),))
    err = (got - want).abs().max().item()

    # greedy through the engine against dense greedy decoding
    n_new = 16
    srv = serving.ModelServer()
    srv.add_generator(rt)
    reqs = [srv.submit_generation(rt.name, p, max_new=n_new,
                                  deadline_ms=None) for p in prompts]
    outs = [r.wait(600.0)["tokens"] for r in reqs]
    drain = srv.drain(timeout_s=60.0)
    match = first_ok = 0
    for p, out in zip(prompts, outs):
        hist = [int(t) for t in p]
        ref = []
        for _ in range(n_new):
            nxt = int(dense_logits(hist).argmax())
            ref.append(nxt)
            hist.append(nxt)
        match += sum(int(a == b) for a, b in zip(out, ref))
        first_ok += int(out[0] == ref[0])
    row = {"phase": "numerics", "config": dict(GPT2_SMALL, n_layers=2,
                                               dtype="float32"),
           "prompt_lens": [len(p) for p in prompts],
           "prefill_logits_max_err": err, "atol": 1e-3,
           "greedy_tokens_matching": match,
           "greedy_tokens": n_new * len(prompts),
           "first_tokens_matching": first_ok,
           "kv_blocks_live": rt.kv.stats()["blocks_live"],
           "drained": drain["drained"]}
    emit(row)
    if not err <= 1e-3:
        raise RuntimeError("numerics: prefill logits differ from the "
                           "dense reference by %g" % err)
    if row["kv_blocks_live"] != 0 or not drain["drained"]:
        raise RuntimeError("numerics: leaked KV blocks or undrained")
    return row


def resnet50(ctx, seed=0):
    """ResNet-50 v1 as ``bench_model`` builds it (``get_model``, Xavier
    from numpy's generator seeded with ``seed``) on ``ctx``, its deferred
    shapes settled by one inference forward at batch 2."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import vision

    np.random.seed(seed)
    net = vision.get_model("resnet50_v1", classes=1000, prefix="resnet50_")
    net.initialize(mx.init.Xavier(), ctx=ctx)
    with mx.autograd.pause():
        net(mx.nd.zeros((2, 3, 224, 224), ctx=ctx))
    return net


def sym_resnet50(num_classes=1000):
    """Symbolic ResNet-50 v1 (bottleneck 3-4-6-3) on the port's
    ``mx.sym``: a copy of ``bench.py:1219`` ``_sym_resnet50``, which
    builds on the JAX package (its ``tojson`` is byte-equal to this one's,
    tests/test_torch_chip_smoke.py)."""
    import mxnet_tpu_torch as mx

    def conv_bn(x, f, k, s, p, name, relu=True):
        x = mx.sym.Convolution(x, num_filter=f, kernel=(k, k), stride=(s, s),
                               pad=(p, p), no_bias=True, name=name + "_conv")
        x = mx.sym.BatchNorm(x, fix_gamma=False, name=name + "_bn")
        return mx.sym.Activation(x, act_type="relu") if relu else x

    def bottleneck(x, f, stride, match, name):
        sc = x if match else conv_bn(x, 4 * f, 1, stride, 0,
                                     name + "_sc", relu=False)
        y = conv_bn(x, f, 1, 1, 0, name + "_a")
        y = conv_bn(y, f, 3, stride, 1, name + "_b")
        y = conv_bn(y, 4 * f, 1, 1, 0, name + "_c", relu=False)
        return mx.sym.Activation(y + sc, act_type="relu")

    x = mx.sym.Variable("data")
    x = conv_bn(x, 64, 7, 2, 3, "stem")
    x = mx.sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                       pool_type="max")
    for stage, (f, blocks) in enumerate([(64, 3), (128, 4), (256, 6),
                                         (512, 3)]):
        for b in range(blocks):
            stride = 2 if (stage > 0 and b == 0) else 1
            x = bottleneck(x, f, stride, b > 0, "s%d_b%d" % (stage, b))
    x = mx.sym.Pooling(x, global_pool=True, pool_type="avg", kernel=(7, 7))
    x = mx.sym.FullyConnected(mx.sym.Flatten(x), num_hidden=num_classes,
                              name="fc")
    return mx.sym.SoftmaxOutput(x, name="softmax")


def train_batch(batch, ctx, seed=0):
    """A batch as ``bench_model`` draws it: ``nd.random.uniform`` images
    and ``np.random.randint(0, 1000)`` labels."""
    import mxnet_tpu_torch as mx

    mx.random.seed(seed)
    data = mx.nd.random.uniform(shape=(batch, 3, 224, 224), ctx=ctx)
    label = mx.nd.array(np.random.RandomState(seed).randint(
        0, 1000, batch).astype("float32"), ctx=ctx)
    return data, label


def train_tflops(batch, step_s):
    """Achieved TFLOP/s of a ResNet-50 train step: 3 forwards of 2 x 4.09
    G multiply-adds an image over the step time."""
    return TRAIN_FLOP_FACTOR * RESNET50_GFLOP * 1e9 * batch / step_s / 1e12


def _kernel_counts():
    from mxnet_tpu_torch import rtc
    from mxnet_tpu_torch.ops import contrib
    from mxnet_tpu_torch.parallel.attention import (flash_attention_bwd,
                                                    flash_attention_fwd)

    return {"flash_attention_fwd": flash_attention_fwd.launches,
            "flash_attention_fwd_by_route":
                dict(flash_attention_fwd.launches_by_route),
            "flash_attention_bwd": flash_attention_bwd.launches,
            "flash_attention_bwd_by_route":
                dict(flash_attention_bwd.launches_by_route),
            "rtc_add": sum(rtc.launches.values()),
            "box_nms": contrib.nms_keep.launches}


def _reset_kernel_counts():
    from mxnet_tpu_torch import rtc
    from mxnet_tpu_torch.ops import contrib
    from mxnet_tpu_torch.parallel.attention import (flash_attention_bwd,
                                                    flash_attention_fwd)

    contrib.nms_keep.launches = 0
    flash_attention_fwd.launches = 0
    flash_attention_fwd.launches_by_route = {"wgmma": 0, "simt": 0}
    flash_attention_bwd.launches = 0
    flash_attention_bwd.launches_by_route = {"wgmma": 0, "simt": 0}
    rtc.launches.clear()


def phase_train():
    """ResNet-50 v1 bf16 training at batch 32 and 128 through
    ``FusedTrainStep``, and one float32 step at batch 128 from the same
    weights and batch."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import convert, gluon
    from mxnet_tpu_torch.parallel.dp import FusedTrainStep

    ctx = mx.gpu(0)
    t0 = time.perf_counter()
    net = resnet50(ctx)
    w0 = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    build_s = time.perf_counter() - t0
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    big = train_batch(max(RESNET_BATCHES), ctx)
    f32 = FusedTrainStep(net, loss_fn, learning_rate=TRAIN_LR,
                         momentum=TRAIN_MOMENTUM)
    f32_loss = float(f32.run_steps(*big, steps=1).asnumpy()[0])
    del f32
    rows = []
    for batch in RESNET_BATCHES:
        data, label = big if batch == max(RESNET_BATCHES) else             train_batch(batch, ctx)
        net.cast("float32")
        convert.load_block_params(net, w0)
        step = FusedTrainStep(net, loss_fn, learning_rate=TRAIN_LR,
                              momentum=TRAIN_MOMENTUM, dtype="bfloat16")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # the path: counts start at 0 here and are read just after
        _reset_kernel_counts()
        t0 = time.perf_counter()
        warm = step.run_steps(data, label, steps=TRAIN_WARMUP).asnumpy()
        warm_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = step.run_steps(data, label, steps=TRAIN_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        losses = losses.asnumpy()
        step_s = wall / TRAIN_STEPS
        rows.append({
            "batch": batch, "dtype": "bfloat16",
            "images_per_s": batch / step_s, "step_ms": step_s * 1e3,
            "warmup_s": warm_s, "first_loss": float(warm[0]),
            "last_loss": float(losses[-1]),
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "tflops": train_tflops(batch, step_s),
            "tflops_frac_of_bf16_peak":
                train_tflops(batch, step_s) * 1e12 / PEAK_BF16_FLOPS,
            "kernel_launches": _kernel_counts()})
        del step
    row = {"phase": "train", "model": "resnet50_v1", "classes": 1000,
           "image": 224, "init": "Xavier, numpy seed 0",
           "optimizer": {"lr": TRAIN_LR, "momentum": TRAIN_MOMENTUM},
           "build_s": build_s, "runs": rows,
           "tflops_basis": "3 x 2 x 4.09 G multiply-adds an image "
                           "(He et al. 2015) against the 989 TFLOP/s "
                           "bf16 peak",
           "float32_first_loss": f32_loss,
           "bf16_first_loss_rel_err":
               abs(rows[-1]["first_loss"] - f32_loss) / abs(f32_loss),
           "bf16_loss_rtol": BF16_LOSS_RTOL}
    emit(row)
    bad = [r for r in rows if not (np.isfinite(r["first_loss"])
                                   and np.isfinite(r["last_loss"]))]
    if bad or not np.isfinite(f32_loss):
        raise RuntimeError("train: a loss is not finite: %r" % (bad,))
    if not row["bf16_first_loss_rel_err"] <= BF16_LOSS_RTOL:
        raise RuntimeError("train: bf16 first loss %g against float32 %g"
                           % (rows[-1]["first_loss"], f32_loss))
    return row


# ---------------------------------------------------------------------------
# input: records -> decode pool -> pinned device stage -> ResNet-50 training
# ---------------------------------------------------------------------------
# bench.py:531-538 writes 256x256x3 seeded uint8 images as JPEG quality
# 90; at least INPUT_RECORDS of them, rounded up to whole batches for
# every decode worker (input_records), so that no step trains on padding
INPUT_RECORDS = 1024
INPUT_JPEG_SIDE, INPUT_JPEG_QUALITY = 256, 90
INPUT_SIDE, INPUT_BATCH = 224, 128
INPUT_EPOCHS = 2            # the first is discarded
INPUT_CHECK_BATCHES = 4     # card batches held bitwise to host batches
INPUT_RESUME_AT = 3         # the resumed stream skips this many batches
INPUT_H2D_REPS = 10
INPUT_PROFILE_STEPS = 6     # traced steps for the idle share


def input_codec():
    """(codec, what decided it): ``jpeg`` where the native library
    decodes JPEG and PIL can write it, else ``raw``: HWC uint8 payloads
    at the input size, the native pipeline's passthrough (no decode)."""
    from mxnet_tpu_torch import _native

    try:
        import PIL
        pil = PIL.__version__
    except ImportError:
        pil = None
    jpeg = _native.has_jpeg()
    return ("jpeg" if jpeg and pil else "raw",
            {"native_jpeg": jpeg, "pil": pil})


def input_workers() -> int:
    """W = min(8, cores - 1), at least 1."""
    return max(1, min(8, (os.cpu_count() or 1) - 1))


def input_records(workers: int) -> int:
    """INPUT_RECORDS rounded up to a whole number of batches a worker."""
    per = workers * INPUT_BATCH
    return per * -(-INPUT_RECORDS // per)


def write_input_records(d, codec, n):
    """``n`` seeded records (numpy seed 0, labels i % 1000) with their
    ``.idx``: JPEGs as bench.py writes them, or raw HWC uint8 payloads at
    the input size.  Returns (rec, idx, bytes written)."""
    from mxnet_tpu_torch import recordio

    rec, idx = os.path.join(d, "input.rec"), os.path.join(d, "input.idx")
    rng = np.random.RandomState(0)
    w = recordio.MXIndexedRecordIO(idx, rec, "w")
    for i in range(n):
        head = recordio.IRHeader(0, float(i % 1000), i, 0)
        if codec == "jpeg":
            img = rng.randint(0, 255, (INPUT_JPEG_SIDE, INPUT_JPEG_SIDE, 3),
                              dtype=np.uint8)
            w.write_idx(i, recordio.pack_img(head, img,
                                             quality=INPUT_JPEG_QUALITY))
        else:
            img = rng.randint(0, 255, (INPUT_SIDE, INPUT_SIDE, 3),
                              dtype=np.uint8)
            w.write_idx(i, recordio.pack(head, img.tobytes()))
    w.close()
    return rec, idx, os.path.getsize(rec)


def input_iter_kwargs(rec, idx):
    return dict(path_imgrec=rec, path_imgidx=idx,
                data_shape=(3, INPUT_SIDE, INPUT_SIDE),
                batch_size=INPUT_BATCH, shuffle=True, rand_crop=True,
                rand_mirror=True, preprocess_threads=1, dtype="uint8",
                seed=0)


def batch_digest(data, label) -> str:
    import hashlib

    h = hashlib.sha256()
    for t in (data, label):
        t = t._data if hasattr(t, "_data") else t
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def _epoch_digests(pipe, limit=None):
    out = []
    while limit is None or len(out) < limit:
        try:
            b = pipe.next()
        except StopIteration:
            break
        out.append(batch_digest(b.data[0], b.label[0]))
    return out


def host_census():
    """What else runs on the host as the phase starts: the live threads
    of this process (but the main one) by name, the child processes,
    and the load average."""
    import threading

    me = os.getpid()
    children = 0
    for pid in os.listdir("/proc"):
        try:
            with open("/proc/%s/stat" % pid) as f:
                children += int(f.read().rsplit(")", 1)[1].split()[1]) == me
        except (OSError, ValueError, IndexError):
            continue
    names = sorted(t.name for t in threading.enumerate()
                   if t is not threading.main_thread())
    return {"threads": names, "child_processes": children,
            "loadavg_1m": os.getloadavg()[0]}


def _h2d_gbps(src, dev, non_blocking):
    """GB/s of copying ``src`` to ``dev`` at batch granularity: the
    median of ``INPUT_H2D_REPS`` copies between CUDA events."""
    times = []
    for i in range(INPUT_H2D_REPS + 2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        src.to(dev, non_blocking=non_blocking)
        end.record()
        end.synchronize()
        if i >= 2:
            times.append(start.elapsed_time(end) / 1e3)
    return src.numel() * src.element_size() / statistics.median(times) / 1e9


def input_h2d(pool, dev):
    """Host-to-device GB/s of one uint8 batch from pageable memory, from
    pinned memory (the caching host allocator's) and from a registered
    pool slot, and the ms that ``pin_memory()`` (the ``stage`` mode's
    host copy) takes for it."""
    from mxnet_tpu_torch import io_pipeline as iop

    x = torch.from_numpy(np.random.RandomState(1).randint(
        0, 255, (INPUT_BATCH, 3, INPUT_SIDE, INPUT_SIDE), dtype=np.uint8))
    t0 = time.perf_counter()
    for _ in range(INPUT_H2D_REPS):
        pinned = x.pin_memory()
    pin_ms = (time.perf_counter() - t0) / INPUT_H2D_REPS * 1e3
    reg = iop._Registered(pool)
    try:
        w, s, m = pool.slot_maps()[0]
        view = pool._spec.views(m)[0][0]
        view[...] = x.numpy()
        slot = torch.from_numpy(view)
        row = {"bytes": x.numel(),
               "pageable_GBps": _h2d_gbps(x, dev, False),
               "pinned_GBps": _h2d_gbps(pinned, dev, True),
               "registered_slot_GBps": _h2d_gbps(slot, dev, True),
               "registered_slot_is_pinned": bool(slot.is_pinned()),
               "pin_memory_copy_ms": pin_ms}
        del slot, view
    finally:
        reg.release()
    return row


def _input_profile(step, pipe, steps, untraced_ms):
    """``steps`` train steps fed by ``pipe`` under torch.profiler: device
    busy ms a step (kernels; the copies apart), the idle share against
    the untraced step time, and the copy engine's ms a batch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            b = pipe.next()
            loss = step(b.data[0], b.label[0])[0]
        float(loss.asnumpy())
        wall = time.perf_counter() - t0
    events = [(ev.name, ev.device_time_total) for ev in prof.events()
              if ev.device_type == DeviceType.CUDA
              and not getattr(ev, "is_user_annotation", False)]
    busy = sum(us for n, us in events if not n.startswith("Memcpy"))
    h2d = sum(us for n, us in events if n.startswith("Memcpy HtoD"))
    busy_ms = busy / 1e3 / steps
    return {"steps": steps, "traced_wall_ms_per_step": wall * 1e3 / steps,
            "device_busy_ms_per_step": busy_ms,
            "idle_share": 1.0 - busy_ms / untraced_ms,
            "idle_share_traced": 1.0 - busy_ms / (wall * 1e3 / steps),
            "h2d_device_ms_per_batch": h2d / 1e3 / steps}


def _input_e2e(net, w0, fn, workers, profile_steps=0):
    """ResNet-50 v1 bf16 at batch 128 through ``FusedTrainStep`` fed by
    ``InputPipeline`` on the card: INPUT_EPOCHS epochs, the first
    discarded; images/s and the step's ms over the rest, the kernel
    counts of the path, and with ``profile_steps`` the idle share of
    that many more steps under the profiler."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import convert, gluon
    from mxnet_tpu_torch import io_pipeline as iop
    from mxnet_tpu_torch.parallel.dp import FusedTrainStep

    net.cast("float32")
    convert.load_block_params(net, w0)
    step = FusedTrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                          learning_rate=TRAIN_LR, momentum=TRAIN_MOMENTUM,
                          dtype="bfloat16")
    t_up = time.perf_counter()
    pipe = iop.InputPipeline(fn, num_workers=workers, device=mx.gpu(0))
    try:
        losses, times, images = [], [], []
        # the path: counts start at 0 here and are read just after
        _reset_kernel_counts()
        for epoch in range(INPUT_EPOCHS):
            pipe.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n = 0
            for b in pipe:
                loss = step(b.data[0], b.label[0])[0]
                n += b.data[0].shape[0] - b.pad
            losses.append(float(loss.asnumpy()))
            times.append(time.perf_counter() - t0)
            images.append(n)
            if epoch == 0:
                first_s = time.perf_counter() - t_up
        counts = _kernel_counts()
        steps = sum(images[1:]) // INPUT_BATCH
        wall = sum(times[1:])
        prof = None
        if profile_steps:
            pipe.reset()
            prof = _input_profile(step, pipe, profile_steps,
                                  wall * 1e3 / steps)
        return {"pin": pipe.pin_mode, "workers": workers,
                "e2e_ips": sum(images[1:]) / wall,
                "step_ms": wall * 1e3 / steps, "epochs": INPUT_EPOCHS,
                "epoch_s": times, "first_epoch_with_startup_s": first_s,
                "losses": losses, "kernel_launches": counts,
                "profile": prof}
    finally:
        pipe.close()
        del step


def phase_input(train_row):
    """The input tier on the card: records written from a seed, the
    native decode pipeline on one thread, the decode pool at W workers,
    the host-to-device link, and ResNet-50 bf16 training fed by
    ``InputPipeline``; the card's batches, a repeated stream and a
    resumed stream held bitwise."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import io as mio
    from mxnet_tpu_torch import io_pipeline as iop

    dev = torch.device("cuda", 0)
    cores = os.cpu_count() or 1
    workers = input_workers()
    codec, codec_why = input_codec()
    census = host_census()
    stage_s, t_lap = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        stage_s[name], t_lap[0] = now - t_lap[0], now

    tmp = tempfile.mkdtemp(prefix="chip_smoke_input_")
    try:
        t0 = time.perf_counter()
        n_rec = input_records(workers)
        rec, idx, rec_bytes = write_input_records(tmp, codec, n_rec)
        write_s = time.perf_counter() - t0
        kw = input_iter_kwargs(rec, idx)
        fn = iop.make_record_iter_fn(**kw)

        # stage 1: the native pipeline alone, one thread
        it = mio.ImageRecordIter(**kw)
        seen = 0
        t0 = time.perf_counter()
        for b in it:
            seen += b.data[0].shape[0] - b.pad
        decode_ips = seen / (time.perf_counter() - t0)
        del it
        lap("write_and_decode")

        # stage 2: the pool at W workers, host side (epochs 2 and 3)
        pool = iop.ShardedDecodePool(fn, num_workers=workers)
        try:
            t_up = time.perf_counter()
            seen = 0
            for epoch in range(3):
                pool.reset()
                if epoch == 1:
                    t0, seen = time.perf_counter(), 0
                while True:
                    try:
                        hb = pool.next_host()
                    except StopIteration:
                        break
                    seen += INPUT_BATCH - hb.pad
                    pool.recycle(hb)
                if epoch == 0:
                    pool_first_s = time.perf_counter() - t_up
            pool_ips = seen / (time.perf_counter() - t0)
            slot_bytes = pool.slot_nbytes
            slots = pool.slots_per_worker
            start_method = pool.start_method
            # stage 3: the link at batch granularity
            h2d = input_h2d(pool, dev)
        finally:
            pool.close()
        shm = shutil.disk_usage(iop._shm_dir())
        lap("pool_and_h2d")

        # the data, bitwise: the card's first batches against the host
        # stream; two runs of the pool; a stream resumed mid-epoch
        with iop.InputPipeline(fn, num_workers=workers,
                               device=False) as host:
            run_a = _epoch_digests(host)
        with iop.InputPipeline(fn, num_workers=workers,
                               device=mx.gpu(0)) as card:
            card_first = _epoch_digests(card, INPUT_CHECK_BATCHES)
        # resumed as a fresh process would: the same epoch (the native
        # iterator reshuffles and redraws its crops every epoch)
        with iop.InputPipeline(fn, num_workers=workers,
                               device=mx.gpu(0)) as card:
            card.skip_batches(INPUT_RESUME_AT)
            resumed = _epoch_digests(card)
            card_cursor = card.cursor
        with iop.InputPipeline(fn, num_workers=workers,
                               device=False) as host:
            run_b = _epoch_digests(host)
        checks = {
            "card_batches_equal_host": card_first ==
            run_a[:INPUT_CHECK_BATCHES],
            "pool_stream_repeats": run_a == run_b,
            "resumed_stream_equal": resumed == run_a[INPUT_RESUME_AT:],
            "resumed_cursor": card_cursor == len(run_a) * INPUT_BATCH}
        lap("checks")

        # stage 4: end to end
        net = resnet50(mx.gpu(0))
        w0 = {k: p.data().asnumpy()
              for k, p in net.collect_params().items()}
        lap("build_net")
        main_run = _input_e2e(net, w0, fn, workers, INPUT_PROFILE_STEPS)
        lap("e2e")
        del net
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    synthetic = next(r["images_per_s"] for r in train_row["runs"]
                     if r["batch"] == INPUT_BATCH)
    row = {"phase": "input", "codec": codec, **codec_why, "cores": cores,
           "workers": workers, "start_method": start_method,
           "records": n_rec, "record_bytes": rec_bytes,
           "image": (INPUT_JPEG_SIDE if codec == "jpeg" else INPUT_SIDE),
           "jpeg_quality": INPUT_JPEG_QUALITY if codec == "jpeg" else None,
           "write_s": write_s, "batch": INPUT_BATCH,
           "slot_bytes": slot_bytes, "slots_per_worker": slots,
           "pool_mapped_bytes": slot_bytes * slots * workers,
           "dev_shm_bytes": shm.total, "dev_shm_free_bytes": shm.free,
           "decode_ips_1thread": decode_ips, "pool_ips": pool_ips,
           "pool_first_epoch_with_startup_s": pool_first_s,
           "h2d": h2d, "h2d_GBps": {"pageable": h2d["pageable_GBps"],
                                    "pinned": h2d["pinned_GBps"]},
           "e2e_ips": main_run["e2e_ips"],
           "train_synthetic_ips": synthetic,
           "feed_efficiency": main_run["e2e_ips"] / synthetic,
           "idle_share": main_run["profile"]["idle_share"],
           "pin_mode": main_run["pin"], "e2e": main_run,
           "checks": checks, "stage_s": stage_s, "host": census,
           "kernel_launches": main_run["kernel_launches"]}
    emit(row)
    if not all(checks.values()):
        raise RuntimeError("input: a stream check failed: %r" % checks)
    if not h2d["registered_slot_is_pinned"]:
        raise RuntimeError("input: the registered slot is not page-locked")
    if not np.isfinite(main_run["losses"]).all():
        raise RuntimeError("input: a loss is not finite: %r" % main_run)
    return row


def _update_err(got, want, w0):
    """Error of a parameter trajectory over the size of the update:
    ||got - want|| / ||want - w0||, over every parameter at once."""
    num = sum(float(np.sum((np.asarray(got[k], np.float64) - w) ** 2))
              for k, w in want.items())
    den = sum(float(np.sum((w - np.asarray(w0[k], np.float64)) ** 2))
              for k, w in want.items())
    return (num / den) ** 0.5


def numerics_run(net, w0, data, label, dtype, momentum=TRAIN_MOMENTUM,
                 accum=None):
    """Load ``w0`` into ``net`` and take one ``FusedTrainStep`` step (in
    ``accum`` microbatches) for each batch of ``data`` / ``label`` (a
    leading step dim) in ``dtype`` on the net's device.  Returns the
    losses and the parameters after each step."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import convert, gluon
    from mxnet_tpu_torch.parallel.dp import FusedTrainStep

    ctx = next(iter(net.collect_params().values())).list_ctx()[0]
    net.cast("float32")
    convert.load_block_params(net, w0)
    step = FusedTrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                          learning_rate=TRAIN_LR, momentum=momentum,
                          dtype=dtype, accum_steps=accum)
    losses, params = [], []
    for k in range(len(data)):
        losses.append(float(step.run_steps(
            mx.nd.array(data[k:k + 1].astype(dtype or "float32"), ctx=ctx),
            mx.nd.array(label[k:k + 1], ctx=ctx)).asnumpy()[0]))
        params.append({n: p.data().asnumpy()
                       for n, p in net.collect_params().items()})
    return np.array(losses), params


def trajectory_errors(got, got_p, ref, ref_p, w0):
    """Per-step relative loss errors and update errors of one trajectory
    against another from the same start ``w0``."""
    return (np.abs(got - ref) / np.abs(ref),
            np.array([_update_err(g, r, w0) for g, r in zip(got_p, ref_p)]))


def check_trajectory(got, got_p, ref, ref_p, w0):
    """Raise unless the trajectory ``got`` follows ``ref`` to
    ``TRAJ_LOSS_RTOL`` / ``TRAJ_UPDATE_TOL``; returns the errors."""
    loss_err, upd_err = trajectory_errors(got, got_p, ref, ref_p, w0)
    if not (np.isfinite(got).all() and (loss_err <= TRAJ_LOSS_RTOL).all()):
        raise RuntimeError("train_numerics: float64 losses %r differ by %r "
                           "(limit %g)" % (got.tolist(), loss_err.tolist(),
                                           TRAJ_LOSS_RTOL))
    if not (upd_err <= TRAJ_UPDATE_TOL).all():
        raise RuntimeError("train_numerics: the float64 parameters' update "
                           "differs by %r of its size (limit %g)"
                           % (upd_err.tolist(), TRAJ_UPDATE_TOL))
    return loss_err, upd_err


def fault_update_errs(ref_p, w0, aux):
    """What the update check reads at step 2 for two faults of the
    trajectory ``ref_p`` (SGD-momentum, no weight decay): step 2 not
    applied (the parameters stay at step 1's), and step 2 without
    momentum (its update lacks momentum x step 1's update; the aux
    states ``aux`` do not depend on it)."""
    p1, p2 = ref_p
    no_mom = {k: v if k in aux else v - TRAIN_MOMENTUM * (p1[k] - w0[k])
              for k, v in p2.items()}
    return {"step2_skipped": _update_err(p1, p2, w0),
            "step2_without_momentum": _update_err(no_mom, p2, w0)}


def phase_train_numerics():
    """ResNet-50 v1 on the card against the same port in float64 on the
    CPU, two steps from the same weights and batches: the card in
    float64 to ``TRAJ_*`` (the check of the SGD-momentum trajectory), and
    in float32 to limits scaled by the CPU's own float32 distance (see
    ``NUMERICS_FP32_FACTOR``)."""
    import mxnet_tpu_torch as mx

    rng = np.random.RandomState(7)
    data = rng.uniform(0, 1, (2, NUMERICS_BATCH, 3, 224, 224))
    label = rng.randint(0, 1000, (2, NUMERICS_BATCH)).astype(np.float64)
    net = resnet50(mx.gpu(0))
    w0 = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    aux = {k for k, p in net.collect_params().items()
           if p.grad_req == "null"}
    t0 = time.perf_counter()
    card64, card64_p = numerics_run(net, w0, data, label, "float64")
    card64_s = time.perf_counter() - t0
    card, card_p = numerics_run(net, w0, data, label, None)
    cnet = resnet50(mx.cpu())
    t0 = time.perf_counter()
    ref, ref_p = numerics_run(cnet, w0, data, label, "float64")
    cpu_s = time.perf_counter() - t0
    f32, f32_p = numerics_run(cnet, w0, data, label, None)

    loss64_err, upd64_err = trajectory_errors(card64, card64_p, ref, ref_p,
                                              w0)
    faults = fault_update_errs(ref_p, w0, aux)
    loss_err, upd_err = trajectory_errors(card, card_p, ref, ref_p, w0)
    f32_loss_err, f32_upd_err = trajectory_errors(f32, f32_p, ref, ref_p, w0)
    loss_tol = np.maximum(TRAIN_LOSS_RTOL,
                          NUMERICS_FP32_FACTOR * f32_loss_err)
    loss_tol[0] = TRAIN_LOSS_RTOL          # step 1: one forward
    upd_tol = np.maximum(TRAIN_UPDATE_TOL, NUMERICS_FP32_FACTOR * f32_upd_err)
    row = {"phase": "train_numerics", "model": "resnet50_v1",
           "batch": NUMERICS_BATCH, "steps": 2, "allow_tf32": False,
           "reference": "the port on the CPU, float64",
           "cpu_losses": ref.tolist(),
           "float64": {"card_losses": card64.tolist(),
                       "loss_rel_err": loss64_err.tolist(),
                       "loss_rtol": TRAJ_LOSS_RTOL,
                       "update_rel_err": upd64_err.tolist(),
                       "update_tol": TRAJ_UPDATE_TOL,
                       "fault_update_err": faults},
           "float32": {"card_losses": card.tolist(),
                       "cpu_float32_losses": f32.tolist(),
                       "loss_rel_err": loss_err.tolist(),
                       "cpu_float32_loss_rel_err": f32_loss_err.tolist(),
                       "loss_rtol": loss_tol.tolist(),
                       "update_rel_err": upd_err.tolist(),
                       "cpu_float32_update_rel_err": f32_upd_err.tolist(),
                       "update_tol": upd_tol.tolist()},
           "card_float64_s": card64_s, "cpu_float64_s": cpu_s}
    emit(row)
    check_trajectory(card64, card64_p, ref, ref_p, w0)
    if not min(faults.values()) > TRAJ_UPDATE_TOL:
        raise RuntimeError("train_numerics: the float64 check cannot tell "
                           "a fault of step 2 from the reference: %r"
                           % (faults,))
    if not np.isfinite(card).all():
        raise RuntimeError("train_numerics: bad card losses %r" % (card,))
    if not (loss_err <= loss_tol).all():
        raise RuntimeError("train_numerics: float32 losses differ by %r "
                           "(limits %r)" % (loss_err.tolist(),
                                            loss_tol.tolist()))
    if not (upd_err <= upd_tol).all():
        raise RuntimeError("train_numerics: the float32 parameters' update "
                           "differs by %r of its size (limits %r)"
                           % (upd_err.tolist(), upd_tol.tolist()))
    return row


# ---------------------------------------------------------------------
# transformer-LM training: GPT-2-small width through TransformerTrainStep
# ---------------------------------------------------------------------
# the serve phase's widths (GPT2_SMALL), bf16 compute over float32
# parameters, batch 8 of 1024 tokens from LMTokenIter, SGD lr 0.01 (the
# class default) momentum 0.9, remat none
LM = dict(batch=8, seq=1024, lr=0.01, momentum=0.9, remat="none")
LM_SEQUENCES = 256          # 32 batches: every run below stays in epoch 1
LM_WARMUP = 3
LM_WINDOWS, LM_WINDOW_STEPS = 3, 4
LM_PROFILE_STEPS = 2
LM_FIT_STEPS, LM_CKPT_STEP = 20, 10
# train_lm_numerics: 2 layers, d_model 128, 2 heads (head_dim 64), d_ff
# 512, vocab 512, batch 4 of 256 tokens, 3 steps at lr 0.05
LM_NUM = dict(vocab_size=512, n_layers=2, d_model=128, n_heads=2, d_ff=512)
LM_NUM_BATCH, LM_NUM_SEQ, LM_NUM_STEPS, LM_NUM_LR = 4, 256, 3, 0.05
# the card in float32 (TF32 off; both attention kernels on the simt
# route) against the port on the CPU in float64 from the same
# parameters: float32 rounding of the forward and of the gradients,
# ~5e-8 of the loss and 1.3e-5 of the update, as the CPU's own float32
# run (reported beside).  The update limit sits 7.5x above that.  The
# phase also reads the update check on faults planted in the float64
# reference and fails unless every one exceeds the limit: step 2
# skipped (0.64), step 2 without momentum (0.38), the attention's
# gradient of v dropped (0.19) and of k dropped (5.7e-3, the smallest)
LM_NUM_LOSS_RTOL = 1e-5
LM_NUM_UPDATE_TOL = 1e-4


def lm_config(**over):
    from mxnet_tpu_torch.transformer import TransformerConfig

    kw = dict(GPT2_SMALL, dtype="bfloat16", param_dtype="float32")
    kw.update(over)
    return TransformerConfig(**kw)


def lm_iter(cfg, batch, seq, num_sequences, seed=0):
    from mxnet_tpu_torch.transformer import LMTokenIter

    return LMTokenIter(batch_size=batch, seq_len=seq,
                       vocab_size=cfg.vocab_size,
                       num_sequences=num_sequences, seed=seed)


def lm_step_flops(cfg, n_params, batch, seq):
    """Model FLOPs of one training step: 6 x N x tokens (N counts every
    parameter, the tied embedding once, as the head's product) plus the
    attention's two score products, 2 x 2 x D FLOPs over the unmasked
    (q, k) pairs a head, 3 times (forward + backward), every layer."""
    attn = 3 * 4.0 * batch * cfg.n_heads * cfg.head_dim * \
        causal_pairs(seq, seq, True) * cfg.n_layers
    return 6.0 * n_params * batch * seq + attn


def lm_kernel_group(name: str) -> str:
    n = name.lower()
    if "flash_bwd" in n:
        return "attention_bwd"
    if "flash_fwd" in n:
        return "attention_fwd"
    if "gemm" in n or "cutlass" in n or "xmma" in n or "nvjet" in n:
        # the step's only float32 products are the tied head's (logits
        # in f32, as the JAX package computes them); the rest are bf16
        return "gemm_f32_head" if "sgemm" in n or "f32f32" in n \
            else "gemm_bf16"
    if "softmax" in n or "logsumexp" in n or "reduce" in n:
        return "reduction"
    if "elementwise" in n or "vectorized" in n:
        return "elementwise"
    if "memcpy" in n or "memset" in n or "copy" in n or "cat" in n:
        return "copy"
    return "other"


def lm_profile(step, it, steps, untraced_ms):
    """``steps`` train steps under torch.profiler, after one traced
    warm-up step: device busy ms a step, the idle share against the
    untraced step time ``untraced_ms`` (and against the traced wall,
    which carries the profiler's own host cost), device ms a step by
    kernel group and the top kernels."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    batches = [it.next() for _ in range(steps + 1)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=steps)) as prof:
        for i, b in enumerate(batches):
            if i == 1:
                t0 = time.perf_counter()
            step.step(b.data[0], b.label[0])
            if i == steps:
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            else:
                if i == 0:
                    # the warm-up step's kernels end before the active
                    # steps begin, or its tail counts as theirs
                    torch.cuda.synchronize()
                # (a step() after the last active step would end the
                # cycle, and the profiler drops a finished cycle's events)
                prof.step()
    kernels = [(ev.name, ev.device_time_total) for ev in prof.events()
               if ev.device_type == DeviceType.CUDA
               and not getattr(ev, "is_user_annotation", False)]
    groups, per_kernel = defaultdict(float), defaultdict(float)
    for name, us in kernels:
        groups[lm_kernel_group(name)] += us / 1e3 / steps
        per_kernel[name] += us / 1e3 / steps
    busy = sum(us for _, us in kernels) / 1e3 / steps
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]
    return {"steps": steps, "traced_wall_ms_per_step": wall * 1e3 / steps,
            "device_busy_ms_per_step": busy,
            "idle_share": 1.0 - busy / untraced_ms,
            "idle_share_traced": 1.0 - busy / (wall * 1e3 / steps),
            "launches_per_step": len(kernels) / steps,
            "device_ms_by_group": dict(groups),
            "top_kernels_ms": [[n[:90], ms] for n, ms in top]}


def phase_train_lm():
    """GPT-2-small width transformer-LM training on the card through
    ``TransformerTrainStep``: timed windows, a profile, then ``fit`` for
    20 steps and a checkpoint at step 10 resumed to step 20, bitwise
    equal to the uninterrupted run."""
    from mxnet_tpu_torch.transformer import (TransformerTrainStep,
                                             param_shapes)

    cfg = lm_config()
    B, T = LM["batch"], LM["seq"]

    def new_step():
        return TransformerTrainStep(cfg, learning_rate=LM["lr"],
                                    momentum=LM["momentum"],
                                    remat=LM["remat"], seed=0)

    t0 = time.perf_counter()
    step = new_step()
    it = lm_iter(cfg, B, T, LM_SEQUENCES)
    step.bucket_plan_meta()         # builds: the parameters on the card
    n_params = sum(int(np.prod(shape)) for _, shape, _ in param_shapes(cfg))
    build_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    warm = [float(step.step(b.data[0], b.label[0]))
            for b in (it.next() for _ in range(LM_WARMUP))]
    warm_s = time.perf_counter() - t0
    # the path: counts start at 0 here and are read just after
    _reset_kernel_counts()
    windows, losses = [], []
    for _ in range(LM_WINDOWS):
        batches = [it.next() for _ in range(LM_WINDOW_STEPS)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = [step.step(b.data[0], b.label[0]) for b in batches]
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t0) / LM_WINDOW_STEPS * 1e3)
        losses += [float(x) for x in out]
    counts = _kernel_counts()
    n_steps = LM_WINDOWS * LM_WINDOW_STEPS
    peak = torch.cuda.max_memory_allocated()
    step_ms = statistics.median(windows)
    prof = lm_profile(step, it, LM_PROFILE_STEPS, step_ms)
    del step
    flops = lm_step_flops(cfg, n_params, B, T)

    # fit: 20 steps uninterrupted; 10 steps writing a checkpoint at
    # step 10; that checkpoint resumed to step 20
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_lm_")
    try:
        control = new_step()
        t0 = time.perf_counter()
        fit_losses = control.fit(lm_iter(cfg, B, T, LM_SEQUENCES),
                                 LM_FIT_STEPS)
        fit_s = time.perf_counter() - t0
        want = control.params_numpy()
        del control
        first = new_step()
        t0 = time.perf_counter()
        first_losses = first.fit(lm_iter(cfg, B, T, LM_SEQUENCES),
                                 LM_CKPT_STEP,
                                 checkpoint_every_n=LM_CKPT_STEP,
                                 checkpoint_dir=ckdir)
        ckpt_fit_s = time.perf_counter() - t0
        del first
        resumed = TransformerTrainStep(cfg, learning_rate=LM["lr"],
                                       momentum=LM["momentum"],
                                       remat=LM["remat"], seed=1)
        t0 = time.perf_counter()
        resumed_losses = resumed.fit(lm_iter(cfg, B, T, LM_SEQUENCES),
                                     LM_FIT_STEPS, resume_from=ckdir)
        resume_s = time.perf_counter() - t0
        got = resumed.params_numpy()
        del resumed
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    differ = sorted(k for k in want if not np.array_equal(want[k], got[k]))

    tokens_s = B * T / (step_ms / 1e3)
    row = {
        "phase": "train_lm", "config": dict(GPT2_SMALL, dtype="bfloat16",
                                            param_dtype="float32"),
        "params": n_params, "train": LM, "build_s": build_s,
        "warmup_steps": LM_WARMUP, "warmup_s": warm_s,
        "warm_losses": warm,
        "tokens_per_s": tokens_s, "step_ms": step_ms,
        "step_ms_windows": windows,
        "window_steps": LM_WINDOW_STEPS, "timed_losses": losses,
        "peak_mem_bytes": peak,
        "tflops": flops / (step_ms / 1e3) / 1e12,
        "tflops_frac_of_bf16_peak": flops / (step_ms / 1e3) /
            PEAK_BF16_FLOPS,
        "flops_per_step": flops,
        "tflops_basis": "6 x N x tokens + 3 x 4 x B x H x D x causal "
                        "pairs x layers, against the 989 TFLOP/s bf16 "
                        "peak",
        "kernel_launches": counts, "steps_counted": n_steps,
        "profile": prof,
        "fit": {"steps": LM_FIT_STEPS, "losses": fit_losses,
                "seconds": fit_s},
        "resume": {"checkpoint_step": LM_CKPT_STEP,
                   "first_losses_equal": first_losses ==
                       fit_losses[:LM_CKPT_STEP],
                   "losses_equal": resumed_losses ==
                       fit_losses[LM_CKPT_STEP:],
                   "params_differ": differ, "fit_s": ckpt_fit_s,
                   "resume_s": resume_s},
    }
    emit(row)
    want_launches = cfg.n_layers * n_steps
    if counts["flash_attention_fwd"] != want_launches or \
            counts["flash_attention_fwd_by_route"]["wgmma"] != want_launches \
            or counts["flash_attention_bwd"] != want_launches or \
            counts["flash_attention_bwd_by_route"]["wgmma"] != want_launches:
        raise RuntimeError("train_lm: %r kernel launches in %d steps of %d "
                           "layers (want %d forward, all wgmma, and %d "
                           "backward, all wgmma)"
                           % (counts, n_steps, cfg.n_layers, want_launches,
                              want_launches))
    allx = warm + losses + fit_losses
    if not np.isfinite(allx).all():
        raise RuntimeError("train_lm: a loss is not finite")
    if not fit_losses[-1] < fit_losses[0]:
        raise RuntimeError("train_lm: fit did not lower the loss: %r"
                           % (fit_losses,))
    if not (row["resume"]["first_losses_equal"]
            and row["resume"]["losses_equal"]) or differ:
        raise RuntimeError("train_lm: the resumed run is not bitwise the "
                           "uninterrupted one: %r" % (row["resume"],))
    return row


# faults planted in the attention's backward: the gradient of one input
# is dropped (that input is detached from the graph)
LM_ATTN_FAULTS = {
    "attention_dk_zero": lambda f: lambda q, k, v: f(q, k.detach(), v),
    "attention_dv_zero": lambda f: lambda q, k, v: f(q, k, v.detach()),
}


def _lm_numerics_run(cfg, device, w0, steps, dtype=None, attn_fault=None,
                     sequences=None):
    """``steps`` fit steps from parameters ``w0`` on ``device``; returns
    the losses and the parameters after each step (float64 numpy).
    ``attn_fault`` names an entry of ``LM_ATTN_FAULTS`` to plant;
    ``sequences`` sizes the corpus (default: ``steps`` batches)."""
    from mxnet_tpu_torch.transformer import TransformerTrainStep

    step = TransformerTrainStep(cfg, learning_rate=LM_NUM_LR, momentum=0.9,
                                device=device)
    step.load_state({"params": {k: v.astype(dtype or v.dtype)
                                for k, v in w0.items()}})
    if attn_fault is not None:
        # load_state built the step and bound its attention
        step._attn_fn = LM_ATTN_FAULTS[attn_fault](step._attn_fn)
    it = lm_iter(cfg, LM_NUM_BATCH, LM_NUM_SEQ,
                 sequences or LM_NUM_BATCH * steps, seed=1)
    losses, params = [], []
    for _ in range(steps):
        b = it.next()
        losses.append(float(step.step(b.data[0], b.label[0])))
        params.append({k: v.astype(np.float64)
                       for k, v in step.params_numpy().items()})
    return np.array(losses), params


def phase_train_lm_numerics():
    """A small config on the card against the port on the CPU in
    float64, and bf16 on the card against float32 (see LM_NUM_*)."""
    from mxnet_tpu_torch.transformer import TransformerTrainStep

    cfg32 = lm_config(**LM_NUM, dtype="float32", param_dtype="float32")
    cfg64 = lm_config(**LM_NUM, dtype="float64", param_dtype="float64")
    cfg16 = lm_config(**LM_NUM, dtype="bfloat16", param_dtype="float32")
    w0 = TransformerTrainStep(cfg32, device="cpu", seed=0).params_numpy()
    _reset_kernel_counts()
    card, card_p = _lm_numerics_run(cfg32, "cuda", w0, LM_NUM_STEPS)
    counts = _kernel_counts()
    ref, ref_p = _lm_numerics_run(cfg64, "cpu", w0, LM_NUM_STEPS,
                                  np.float64)
    cpu32, cpu32_p = _lm_numerics_run(cfg32, "cpu", w0, LM_NUM_STEPS)
    bf16, _ = _lm_numerics_run(cfg16, "cuda", w0, 1)
    loss_err, upd_err = trajectory_errors(card, card_p, ref, ref_p, w0)
    c32_loss_err, c32_upd_err = trajectory_errors(cpu32, cpu32_p, ref, ref_p,
                                                  w0)
    p1, p2 = ref_p[0], ref_p[1]
    no_mom = {k: v - 0.9 * (p1[k] - w0[k]) for k, v in p2.items()}
    faults = {"step2_skipped": _update_err(p1, p2, w0),
              "step2_without_momentum": _update_err(no_mom, p2, w0)}
    for name in LM_ATTN_FAULTS:
        bad, bad_p = _lm_numerics_run(cfg64, "cpu", w0, LM_NUM_STEPS,
                                      np.float64, attn_fault=name)
        # the largest reading over the steps: the check holds every step
        faults[name] = float(trajectory_errors(bad, bad_p, ref, ref_p,
                                               w0)[1].max())
    bf16_rel = abs(bf16[0] - card[0]) / abs(card[0])
    want = cfg32.n_layers * LM_NUM_STEPS
    row = {"phase": "train_lm_numerics", "config": LM_NUM,
           "batch": LM_NUM_BATCH, "seq": LM_NUM_SEQ, "steps": LM_NUM_STEPS,
           "reference": "the port on the CPU, float64",
           "cpu_losses": ref.tolist(), "card_float32_losses": card.tolist(),
           "loss_rel_err": loss_err.tolist(), "loss_rtol": LM_NUM_LOSS_RTOL,
           "update_rel_err": upd_err.tolist(),
           "update_tol": LM_NUM_UPDATE_TOL,
           "cpu_float32_loss_rel_err": c32_loss_err.tolist(),
           "cpu_float32_update_rel_err": c32_upd_err.tolist(),
           "fault_update_err": faults, "kernel_launches": counts,
           "bf16_first_loss": float(bf16[0]),
           "bf16_first_loss_rel_err": bf16_rel,
           "bf16_loss_rtol": BF16_LOSS_RTOL}
    emit(row)
    if counts["flash_attention_fwd_by_route"]["simt"] != want or \
            counts["flash_attention_bwd_by_route"]["simt"] != want:
        raise RuntimeError("train_lm_numerics: float32 kernel launches %r, "
                           "want %d simt forward and backward"
                           % (counts, want))
    if not (np.isfinite(card).all() and (loss_err <= LM_NUM_LOSS_RTOL).all()
            and (upd_err <= LM_NUM_UPDATE_TOL).all()):
        raise RuntimeError("train_lm_numerics: float32 on the card is off "
                           "the float64 trajectory: %r" % (row,))
    if not min(faults.values()) > LM_NUM_UPDATE_TOL:
        raise RuntimeError("train_lm_numerics: the check cannot tell a "
                           "planted fault from the reference: %r"
                           % (faults,))
    if not (np.isfinite(bf16).all() and bf16_rel <= BF16_LOSS_RTOL):
        raise RuntimeError("train_lm_numerics: bf16 first loss %r against "
                           "float32 %r" % (bf16.tolist(), card[0]))
    return row


# ---------------------------------------------------------------------
# the symbolic path: ResNet-50 v1 through mx.sym + Module.fit
# ---------------------------------------------------------------------
# bench_fit_loop (bench.py:1254-1298): batch 32, 224x224, 1000 classes,
# float32 (TF32 off), NDArrayIter over 8 batches from numpy seed 0, Xavier,
# SGD lr 0.05 momentum 0.9, engine.set_bulk_size(8), 2 epochs; images/s
# from the later epoch (the first pays one-time costs)
FIT = dict(batch=32, image=224, classes=1000, n_batches=8, bulk_k=8,
           epochs=2, lr=0.05, momentum=0.9)
FIT_FUSED_WARMUP, FIT_FUSED_WINDOWS = 3, 2
# fit_numerics: the same symbol cut to batch 4, 64x64, 10 classes; two
# Module.fit steps in float64 on the card against the port on the CPU:
# parameters and BatchNorm moving statistics within 1e-10 of the
# update's size (as train_numerics, whose float64 trajectory agrees to
# ~1e-11)
FIT_NUM = dict(batch=4, image=64, classes=10, steps=2)
FIT_NUM_TOL = 1e-10
# export: the Gluon resnet50_v1 forward against its exported symbol
# through Module and through SymbolBlock.imports, float32: each row's
# error over that row's largest magnitude
EXPORT_BATCH, EXPORT_RTOL = 8, 1e-5


def _cast_module(mod, dtype):
    """Every cell of a bound module's executor in ``dtype`` (a Module
    binds float32 cells, as the JAX package's)."""
    ex = mod._exec
    for cells in (ex.arg_dict, ex.aux_dict, ex.grad_dict):
        for cell in cells.values():
            if cell is not None:
                cell._data = cell._data.to(dtype)


def _fit_data(batch, image, classes, n_batches, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.rand(batch * n_batches, 3, image, image).astype(np.float32)
    y = rng.randint(0, classes, batch * n_batches).astype(np.float32)
    return X, y


def _fit_run(bulk_k, X, y):
    """``Module.fit`` of the symbolic ResNet-50 as ``bench_fit_loop``
    runs it; returns the row and the module."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import engine

    it = mx.io.NDArrayIter(X, y, batch_size=FIT["batch"],
                           label_name="softmax_label")
    mod = mx.mod.Module(sym_resnet50(FIT["classes"]), context=mx.gpu(0))
    marks, metrics = [], []

    def clock(*_):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    def batch_end(param):
        metrics.append(dict(param.eval_metric.get_name_value()))

    np.random.seed(0)    # Xavier draws from numpy's global generator
    prev = engine.set_bulk_size(bulk_k)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_kernel_counts()
    t0 = time.perf_counter()
    try:
        mod.fit(it, num_epoch=FIT["epochs"], optimizer="sgd",
                optimizer_params=(("learning_rate", FIT["lr"]),
                                  ("momentum", FIT["momentum"])),
                eval_metric=["acc", "ce"], epoch_end_callback=clock,
                batch_end_callback=batch_end,
                initializer=mx.init.Xavier())
    finally:
        engine.set_bulk_size(prev)
    launches = _kernel_counts()
    epochs = [b - a for a, b in zip([t0] + marks, marks)]
    steps = FIT["n_batches"] * FIT["epochs"]
    loop = mod._bulk_loop
    row = {"bulk_k": bulk_k,
           "images_per_s": FIT["batch"] * FIT["n_batches"] / min(epochs[1:]),
           "epoch_s": epochs, "first_epoch_s": epochs[0],
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "kernel_launches": launches,
           "kernel_launches_per_step": {
               k: v / steps for k, v in launches.items()
               if isinstance(v, int)},
           "bulk_used": bool(loop is not None and loop.groups > 0),
           "bulk_groups": loop.groups if loop is not None else 0,
           "bulk_steps": loop.steps if loop is not None else 0,
           "last_train_metrics": metrics[-1],
           "metrics_finite": all(np.isfinite(v) for m in metrics
                                 for v in m.values())}
    return row, mod


def _fused_ips(X, y):
    """``FusedTrainStep`` on the Gluon zoo ``resnet50_v1`` at the fit's
    batch, image size and dtype (bench.py:1301-1322
    ``bench_fit_with_comparator``): images/s of the best window of
    ``bulk_k`` steps."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.parallel.dp import FusedTrainStep

    ctx = mx.gpu(0)
    net = resnet50(ctx)
    step = FusedTrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                          learning_rate=FIT["lr"], momentum=FIT["momentum"])
    data = mx.nd.array(X[:FIT["batch"]], ctx=ctx)
    label = mx.nd.array(y[:FIT["batch"]], ctx=ctx)
    step.run_steps(data, label, steps=FIT_FUSED_WARMUP).asnumpy()
    best = None
    for _ in range(FIT_FUSED_WINDOWS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = step.run_steps(data, label, steps=FIT["bulk_k"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        best = wall if best is None else min(best, wall)
    if not np.isfinite(losses.asnumpy()).all():
        raise RuntimeError("fit: the FusedTrainStep comparator's loss is "
                           "not finite")
    return FIT["batch"] * FIT["bulk_k"] / best


def phase_fit():
    """The symbolic ResNet-50 v1 at full width through ``Module.fit``,
    bulk K=8 and per-batch, and the ``FusedTrainStep`` comparator."""
    X, y = _fit_data(FIT["batch"], FIT["image"], FIT["classes"],
                     FIT["n_batches"])
    bulk, mod = _fit_run(FIT["bulk_k"], X, y)
    del mod
    per_batch, mod = _fit_run(1, X, y)
    del mod
    fused = _fused_ips(X, y)
    row = {"phase": "fit", "model": "sym_resnet50 (bench.py:1219)",
           "batch": FIT["batch"], "image": FIT["image"],
           "classes": FIT["classes"], "dtype": "float32",
           "allow_tf32": False, "n_batches": FIT["n_batches"],
           "epochs": FIT["epochs"], "init": "Xavier, numpy seed 0",
           "optimizer": {"lr": FIT["lr"], "momentum": FIT["momentum"]},
           "images_per_s": bulk["images_per_s"],
           "bulk_used": bulk["bulk_used"], "bulk": bulk,
           "per_batch": per_batch,
           "bulk_vs_per_batch":
               bulk["images_per_s"] / per_batch["images_per_s"],
           "fused_images_per_s": fused,
           "fit_vs_fused": bulk["images_per_s"] / fused,
           "kernel_launches": bulk["kernel_launches"]}
    emit(row)
    for run in (bulk, per_batch):
        if not run["metrics_finite"]:
            raise RuntimeError("fit: a train metric is not finite: %r"
                               % (run["last_train_metrics"],))
    if not bulk["bulk_used"] or bulk["bulk_steps"] != \
            FIT["n_batches"] * FIT["epochs"]:
        raise RuntimeError("fit: Module.fit did not take the bulk path "
                           "(%d groups, %d steps)"
                           % (bulk["bulk_groups"], bulk["bulk_steps"]))
    if per_batch["bulk_used"]:
        raise RuntimeError("fit: the per-batch run took the bulk path")
    return row


def _fit_steps(ctx, w0, aux0, X, y, bulk_k, batch=None, kvstore="local",
               symbol=None, group2ctxs=None, fault=None):
    """``Module.fit`` steps (one epoch of ``X`` in batches of ``batch``,
    default ``FIT_NUM["batch"]``) of the cut symbol (or ``symbol``) in
    float64 on ``ctx`` (a context list: data parallel) from ``w0`` /
    ``aux0``; returns the parameters (aux included) after each step, and
    the losses.  ``fault="grad_not_reduced"``: rank 1 of
    a multi-context Module keeps its own gradients (it still joins every
    collective)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import engine

    it = mx.io.NDArrayIter(X, y, batch_size=batch or FIT_NUM["batch"],
                           label_name="softmax_label")
    mod = mx.mod.Module(symbol or sym_resnet50(FIT_NUM["classes"]),
                        context=ctx, group2ctxs=group2ctxs)
    mod.bind(it.provide_data, it.provide_label)
    _cast_module(mod, torch.float64)
    mod.init_params(arg_params=w0, aux_params=aux0)
    if fault == "grad_not_reduced" and mod._dp.mesh.rank == 1:
        reduce = mod._dp.reduce_grads

        def keep_local(grad_dict, names):
            local = {k: grad_dict[k]._data for k in names
                     if grad_dict.get(k) is not None}
            reduce(grad_dict, names)
            for k, v in local.items():
                grad_dict[k]._data = v

        mod._dp.reduce_grads = keep_local
    params, losses = [], []

    def host(m):
        a, x = m.get_params()
        return {k: v.asnumpy() for k, v in list(a.items()) +
                list(x.items())}

    def batch_end(param):
        # the running cross-entropy (eval_metric ["acc", "ce"])
        losses.append(param.eval_metric.get_name_value()[1][1])
        if bulk_k == 1:
            params.append(host(mod))

    prev = engine.set_bulk_size(bulk_k)
    try:
        mod.fit(it, num_epoch=1, optimizer="sgd", eval_metric=["acc", "ce"],
                kvstore=kvstore,
                optimizer_params=(("learning_rate", FIT["lr"]),
                                  ("momentum", FIT["momentum"])),
                batch_end_callback=batch_end)
    finally:
        engine.set_bulk_size(prev)
    if bulk_k != 1:
        params = [None, host(mod)]
    return params, np.array(losses), mod


def phase_fit_numerics():
    """The fit's symbol cut to batch 4, 64x64, 10 classes: two float64
    ``Module.fit`` steps on the card against the same on the CPU (the
    parameters and BatchNorm moving statistics within ``FIT_NUM_TOL`` of
    the update's size), and bulk K=2 on the card equal to per-batch."""
    import mxnet_tpu_torch as mx

    n = FIT_NUM["batch"] * FIT_NUM["steps"]
    X, y = _fit_data(FIT_NUM["batch"], FIT_NUM["image"], FIT_NUM["classes"],
                     FIT_NUM["steps"], seed=7)
    X = X.astype(np.float64)
    # the start: Xavier (numpy seed 0) on the CPU, in float64
    start = mx.mod.Module(sym_resnet50(FIT_NUM["classes"]),
                          context=mx.cpu())
    start.bind([("data", (FIT_NUM["batch"], 3, FIT_NUM["image"],
                          FIT_NUM["image"]))],
               [("softmax_label", (FIT_NUM["batch"],))])
    _cast_module(start, torch.float64)
    np.random.seed(0)
    start.init_params(mx.init.Xavier())
    w0, aux0 = start.get_params()
    flat0 = {k: v.asnumpy() for k, v in list(w0.items()) + list(aux0.items())}
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        card, card_loss, _ = _fit_steps(mx.gpu(0), w0, aux0, X, y, 1)
        card_s = time.perf_counter() - t0
        bulk, bulk_loss, bmod = _fit_steps(mx.gpu(0), w0, aux0, X, y,
                                           FIT_NUM["steps"])
    finally:
        torch.backends.cudnn.deterministic = det
    t0 = time.perf_counter()
    ref, ref_loss, _ = _fit_steps(mx.cpu(), w0, aux0, X, y, 1)
    cpu_s = time.perf_counter() - t0
    upd = [_update_err(c, r, flat0) for c, r in zip(card, ref)]
    aux_names = sorted(aux0)
    aux_err = _update_err({k: card[-1][k] for k in aux_names},
                          {k: ref[-1][k] for k in aux_names},
                          {k: flat0[k] for k in aux_names})
    skipped = _update_err(ref[0], ref[1], flat0)
    bulk_diff = max(float(np.abs(bulk[-1][k] - card[-1][k]).max())
                    for k in card[-1])
    row = {"phase": "fit_numerics", "model": "sym_resnet50",
           "cut": {"batch": FIT_NUM["batch"], "image": FIT_NUM["image"],
                   "classes": FIT_NUM["classes"], "steps": FIT_NUM["steps"]},
           "samples": n, "dtype": "float64",
           "reference": "the port on the CPU, float64",
           "card_ce": card_loss.tolist(), "cpu_ce": ref_loss.tolist(),
           "update_rel_err": upd, "aux_update_rel_err": aux_err,
           "tol": FIT_NUM_TOL, "fault_step2_skipped_err": skipped,
           "bulk_used": bool(bmod._bulk_loop is not None
                             and bmod._bulk_loop.groups == 1),
           "bulk_vs_per_batch_max_abs_diff": bulk_diff,
           "cudnn_deterministic": True,
           "card_s": card_s, "cpu_s": cpu_s}
    emit(row)
    if not (max(upd) <= FIT_NUM_TOL and aux_err <= FIT_NUM_TOL):
        raise RuntimeError("fit_numerics: the card's float64 trajectory "
                           "differs from the CPU's by %r (aux %g; limit %g)"
                           % (upd, aux_err, FIT_NUM_TOL))
    if not skipped > FIT_NUM_TOL:
        raise RuntimeError("fit_numerics: the check cannot tell a skipped "
                           "step 2 (%g) from the reference" % skipped)
    if not row["bulk_used"] or bulk_diff != 0.0:
        raise RuntimeError("fit_numerics: bulk K=2 differs from per-batch "
                           "by %g (bulk used: %s)"
                           % (bulk_diff, row["bulk_used"]))
    return row


def phase_export():
    """The Gluon ``resnet50_v1`` on the card through ``export``, then
    ``mx.sym.load`` + ``Module`` (``for_training=False``) and
    ``SymbolBlock.imports``: both against the Gluon forward."""
    import mxnet_tpu_torch as mx

    ctx = mx.gpu(0)
    net = resnet50(ctx)
    rng = np.random.RandomState(11)
    x = rng.uniform(0, 1, (EXPORT_BATCH, 3, 224, 224)).astype(np.float32)
    data = mx.nd.array(x, ctx=ctx)
    want = net(data).asnumpy()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_export_")
    try:
        path = str(Path(tmp) / "resnet50_v1")
        t0 = time.perf_counter()
        net.export(path)
        export_s = time.perf_counter() - t0
        sym = mx.sym.load(path + "-symbol.json")
        _, args, aux = mx.model.load_checkpoint(path, 0)
        mod = mx.mod.Module(sym, label_names=None, context=ctx)
        mod.bind([("data", x.shape)], for_training=False)
        mod.set_params(args, aux)
        mod.forward(mx.io.DataBatch([data]), is_train=False)
        via_module = mod.get_outputs()[0].asnumpy()
        blk = mx.gluon.SymbolBlock.imports(path + "-symbol.json", ["data"],
                                           path + "-0000.params", ctx=ctx)
        via_block = blk(data).asnumpy()
        n_nodes = len(sym._topo())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    errs = {name: row_scaled_err(torch.from_numpy(got),
                                 torch.from_numpy(want))
            for name, got in (("module", via_module),
                              ("symbol_block", via_block))}
    row = {"phase": "export", "model": "resnet50_v1 (gluon zoo)",
           "batch": EXPORT_BATCH, "image": 224, "dtype": "float32",
           "symbol_nodes": n_nodes, "export_s": export_s,
           "row_scaled_err": errs, "rtol": EXPORT_RTOL,
           "finite": bool(np.isfinite(want).all())}
    emit(row)
    if not row["finite"] or not all(e <= EXPORT_RTOL for e in errs.values()):
        raise RuntimeError("export: outputs differ from the Gluon forward "
                           "by %r of each row (limit %g)"
                           % (errs, EXPORT_RTOL))
    return row


# ---------------------------------------------------------------------
# data-parallel training: one process per card over torch.distributed
# ---------------------------------------------------------------------
# dp: the train cell per rank (ResNet-50 v1 bf16, batch 128 a rank,
# 224x224, SGD lr 0.05 momentum 0.9), one rank per visible card over
# NCCL; every rank gets the global batch (128 x ranks) and trains on its
# rows.  Three exchanges: bucketed (4 MiB buckets from backward hooks),
# ZeRO-1 on the buckets, monolithic (bucket_bytes=0); beside them the
# one-device step on 128 rows in the same process.  Each is timed in
# DP["rounds"] windows taken in turns (a window: DP["warmup"] steps,
# then DP["steps"] timed), so that drift of the host or the card's
# clocks falls on every variant alike
DP = dict(batch=128, warmup=2, steps=3, rounds=1, profile_steps=2)
DP_VARIANTS = (("one_device", None), ("bucketed", {}),
               ("zero1", {"zero_stage": 1}),
               ("monolithic", {"bucket_bytes": 0}))
# dp_numerics: fit_numerics's cut (batch 4 a rank, 64x64, 10 classes) in
# float64 on two ranks sharing cuda:0 over gloo (NCCL refuses two ranks
# on one card), 2 steps; cuDNN deterministic.  Against the one-device
# float64 step at the global batch 8 on the card: the parameters (aux
# included) within DP_NUM_TOL of the update's size; bucketed against
# monolithic bitwise; ZeRO-1 against replicated bitwise at lr 0 and
# within DP_ZERO1_TOL otherwise; two planted faults must read above the
# limit: rank 1 keeps its own gradient (the all-reduce's result
# dropped), and sync BN's backward without its all-reduce (a plain
# all-reduce in the forward, which carries no gradient across ranks).
# accum_steps=2, bucketed and ZeRO-1, against one device accumulating
# the same microbatches (the ranks' k-th slices together: sync BN's
# moments are each microbatch's over the ranks) within DP_NUM_TOL, and
# MXNET_REMAT_POLICY=stage (sync BN's moments reduced again in each
# stage's recompute) against the one-device step; every run counts the
# collectives of a step
DP_NUM = dict(batch=4, image=64, classes=10, steps=2, lr=0.05)
DP_NUM_TOL = 1e-10
DP_ZERO1_TOL = 1e-12
# train_lm_dp: the train_lm cell a rank (GPT-2-small width, bf16 over
# float32 parameters, batch 8 x 1024 a rank), ZeRO-1, one rank per card
# over NCCL; then fit 20 steps, and a checkpoint at step 10 resumed to 20
LM_DP = dict(zero_stage=1)
# train_lm_dp_numerics: train_lm_numerics's cut (global batch 4 x 256)
# on two gloo ranks sharing cuda:0, float32: the trajectory against the
# port on the CPU in float64 at the global batch within the LM_NUM_*
# limits (the flash kernels take no float64, so the dp=2 run cannot be
# held to the one-device run beyond float32's rounding; that distance
# is reported); a dp=2 ZeRO-1 checkpoint at step 2 restaged to dp=1 on
# the card continues as the uninterrupted dp=2 run within
# LM_NUM_UPDATE_TOL of the update since the checkpoint; planted faults:
# rank 1's gradient not reduced, and the restage with its momenta zeroed
LM_DP_NUM_STEPS, LM_DP_CKPT = 3, 2
LM_DP_NUM_SEQS = LM_NUM_BATCH * (LM_DP_NUM_STEPS + 1)


def _rank_setup():
    """A rank's process: TF32 off, as phase_device sets the parent."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def side_by_side(*fns):
    """Every zero-argument ``fn`` at once, each on its own thread; their
    results in order (the first error raised).  For numerics only (a
    phase, or a ``dist.launch`` of ranks that share the card): nothing
    run this way is timed."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(fns)) as pool:
        futures = [pool.submit(fn) for fn in fns]
        return [f.result() for f in futures]


def _nccl_stats(prof_events, steps, kinds=None):
    """NCCL kernels a step from a torch.profiler trace: launches, device
    ms, and the ms of them not overlapped by any other kernel (exposed:
    the all-reduce time compute does not hide).  ``kinds``: count only
    the NCCL kernels whose name holds one of these words (e.g.
    ``("SendRecv",)``); the others count as compute that may hide
    them."""
    import bisect

    from torch.autograd import DeviceType

    kern = [(ev.name, ev.time_range.start, ev.time_range.end)
            for ev in prof_events if ev.device_type == DeviceType.CUDA
            and not getattr(ev, "is_user_annotation", False)]
    nccl = [k for k in kern if "nccl" in k[0].lower() and
            (kinds is None or any(w in k[0] for w in kinds))]
    merged = []
    for _, s, e in sorted((k for k in kern if k not in nccl),
                          key=lambda k: k[1]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    starts = [m[0] for m in merged]
    exposed = 0.0
    for _, s, e in nccl:
        hidden = 0.0
        i = max(bisect.bisect_right(starts, s) - 1, 0)
        while i < len(merged) and merged[i][0] < e:
            hidden += max(0.0, min(e, merged[i][1]) - max(s, merged[i][0]))
            i += 1
        exposed += (e - s) - hidden
    return {"nccl_launches_per_step": len(nccl) / steps,
            "nccl_device_ms_per_step":
                sum(e - s for _, s, e in nccl) / 1e3 / steps,
            "nccl_exposed_ms_per_step": exposed / 1e3 / steps,
            "device_busy_ms_per_step":
                sum(e - s for _, s, e in kern) / 1e3 / steps,
            "launches_per_step": len(kern) / steps,
            "nccl_kernels": sorted({n[:60] for n, _, _ in nccl})}


def _dp_rank():
    """One rank of ``dp``: the one-device step and the three exchanges,
    timed in turns; every rank then takes 3 more one-device and 3 more
    bucketed steps, which rank 0 profiles."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import convert, dist, gluon
    from mxnet_tpu_torch.parallel.dp import FusedTrainStep
    from mxnet_tpu_torch.parallel.mesh import data_parallel_mesh

    _rank_setup()
    mesh = data_parallel_mesh()
    n = mesh.size
    ctx = mx.gpu(dist.device().index)
    net = resnet50(ctx)
    w0 = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    data, label = train_batch(DP["batch"] * n, ctx)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    rows = {name: {"exchange": name, "windows_ms": []}
            for name, _ in DP_VARIANTS}
    for rnd in range(DP["rounds"]):
        for name, kw in DP_VARIANTS:
            row = rows[name]
            one = kw is None
            d, lab = (data[:DP["batch"]], label[:DP["batch"]]) if one \
                else (data, label)
            net.cast("float32")
            convert.load_block_params(net, w0)
            step = FusedTrainStep(net, loss_fn, mesh=None if one else mesh,
                                  learning_rate=TRAIN_LR,
                                  momentum=TRAIN_MOMENTUM, dtype="bfloat16",
                                  **(kw or {}))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_kernel_counts()
            warm = step.run_steps(d, lab, steps=DP["warmup"]).asnumpy()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses = step.run_steps(d, lab, steps=DP["steps"])
            torch.cuda.synchronize()
            row["windows_ms"].append(
                (time.perf_counter() - t0) / DP["steps"] * 1e3)
            losses = losses.asnumpy()
            row.update(
                first_loss=float(warm[0]), last_loss=float(losses[-1]),
                peak_mem_bytes=torch.cuda.max_memory_allocated(),
                bucketed=step.bucketed, zero1=step.zero1,
                buckets=step.bucket_accounting(),
                optimizer_state_bytes_per_rank=
                    step.optimizer_state_bytes_per_rank(),
                kernel_launches=_kernel_counts())
            if rnd == 0 and name in ("one_device", "bucketed"):
                # every rank runs the profiled steps, so that their
                # collectives pair up across ranks; rank 0 records them
                from torch.profiler import ProfilerActivity, profile, \
                    schedule

                rec = mesh.rank == 0
                prof = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA],
                               schedule=schedule(
                                   wait=0, warmup=1,
                                   active=DP["profile_steps"])) \
                    if rec else contextlib.nullcontext()
                with prof:
                    for i in range(DP["profile_steps"] + 1):
                        step.run_steps(d, lab, steps=1)
                        torch.cuda.synchronize()
                        if rec and i < DP["profile_steps"]:
                            prof.step()
                if rec:
                    row["profile"] = _nccl_stats(prof.events(),
                                                 DP["profile_steps"])
            del step
    out = []
    for name, kw in DP_VARIANTS:
        row = rows[name]
        step_ms = statistics.median(row["windows_ms"])
        imgs = DP["batch"] * (1 if kw is None else n)
        row.update(ranks=1 if kw is None else n, global_batch=imgs,
                   step_ms=step_ms, step_ms_min=min(row["windows_ms"]),
                   images_per_s=imgs / step_ms * 1e3,
                   images_per_s_per_rank=DP["batch"] / step_ms * 1e3)
        out.append(row)
    return out


def phase_dp(train_row):
    """ResNet-50 v1 bf16 data-parallel over NCCL, one rank per visible
    card (``dist.launch``, spawn): images/s in total and a rank, step ms,
    peak memory, ``dp_efficiency`` against the ``train`` row's batch-128
    images/s, the buckets, ZeRO-1's momenta bytes a rank, the monolithic
    exchange, and from rank 0's trace the NCCL launches and device ms a
    step and the all-reduce time not hidden under compute kernels."""
    from mxnet_tpu_torch import dist

    n = torch.cuda.device_count()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = dist.launch(_dp_rank, n, backend="nccl", timeout_s=300)
    wall = time.perf_counter() - t0
    single = next(r for r in train_row["runs"]
                  if r["batch"] == DP["batch"])["images_per_s"]
    rows = ranks[0]
    one = rows[0]["images_per_s"]
    for r in rows[1:]:
        r["dp_efficiency"] = r["images_per_s"] / (n * single)
        r["dp_efficiency_same_process"] = r["images_per_s"] / (n * one)
    row = {"phase": "dp", "model": "resnet50_v1", "dtype": "bfloat16",
           "backend": "nccl", "ranks": n, "batch_per_rank": DP["batch"],
           "image": 224, "train_images_per_s_batch128": single,
           "runs": rows, "ranks_step_ms": [[r["step_ms"] for r in rr]
                                           for rr in ranks],
           "wall_s": wall}
    emit(row)
    for r in rows:
        if not (np.isfinite(r["first_loss"]) and np.isfinite(r["last_loss"])):
            raise RuntimeError("dp: a loss is not finite: %r" % (r,))
    _, b, z, m = rows
    if not (b["bucketed"] and z["zero1"] and not m["bucketed"]
            and b["buckets"] and m["buckets"] is None):
        raise RuntimeError("dp: the exchanges did not take their paths: %r"
                           % (rows,))
    return row


def _digest(params) -> str:
    import hashlib

    h = hashlib.sha256()
    for k in sorted(params):
        h.update(np.ascontiguousarray(params[k]).tobytes())
    return h.hexdigest()


def _dp_numerics_rank(ref_path, aux, data, label, runs):
    """One rank of ``dp_numerics``: each run of ``runs`` (name, step
    options, planted fault) takes DP_NUM steps from the same weights.
    The ResNet's parameters are ~190 MB in float64, so the rank reads
    the one-device reference trajectory from ``ref_path`` and returns
    numbers only: each step's update error against it (aux too), a
    digest of each step's parameters (bitwise comparisons across runs
    and ranks), and ZeRO-1's error against the replicated run."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import convert, dist, gluon
    from mxnet_tpu_torch.parallel.dp import FusedTrainStep
    from mxnet_tpu_torch.parallel.mesh import data_parallel_mesh

    _rank_setup()
    torch.backends.cudnn.deterministic = True
    mesh = data_parallel_mesh()
    ctx = mx.gpu(dist.device().index)
    with np.load(ref_path) as f:
        ref = {k: f[k] for k in f.files}
    w0 = {k[3:]: v for k, v in ref.items() if k.startswith("w0/")}
    # s: the one-device step; a: one device accumulating 2 microbatches
    refs = {tag: [{k[3:]: v for k, v in ref.items()
                   if k.startswith("%s%d/" % (tag, i))}
                  for i in range(len(data))] for tag in ("s", "a")}
    net = _dp_num_net(ctx)
    out, keep = {}, {}
    for name, kw, fault in runs:
        kw = dict(kw)
        policy = kw.pop("remat", "none")
        net.cast("float32")
        convert.load_block_params(net, w0)
        step = FusedTrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                              mesh=mesh, momentum=TRAIN_MOMENTUM,
                              dtype="float64", **dict(
                                  {"learning_rate": DP_NUM["lr"]}, **kw))
        losses, params = [], []
        with _DpFault(fault, mesh), remat_knobs(policy):
            for k in range(len(data)):
                # the collectives of the last step (the first also
                # broadcasts the parameters)
                with _CollectiveCount(k == len(data) - 1) as count:
                    losses.append(float(step.run_steps(
                        mx.nd.array(data[k:k + 1], ctx=ctx),
                        mx.nd.array(label[k:k + 1], ctx=ctx)).asnumpy()[0]))
                params.append({p: v.data().asnumpy() for p, v in
                               net.collect_params().items()})
        ref_p = refs["a" if kw.get("accum_steps") else "s"]
        row = {"losses": losses, "bucketed": step.bucketed,
               "zero1": step.zero1, "collectives_per_step": count.calls,
               "update_err": [_update_err(g, w, w0)
                              for g, w in zip(params, ref_p)],
               "aux_update_err": _update_err(
                   {k: params[-1][k] for k in aux},
                   {k: ref_p[-1][k] for k in aux}, {k: w0[k] for k in aux}),
               "digests": [_digest(p) for p in params]}
        if name == "bucketed":
            keep = params
        if name == "zero1":
            row["vs_bucketed_update_err"] = max(
                _update_err(g, w, w0) for g, w in zip(params, keep))
        out[name] = row
        del step, params
    return out


class _CollectiveCount:
    """Count this rank's collectives by kind while ``on``."""

    KINDS = ("all_reduce", "reduce_scatter_tensor",
             "all_gather_into_tensor", "broadcast")

    def __init__(self, on=True):
        self.on, self.calls = on, {}

    def __enter__(self):
        import torch.distributed as tdist

        self.saved = {k: getattr(tdist, k) for k in self.KINDS}
        if self.on:
            for kind, real in self.saved.items():
                def counted(*a, _real=real, _kind=kind, **kw):
                    self.calls[_kind] = self.calls.get(_kind, 0) + 1
                    return _real(*a, **kw)

                setattr(tdist, kind, counted)
        return self

    def __exit__(self, *exc):
        import torch.distributed as tdist

        for kind, real in self.saved.items():
            setattr(tdist, kind, real)
        return False


class _DpFault:
    """A fault planted on this rank for one run: ``grad_not_reduced``
    (rank 1 keeps its own gradient: each bucket's all-reduce still runs,
    so the ranks stay in step, but its result is replaced by the local
    gradient times n) or ``sync_bn_backward_local`` (BatchNorm's moment
    mean without its backward all-reduce)."""

    def __init__(self, fault, mesh):
        self.fault, self.mesh = fault, mesh

    def __enter__(self):
        import torch.distributed as tdist

        from mxnet_tpu_torch.ops import nn as nn_ops

        self.saved = (tdist.all_reduce, nn_ops._CrossDeviceMean.backward)
        if self.fault == "grad_not_reduced" and self.mesh.rank == 1:
            real, n = tdist.all_reduce, self.mesh.size

            class _Local:
                def __init__(self, t, work, keep):
                    self.t, self.work, self.keep = t, work, keep

                def wait(self):
                    self.work.wait()
                    self.t.copy_(self.keep * n)
                    return True

            def all_reduce(t, *a, async_op=False, **kw):
                if not async_op:            # sync BN, the loss
                    return real(t, *a, **kw)
                keep = t.clone()
                return _Local(t, real(t, *a, async_op=True, **kw), keep)

            tdist.all_reduce = all_reduce
        elif self.fault == "sync_bn_backward_local":
            nn_ops._CrossDeviceMean.backward = staticmethod(
                lambda ctx, g: (g / ctx.n, None, None))
        return self

    def __exit__(self, *exc):
        import torch.distributed as tdist

        from mxnet_tpu_torch.ops import nn as nn_ops

        tdist.all_reduce, nn_ops._CrossDeviceMean.backward = \
            self.saved[0], staticmethod(self.saved[1])
        return False


def _dp_num_net(ctx):
    """ResNet-50 v1 cut to 10 classes, Xavier from numpy seed 0, its
    shapes settled at 64x64."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import vision

    np.random.seed(0)
    net = vision.get_model("resnet50_v1", classes=DP_NUM["classes"],
                           prefix="resnet50_")
    net.initialize(mx.init.Xavier(), ctx=ctx)
    with mx.autograd.pause():
        net(mx.nd.zeros((2, 3, DP_NUM["image"], DP_NUM["image"]), ctx=ctx))
    return net


def _dp_num_check(tag, out, ref, ref_a):
    """The dp_numerics verdicts of one backend's ranks (``out``) against
    the one-device losses ``ref`` (and ``ref_a``, accumulating)."""
    r0, r1 = out
    res = {"update_err": {"rank%d_%s" % (r, n): max(rank[n]["update_err"])
                          for r, rank in enumerate(out) for n in rank},
           "aux_update_err": max(r0[n]["aux_update_err"] for n in
                                 ("bucketed", "bucketed_a2", "zero1_a2")),
           "loss_rel_err": max(abs(a - b) / abs(b) for rank in out
                               for n, want in (("bucketed", ref),
                                               ("bucketed_a2", ref_a),
                                               ("zero1_a2", ref_a))
                               for a, b in zip(rank[n]["losses"], want)),
           "bucketed_equals_monolithic":
               r0["bucketed"]["digests"] == r0["monolithic"]["digests"]
               and r0["bucketed"]["losses"] == r0["monolithic"]["losses"],
           "zero1_equals_replicated_at_lr0":
               r0["zero1_lr0"]["digests"] == r0["bucketed_lr0"]["digests"],
           "zero1_update_err": r0["zero1"]["vs_bucketed_update_err"],
           "ranks_equal": r0["bucketed"]["digests"] ==
               r1["bucketed"]["digests"],
           "paths": {k: (v["bucketed"], v["zero1"]) for k, v in r0.items()}}
    faults = {"grad_not_reduced": max(r1["grad_not_reduced"]["update_err"]),
              "sync_bn_backward_local":
                  max(r0["sync_bn_backward_local"]["update_err"])}
    res["fault_update_err"] = faults
    res["collectives_per_step"] = {n: v["collectives_per_step"]
                                   for n, v in r0.items()}
    good = [res["update_err"]["rank%d_%s" % (r, n)] for r in (0, 1)
            for n in ("bucketed", "monolithic", "zero1", "bucketed_a2",
                      "zero1_a2", "bucketed_stage")]
    if not (max(good) <= DP_NUM_TOL and res["aux_update_err"] <= DP_NUM_TOL
            and res["loss_rel_err"] <= DP_NUM_TOL):
        raise RuntimeError("%s: dp=2 is off the one-device float64 "
                           "trajectory: %r" % (tag, res))
    if not (res["bucketed_equals_monolithic"] and res["ranks_equal"]
            and res["zero1_equals_replicated_at_lr0"]
            and res["zero1_update_err"] <= DP_ZERO1_TOL):
        raise RuntimeError("%s: an exchange differs: %r" % (tag, res))
    if not min(faults.values()) > DP_NUM_TOL:
        raise RuntimeError("%s: the check cannot tell a planted fault "
                           "from the reference: %r" % (tag, faults))
    return res


def phase_dp_numerics():
    """Two float64 ResNet-50 ranks sharing cuda:0 over gloo against the
    one-device float64 step at the global batch (see DP_NUM); the same
    over NCCL on two cards where the machine has them."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import dist

    rng = np.random.RandomState(11)
    gb = DP_NUM["batch"] * 2
    data = rng.uniform(0, 1, (DP_NUM["steps"], gb, 3, DP_NUM["image"],
                              DP_NUM["image"]))
    label = rng.randint(0, DP_NUM["classes"],
                        (DP_NUM["steps"], gb)).astype(np.float64)
    runs = [("bucketed", {}, None), ("monolithic", {"bucket_bytes": 0}, None),
            ("zero1", {"zero_stage": 1}, None),
            ("bucketed_lr0", {"learning_rate": 0.0}, None),
            ("zero1_lr0", {"learning_rate": 0.0, "zero_stage": 1}, None),
            ("grad_not_reduced", {}, "grad_not_reduced"),
            ("sync_bn_backward_local", {}, "sync_bn_backward_local"),
            ("bucketed_a2", {"accum_steps": 2}, None),
            ("zero1_a2", {"accum_steps": 2, "zero_stage": 1}, None),
            ("bucketed_stage", {"remat": "stage"}, None)]
    order = _microbatch_order(gb, 2, 2)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        net = _dp_num_net(mx.gpu(0))
        w0 = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
        aux = sorted(k for k, p in net.collect_params().items()
                     if p.grad_req == "null")
        ref, ref_p = numerics_run(net, w0, data, label, "float64")
        ref_a, ref_ap = numerics_run(net, w0, data[:, order],
                                     label[:, order], "float64", accum=2)
        del net
    finally:
        torch.backends.cudnn.deterministic = det
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dpnum_")
    ref_path = str(Path(tmp) / "reference.npz")
    arrays = {"w0/" + k: v for k, v in w0.items()}
    for tag, traj in (("s", ref_p), ("a", ref_ap)):
        for i, p in enumerate(traj):
            arrays.update({"%s%d/%s" % (tag, i, k): v for k, v in p.items()})
    np.savez(ref_path, **arrays)
    try:
        # two launches of two ranks at once, each its half of the runs
        # (every comparison between runs stays within a half); a rank's
        # results are the union of its halves
        t0 = time.perf_counter()
        halves = side_by_side(*[
            lambda half=half: dist.launch(
                _dp_numerics_rank, 2, (ref_path, aux, data, label, half),
                backend="gloo", device="cuda:0", timeout_s=300)
            for half in (runs[:5], runs[5:])])
        out = [dict(a, **b) for a, b in zip(*halves)]
        gloo_s = time.perf_counter() - t0
        row = {"phase": "dp_numerics", "model": "resnet50_v1", "cut": DP_NUM,
               "global_batch": gb, "dtype": "float64",
               "reference": "one device on the card, float64, global batch",
               "reference_losses": ref.tolist(),
               "accum_reference_losses": ref_a.tolist(),
               "tol": DP_NUM_TOL, "zero1_tol": DP_ZERO1_TOL,
               "gloo_cuda0": _dp_num_check("dp_numerics", out, ref, ref_a),
               "gloo_s": gloo_s}
        if torch.cuda.device_count() >= 2:
            out = dist.launch(_dp_numerics_rank, 2,
                              (ref_path, aux, data, label, runs),
                              backend="nccl", timeout_s=300)
            row["nccl"] = _dp_num_check("dp_numerics (nccl)", out, ref,
                                        ref_a)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if torch.cuda.device_count() < 2:
        row["nccl"] = {"ran": False,
                       "why": "%d visible card: NCCL takes one rank a "
                              "card" % torch.cuda.device_count()}
    emit(row)
    return row


def _lm_dp_rank(ckdir):
    """One rank of ``train_lm_dp``: timed windows of the ZeRO-1 dp step,
    then fit 20 steps, and 10 steps with a checkpoint (every rank's
    shard under ``ckdir``) resumed to 20."""
    import torch.distributed as tdist

    from mxnet_tpu_torch.parallel.mesh import data_parallel_mesh
    from mxnet_tpu_torch.transformer import TransformerTrainStep

    _rank_setup()
    mesh = data_parallel_mesh()
    n = mesh.size
    cfg = lm_config()
    B, T = LM["batch"] * n, LM["seq"]

    def new_step(seed=0):
        return TransformerTrainStep(cfg, mesh=mesh, learning_rate=LM["lr"],
                                    momentum=LM["momentum"],
                                    remat=LM["remat"], seed=seed, **LM_DP)

    step = new_step()
    it = lm_iter(cfg, B, T, LM_SEQUENCES * n)
    step.bucket_plan_meta()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(LM_WARMUP):
        b = it.next()
        step.step(b.data[0], b.label[0])
    _reset_kernel_counts()
    windows, losses = [], []
    for _ in range(LM_WINDOWS):
        batches = [it.next() for _ in range(LM_WINDOW_STEPS)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = [step.step(b.data[0], b.label[0]) for b in batches]
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t0) / LM_WINDOW_STEPS * 1e3)
        losses += [float(x) for x in out]
    counts = _kernel_counts()
    peak = torch.cuda.max_memory_allocated()
    sharded = step.optimizer_state_bytes_per_rank()
    replicated = sum(v.numel() * v.element_size()
                     for v in step._params.values())
    zero1, plan = step.zero1, step.bucket_plan_meta()
    del step
    control = new_step()
    fit_losses = control.fit(lm_iter(cfg, B, T, LM_SEQUENCES * n),
                             LM_FIT_STEPS)
    want = control.params_numpy()
    del control
    first = new_step()
    first.fit(lm_iter(cfg, B, T, LM_SEQUENCES * n), LM_CKPT_STEP,
              checkpoint_every_n=LM_CKPT_STEP, checkpoint_dir=ckdir)
    del first
    # the step is complete once every rank's shard landed
    tdist.barrier()
    resumed = new_step(seed=1)
    resumed_losses = resumed.fit(lm_iter(cfg, B, T, LM_SEQUENCES * n),
                                 LM_FIT_STEPS, resume_from=ckdir)
    got = resumed.params_numpy()
    del resumed
    step_ms = statistics.median(windows)
    return {"ranks": n, "global_batch": B, "tokens_per_s": B * T / step_ms
            * 1e3, "tokens_per_s_per_rank": LM["batch"] * T / step_ms * 1e3,
            "step_ms": step_ms, "step_ms_windows": windows,
            "timed_losses": losses, "peak_mem_bytes": peak,
            "kernel_launches": counts,
            "steps_counted": LM_WINDOWS * LM_WINDOW_STEPS,
            "zero1": zero1, "n_buckets": plan["n_buckets"],
            "momenta_bytes_per_rank": sharded,
            "momenta_bytes_replicated": replicated,
            "fit_losses": fit_losses,
            "resume_losses_equal": resumed_losses == fit_losses[
                LM_CKPT_STEP:],
            "resume_params_differ": sorted(
                k for k in want if not np.array_equal(want[k], got[k]))}


def phase_train_lm_dp(lm_row):
    """The train_lm cell a rank, ZeRO-1, one rank per visible card over
    NCCL: tokens/s and the efficiency against ``train_lm``, momenta bytes
    a rank (sharded against replicated), flash launches by route (12
    forward and 12 backward a step on each rank, all wgmma), and a
    step-10 ZeRO-1 checkpoint resumed bitwise."""
    from mxnet_tpu_torch import dist

    n = torch.cuda.device_count()
    torch.cuda.empty_cache()
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_lmdp_")
    try:
        t0 = time.perf_counter()
        ranks = dist.launch(_lm_dp_rank, n, (ckdir,), backend="nccl",
                            timeout_s=300)
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    r0 = ranks[0]
    cfg = lm_config()
    row = {"phase": "train_lm_dp", "backend": "nccl", "ranks": n,
           "config": dict(GPT2_SMALL, dtype="bfloat16", param_dtype="float32"),
           "batch_per_rank": LM["batch"], "seq": LM["seq"], "zero_stage": 1,
           "train_lm_tokens_per_s": lm_row["tokens_per_s"],
           "dp_efficiency": r0["tokens_per_s"] / (n * lm_row["tokens_per_s"]),
           "per_rank": ranks, "wall_s": wall}
    emit(row)
    want = cfg.n_layers * r0["steps_counted"]
    for r, rank in enumerate(ranks):
        c = rank["kernel_launches"]
        if not (c["flash_attention_fwd_by_route"]["wgmma"] == want ==
                c["flash_attention_fwd"] and
                c["flash_attention_bwd_by_route"]["wgmma"] == want ==
                c["flash_attention_bwd"]):
            raise RuntimeError("train_lm_dp: rank %d launched %r in %d "
                               "steps (want %d forward and %d backward, "
                               "all wgmma)" % (r, c, rank["steps_counted"],
                                               want, want))
        if not (rank["zero1"] and rank["resume_losses_equal"]
                and not rank["resume_params_differ"]
                and np.isfinite(rank["timed_losses"]).all()):
            raise RuntimeError("train_lm_dp: rank %d: %r" % (r, {
                k: rank[k] for k in ("zero1", "resume_losses_equal",
                                     "resume_params_differ")}))
    return row


def _lm_dp_numerics_rank(w0, ckdir):
    """One rank of ``train_lm_dp_numerics`` (float32 on cuda:0): the
    replicated trajectory, the same with rank 1's gradient not reduced,
    and ZeRO-1 for 4 steps uninterrupted and for 2 with a checkpoint."""
    from mxnet_tpu_torch.parallel.mesh import data_parallel_mesh
    from mxnet_tpu_torch.transformer import TransformerTrainStep

    _rank_setup()
    mesh = data_parallel_mesh()
    cfg = lm_config(**LM_NUM, dtype="float32", param_dtype="float32")

    def run(steps, fault=None, ckpt=None, **kw):
        step = TransformerTrainStep(cfg, mesh=mesh, learning_rate=LM_NUM_LR,
                                    momentum=0.9, device="cuda", **kw)
        step.load_state({"params": w0})
        it = lm_iter(cfg, LM_NUM_BATCH, LM_NUM_SEQ, LM_DP_NUM_SEQS, seed=1)
        if ckpt is not None:
            step.fit(it, steps, checkpoint_every_n=steps,
                     checkpoint_dir=ckpt)
            return None
        losses, params = [], []
        with _DpFault(fault, mesh):
            for _ in range(steps):
                b = it.next()
                losses.append(float(step.step(b.data[0], b.label[0])))
                params.append({k: v.astype(np.float64)
                                for k, v in step.params_numpy().items()})
        return {"losses": losses, "params": params, "zero1": step.zero1}

    _reset_kernel_counts()
    out = {"replicated": run(LM_DP_NUM_STEPS, zero_stage=0)}
    out["kernel_launches"] = _kernel_counts()
    out["grad_not_reduced"] = run(LM_DP_NUM_STEPS, "grad_not_reduced",
                                  zero_stage=0)
    out["zero1"] = run(LM_DP_NUM_STEPS + 1, zero_stage=1)
    run(LM_DP_CKPT, ckpt=ckdir, zero_stage=1)
    return out


def phase_train_lm_dp_numerics():
    """train_lm_numerics's cut on two gloo ranks sharing cuda:0 (see
    LM_DP_NUM_*): the dp=2 trajectory against the CPU float64 one at the
    global batch, and a dp=2 ZeRO-1 checkpoint restaged to dp=1."""
    from mxnet_tpu_torch import checkpoint as ckpt
    from mxnet_tpu_torch import dist
    from mxnet_tpu_torch.transformer import TransformerTrainStep

    cfg32 = lm_config(**LM_NUM, dtype="float32", param_dtype="float32")
    cfg64 = lm_config(**LM_NUM, dtype="float64", param_dtype="float64")
    w0 = TransformerTrainStep(cfg32, device="cpu", seed=0).params_numpy()
    ref, ref_p = _lm_numerics_run(cfg64, "cpu", w0, LM_DP_NUM_STEPS,
                                  np.float64, sequences=LM_DP_NUM_SEQS)
    one, one_p = _lm_numerics_run(cfg32, "cuda", w0, LM_DP_NUM_STEPS,
                                  sequences=LM_DP_NUM_SEQS)
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_lmdpnum_")
    try:
        torch.cuda.empty_cache()
        out = dist.launch(_lm_dp_numerics_rank, 2, (w0, ckdir),
                          backend="gloo", device="cuda:0", timeout_s=300)
        r0 = out[0]
        # dp=2 -> dp=1 on the card: resume the step-2 checkpoint to step 4
        restaged = {}
        for tag, zero_moms in (("restage", False),
                               ("restage_momenta_zeroed", True)):
            s = TransformerTrainStep(cfg32, learning_rate=LM_NUM_LR,
                                     momentum=0.9, device="cuda",
                                     zero_stage=1)
            payload = ckpt.load_checkpoint(ckdir, rank=0, num_ranks=1)
            s.load_state(payload)
            if zero_moms:
                s._moms = {k: torch.zeros_like(v)
                           for k, v in s._moms.items()}
            it = lm_iter(cfg32, LM_NUM_BATCH, LM_NUM_SEQ, LM_DP_NUM_SEQS,
                         seed=1)
            it.skip_batches(ckpt.scale_resume_skip(
                payload, LM_NUM_BATCH))
            ws = s.params_numpy()
            ps = []
            for _ in range(LM_DP_NUM_STEPS + 1 - LM_DP_CKPT):
                b = it.next()
                s.step(b.data[0], b.label[0])
                ps.append({k: v.astype(np.float64)
                           for k, v in s.params_numpy().items()})
            restaged[tag] = max(_update_err(g, w, ws) for g, w in zip(
                ps, r0["zero1"]["params"][LM_DP_CKPT:]))
            restaged[tag + "_elastic"] = payload.get("elastic")
            restaged[tag + "_zero1"] = s.zero1
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    dp = np.array(r0["replicated"]["losses"])
    loss_err, upd_err = trajectory_errors(dp, r0["replicated"]["params"],
                                          ref, ref_p, w0)
    _, one_upd_err = trajectory_errors(one, one_p, ref, ref_p, w0)
    vs_one = [_update_err(g, w, w0) for g, w in
              zip(r0["replicated"]["params"], one_p)]
    faults = {"grad_not_reduced": float(max(
        trajectory_errors(np.array(out[1]["grad_not_reduced"]["losses"]),
                          out[1]["grad_not_reduced"]["params"], ref, ref_p,
                          w0)[1])),
        "restage_momenta_zeroed": restaged["restage_momenta_zeroed"]}
    counts = r0["kernel_launches"]
    want = cfg32.n_layers * LM_DP_NUM_STEPS
    row = {"phase": "train_lm_dp_numerics", "config": LM_NUM,
           "global_batch": LM_NUM_BATCH, "seq": LM_NUM_SEQ,
           "steps": LM_DP_NUM_STEPS, "dtype": "float32",
           "reference": "the port on the CPU, float64, global batch",
           "dp2_losses": dp.tolist(), "cpu_losses": ref.tolist(),
           "loss_rel_err": loss_err.tolist(), "loss_rtol": LM_NUM_LOSS_RTOL,
           "update_rel_err": upd_err.tolist(),
           "update_tol": LM_NUM_UPDATE_TOL,
           "one_device_card_update_rel_err": one_upd_err.tolist(),
           "dp2_vs_one_device_card_update_err": vs_one,
           "ranks_equal": r0["replicated"]["losses"] ==
               out[1]["replicated"]["losses"],
           "restage_dp2_to_dp1_update_err": restaged["restage"],
           "restage_elastic": restaged["restage_elastic"],
           "zero1": r0["zero1"]["zero1"],
           "fault_update_err": faults, "kernel_launches": counts}
    emit(row)
    if counts["flash_attention_fwd_by_route"]["simt"] != want or \
            counts["flash_attention_bwd_by_route"]["simt"] != want:
        raise RuntimeError("train_lm_dp_numerics: kernel launches %r, want "
                           "%d simt forward and backward a rank"
                           % (counts, want))
    if not (np.isfinite(dp).all() and (loss_err <= LM_NUM_LOSS_RTOL).all()
            and (upd_err <= LM_NUM_UPDATE_TOL).all()
            and row["ranks_equal"] and row["zero1"]
            and restaged["restage"] <= LM_NUM_UPDATE_TOL):
        raise RuntimeError("train_lm_dp_numerics: off the reference: %r"
                           % (row,))
    if not min(faults.values()) > LM_NUM_UPDATE_TOL:
        raise RuntimeError("train_lm_dp_numerics: the check cannot tell a "
                           "planted fault from the reference: %r"
                           % (faults,))
    return row


# ---------------------------------------------------------------------
# the memory tier: remat scopes, the mirror, gradient accumulation
# ---------------------------------------------------------------------
# remat: the train cell (ResNet-50 v1 bf16, batch 128, 224x224, SGD lr
# 0.05 momentum 0.9, one card) under each memory policy: one warm-up
# step, then REMAT_STEPS timed; the peak is torch.cuda's allocated
# bytes over the timed steps (reset after the warm-up)
REMAT_RUNS = (("none", "none", False), ("stage", "stage", False),
              ("conv_block", "conv_block", False), ("mirror", "none", True))
REMAT_BATCH, REMAT_STEPS = 128, 3
# memory_remat: bench.py:1325 bench_memory_remat / :1366 _memory_probe,
# ResNet-18 v1 at batch 16, 128x128, bf16, the mirror off and on
MEMORY_REMAT = dict(model="resnet18_v1", batch=16, image=128, steps=5)
# large_batch_remat: bench.py:1421 bench_large_batch_remat / :1455
# _large_batch_probe, ResNet-50 v1 at an effective batch of 128 in 4
# microbatches of 32, 224x224, bf16, MXNET_REMAT_POLICY=stage, beside
# its policy-none twin at the same accumulation
LARGE_BATCH_REMAT = dict(batch=128, accum=4, steps=3)
# remat_numerics: a marked conv net (2 stages of 2 units of conv, BN,
# relu, and a Dropout in stage 0's units; global-avg pool; dense) at
# batch 8, 32x32, 10 classes, float64, SGD lr 0.05 momentum 0.9, 2
# steps, cuDNN deterministic.  With the Dropout at p=0 (nothing drawn)
# each policy on the card agrees with the same policy on the CPU within
# REMAT_NUM_TOL of the update's size; with p=0.25 each policy on the
# card equals none on the card bit for bit, and two planted faults
# (the aux write-back run again in the recompute, the generator not
# replayed) read above the limit; the symbolic executor's stage fit
# equals its none fit bit for bit; two gloo ranks on cuda:0 at stage +
# accum 2 agree with one device accumulating the same microbatches
# within the limit, and the bucket hooks armed on every microbatch read
# above it
REMAT_NUM = dict(batch=8, image=32, classes=10, steps=2, lr=0.05, drop=0.25)
REMAT_NUM_TOL = 1e-10
REMAT_NUM_CONFIGS = (("stage", "stage", False, None),
                     ("conv_block", "conv_block", False, None),
                     ("mirror", "none", True, None),
                     ("accum2", "none", False, 2),
                     ("stage_accum2", "stage", False, 2))


@contextlib.contextmanager
def remat_knobs(policy="none", mirror=False):
    """``MXNET_REMAT_POLICY`` / ``MXNET_BACKWARD_DO_MIRROR`` for a run."""
    knobs = {"MXNET_REMAT_POLICY": policy,
             "MXNET_BACKWARD_DO_MIRROR": "1" if mirror else "0"}
    old = {k: os.environ.get(k) for k in knobs}
    os.environ.update(knobs)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _memory_cell(net, w0, data, label, policy, mirror, steps, accum=None):
    """One bf16 ``FusedTrainStep`` run of ``net`` from ``w0`` under a
    memory policy: a warm-up step, then ``steps`` timed steps and their
    peak allocated bytes."""
    import gc

    from mxnet_tpu_torch import convert, gluon
    from mxnet_tpu_torch.parallel.dp import FusedTrainStep

    net.cast("float32")
    convert.load_block_params(net, w0)
    with remat_knobs(policy, mirror):
        step = FusedTrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                              learning_rate=TRAIN_LR,
                              momentum=TRAIN_MOMENTUM, dtype="bfloat16",
                              accum_steps=accum)
        first = float(step.run_steps(data, label, steps=1).asnumpy()[0])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        losses = step.run_steps(data, label, steps=steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        losses = losses.asnumpy()
    del step
    gc.collect()
    batch = int(data.shape[0])
    step_s = wall / steps
    return {"policy": policy, "mirror": mirror, "accum_steps": accum or 1,
            "step_ms": step_s * 1e3, "images_per_s": batch / step_s,
            "peak_bytes": int(peak), "first_loss": first,
            "last_loss": float(losses[-1]),
            "tflops": train_tflops(batch, step_s)}


def _memory_verdicts(runs, base="none"):
    """Each run's memory ratio (the base's peak over its own) and
    slowdown (1 - its images/s over the base's), bench.py's formulas."""
    ref = runs[base]
    return {name: {"memory_ratio": ref["peak_bytes"] / r["peak_bytes"],
                   "slowdown": 1.0 - r["images_per_s"] /
                   ref["images_per_s"]}
            for name, r in runs.items() if name != base}


def _check_memory(tag, runs, verdicts, lower=True):
    """Every loss finite and, with ``lower``, every policy's peak below
    the base's."""
    bad = [n for n, r in runs.items()
           if not (np.isfinite(r["first_loss"])
                   and np.isfinite(r["last_loss"]))]
    if bad:
        raise RuntimeError("%s: a loss is not finite: %r" % (tag, bad))
    flat = [n for n, v in verdicts.items() if not v["memory_ratio"] > 1.0]
    if lower and flat:
        raise RuntimeError("%s: %s does not lower the peak below the "
                           "base: %r" % (tag, flat, runs))


def phase_remat():
    """The train cell under ``none``, ``stage``, ``conv_block`` and the
    mirror: step ms, images/s, peak bytes, memory ratio and slowdown
    against none.  Fails unless each policy lowers the peak below
    none's."""
    import mxnet_tpu_torch as mx

    ctx = mx.gpu(0)
    net = resnet50(ctx)
    w0 = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    data, label = train_batch(REMAT_BATCH, ctx)
    runs = {}
    _reset_kernel_counts()
    t0 = time.perf_counter()
    for name, policy, mirror in REMAT_RUNS:
        runs[name] = _memory_cell(net, w0, data, label, policy, mirror,
                                  REMAT_STEPS)
    wall = time.perf_counter() - t0
    verdicts = _memory_verdicts(runs)
    row = {"phase": "remat", "model": "resnet50_v1", "batch": REMAT_BATCH,
           "image": 224, "dtype": "bfloat16", "steps": REMAT_STEPS,
           "peak": "torch.cuda.max_memory_allocated over steps 2+",
           "runs": runs, "verdicts": verdicts,
           "kernel_launches": _kernel_counts(), "wall_s": wall}
    emit(row)
    _check_memory("remat", runs, verdicts)
    return row, (net, w0, data, label)


def phase_memory_remat():
    """bench_memory_remat's row: ResNet-18 v1 at batch 16, 128x128,
    bf16, the mirror off and on."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import vision

    cfg = MEMORY_REMAT
    ctx = mx.gpu(0)
    np.random.seed(0)
    net = vision.get_model(cfg["model"], classes=1000)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    with mx.autograd.pause():
        net(mx.nd.zeros((2, 3, cfg["image"], cfg["image"]), ctx=ctx))
    w0 = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    mx.random.seed(0)
    data = mx.nd.random.uniform(
        shape=(cfg["batch"], 3, cfg["image"], cfg["image"]), ctx=ctx)
    label = mx.nd.array(np.random.RandomState(0).randint(
        0, 1000, cfg["batch"]).astype("float32"), ctx=ctx)
    _reset_kernel_counts()
    runs = {"mirror_off": _memory_cell(net, w0, data, label, "none", False,
                                       cfg["steps"]),
            "mirror_on": _memory_cell(net, w0, data, label, "none", True,
                                      cfg["steps"])}
    verdicts = _memory_verdicts(runs, "mirror_off")
    row = {"phase": "memory_remat", "reference": "bench.py:1325",
           "cfg": cfg, "dtype": "bfloat16", "runs": runs,
           "memory_ratio": verdicts["mirror_on"]["memory_ratio"],
           "slowdown": verdicts["mirror_on"]["slowdown"],
           "kernel_launches": _kernel_counts()}
    emit(row)
    # reported, not held: at this size the peak is not the activations'
    # (PERF.md, PR 11)
    _check_memory("memory_remat", runs, verdicts, lower=False)
    return row


def phase_large_batch_remat(cell, train_row):
    """bench_large_batch_remat's row: the train cell's net at an
    effective batch of 128 in 4 microbatches, ``stage`` beside its
    ``none`` twin at the same accumulation."""
    net, w0, data, label = cell
    cfg = LARGE_BATCH_REMAT
    _reset_kernel_counts()
    runs = {"none": _memory_cell(net, w0, data, label, "none", False,
                                 cfg["steps"], accum=cfg["accum"]),
            "stage": _memory_cell(net, w0, data, label, "stage", False,
                                  cfg["steps"], accum=cfg["accum"])}
    verdicts = _memory_verdicts(runs)
    b128 = next(r for r in train_row["runs"] if r["batch"] == 128)
    st = runs["stage"]
    row = {"phase": "large_batch_remat", "reference": "bench.py:1421",
           "model": "resnet50_v1", "effective_batch": cfg["batch"],
           "grad_accum_steps": cfg["accum"],
           "microbatch": cfg["batch"] // cfg["accum"], "image": 224,
           "dtype": "bfloat16", "remat_policy": "stage",
           "images_per_s": st["images_per_s"], "tflops": st["tflops"],
           "tflops_basis": "24.54 GFLOP an image (3 x 2 x 4.09 G "
                           "multiply-adds)",
           "peak_bytes": st["peak_bytes"],
           "none_twin_peak_bytes": runs["none"]["peak_bytes"],
           "memory_ratio": verdicts["stage"]["memory_ratio"],
           "slowdown_vs_twin": verdicts["stage"]["slowdown"],
           "vs_train_b128_images_per_s":
               st["images_per_s"] / b128["images_per_s"],
           "runs": runs, "kernel_launches": _kernel_counts()}
    emit(row)
    _check_memory("large_batch_remat", runs, verdicts)
    return row


def remat_num_net(ctx, drop, prefix="rn_"):
    """remat_numerics's marked net on ``ctx``, Xavier from numpy seed 0,
    its shapes settled (float32 cells)."""
    import mxnet_tpu_torch as mx

    nn = mx.gluon.nn

    def unit(f, p):
        u = nn.HybridSequential()
        with u.name_scope():
            u.add(nn.Conv2D(f, 3, padding=1, use_bias=False),
                  nn.BatchNorm(), nn.Activation("relu"))
            if p:
                u.add(nn.Dropout(p))
        u._remat_scope = "conv_block"
        return u

    def stage(f, p):
        s = nn.HybridSequential()
        with s.name_scope():
            s.add(unit(f, p), unit(f, p))
        s._remat_scope = "stage"
        return s

    np.random.seed(0)
    net = nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(stage(16, drop), stage(32, 0.0), nn.GlobalAvgPool2D(),
                nn.Dense(REMAT_NUM["classes"]))
    net.initialize(mx.init.Xavier(), ctx=ctx)
    with mx.autograd.pause():
        net(mx.nd.zeros((2, 3, REMAT_NUM["image"], REMAT_NUM["image"]),
                        ctx=ctx))
    return net


def remat_num_run(ctx, w0, data, label, policy, mirror, accum=None,
                  drop=0.0, mesh=None):
    """REMAT_NUM steps of the marked net in float64 from ``w0`` under a
    memory policy; the losses, and the parameters (aux included) after
    each step.  ``data`` / ``label`` carry a leading step dim."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import convert, gluon
    from mxnet_tpu_torch.parallel.dp import FusedTrainStep

    net = remat_num_net(ctx, drop)
    convert.load_block_params(net, w0)
    losses, params = [], []
    with remat_knobs(policy, mirror):
        step = FusedTrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                              mesh=mesh, learning_rate=REMAT_NUM["lr"],
                              momentum=TRAIN_MOMENTUM, dtype="float64",
                              accum_steps=accum, bucket_bytes=1 << 14)
        mx.random.seed(7)
        for k in range(len(data)):
            losses.append(float(step.run_steps(
                mx.nd.array(data[k:k + 1], ctx=ctx),
                mx.nd.array(label[k:k + 1], ctx=ctx)).asnumpy()[0]))
            params.append({n: p.data().asnumpy()
                           for n, p in net.collect_params().items()})
    return np.array(losses), params


def _traj_err(got, ref, w0):
    """The largest update error of a trajectory against another, and the
    largest relative loss error."""
    (gl, gp), (rl, rp) = got, ref
    return (max(_update_err(g, r, w0) for g, r in zip(gp, rp)),
            float(np.max(np.abs(gl - rl) / np.abs(rl))))


def _same_traj(a, b) -> bool:
    return a[0].tolist() == b[0].tolist() and \
        [_digest(p) for p in a[1]] == [_digest(p) for p in b[1]]


def _remat_num_symbol(drop):
    """A stage-named conv symbol with a BatchNorm and a Dropout inside
    stage 1 (the executor segments it by the ``stageN_`` names)."""
    import mxnet_tpu_torch as mx

    with mx.name.NameManager():
        x = mx.sym.Variable("data")
        x = mx.sym.Activation(mx.sym.Convolution(
            x, num_filter=8, kernel=(3, 3), pad=(1, 1), name="stem_conv"),
            act_type="relu")
        for s in (1, 2):
            x = mx.sym.Convolution(x, num_filter=8, kernel=(3, 3),
                                   pad=(1, 1), name="stage%d_unit1_conv1" % s)
            x = mx.sym.BatchNorm(x, fix_gamma=False,
                                 name="stage%d_unit1_bn1" % s)
            x = mx.sym.Activation(x, act_type="relu",
                                  name="stage%d_unit1_relu1" % s)
            if s == 1:
                x = mx.sym.Dropout(x, p=drop, name="stage1_unit1_drop1")
        x = mx.sym.FullyConnected(mx.sym.Flatten(x),
                                  num_hidden=REMAT_NUM["classes"],
                                  name="head_fc")
        return mx.sym.SoftmaxOutput(x, name="softmax")


def _remat_num_fit(policy, X, y, start):
    """One epoch of ``Module.fit`` of the stage symbol on the card in
    float64 from ``start`` under ``policy``: the parameters (aux
    included) and whether the executor ran stage segments."""
    import mxnet_tpu_torch as mx

    with remat_knobs(policy):
        it = mx.io.NDArrayIter(X, y, batch_size=REMAT_NUM["batch"],
                               label_name="softmax_label")
        mod = mx.mod.Module(_remat_num_symbol(REMAT_NUM["drop"]),
                            context=mx.gpu(0))
        mod.bind(it.provide_data, it.provide_label)
        _cast_module(mod, torch.float64)
        mod.init_params(arg_params=start[0], aux_params=start[1])
        mx.random.seed(7)
        mod.fit(it, num_epoch=1, optimizer="sgd",
                optimizer_params=(("learning_rate", REMAT_NUM["lr"]),
                                  ("momentum", TRAIN_MOMENTUM)))
    a, x = mod.get_params()
    return ({k: v.asnumpy() for k, v in list(a.items()) + list(x.items())},
            mod._exec._eval.remat_plan is not None)


def _microbatch_order(b, n, a):
    """The global rows in the order one device must see them for its
    k-th microbatch to be the dp ranks' k-th microbatches together."""
    per, mb = b // n, b // n // a
    return [r * per + k * mb + i for k in range(a) for r in range(n)
            for i in range(mb)]


def _remat_num_dp_rank(w0, data, label):
    """One gloo rank of remat_numerics's dp part: stage + accum 2, and
    the same with the bucket hooks armed on every microbatch."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import dist
    from mxnet_tpu_torch.parallel.dp import FusedTrainStep
    from mxnet_tpu_torch.parallel.mesh import data_parallel_mesh

    _rank_setup()
    torch.backends.cudnn.deterministic = True
    mesh = data_parallel_mesh()
    ctx = mx.gpu(dist.device().index)
    good = remat_num_run(ctx, w0, data, label, "stage", False, accum=2,
                         mesh=mesh)
    arms = FusedTrainStep._arms
    FusedTrainStep._arms = lambda self, k: True
    try:
        bad = remat_num_run(ctx, w0, data, label, "stage", False, accum=2,
                            mesh=mesh)
    finally:
        FusedTrainStep._arms = arms
    return {"good": (good[0], good[1]), "armed_every_microbatch":
            (bad[0], bad[1])}


def phase_remat_numerics():
    """The memory tier's numbers on the card against the CPU and against
    none (see REMAT_NUM)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import dist, remat
    from mxnet_tpu_torch import random as mx_random

    cfg = REMAT_NUM
    rng = np.random.RandomState(5)
    data = rng.uniform(-1, 1, (cfg["steps"], cfg["batch"], 3, cfg["image"],
                               cfg["image"]))
    label = rng.randint(0, cfg["classes"],
                        (cfg["steps"], cfg["batch"])).astype(np.float64)
    gpu, cpu = mx.gpu(0), mx.cpu()
    w0 = {k: p.data().asnumpy()
          for k, p in remat_num_net(cpu, cfg["drop"]).collect_params()
          .items()}
    aux = sorted(k for k in w0 if "running" in k)
    t0 = time.perf_counter()
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    _reset_kernel_counts()
    try:
        # p=0: each policy on the card against the same on the CPU
        vs_cpu = {}
        for name, policy, mirror, accum in REMAT_NUM_CONFIGS:
            card = remat_num_run(gpu, w0, data, label, policy, mirror, accum)
            ref = remat_num_run(cpu, w0, data, label, policy, mirror, accum)
            vs_cpu[name] = _traj_err(card, ref, w0)
        # p=0.25: each policy on the card against none on the card
        drop = cfg["drop"]
        none = remat_num_run(gpu, w0, data, label, "none", False, None, drop)
        none2 = remat_num_run(gpu, w0, data, label, "none", False, None,
                              drop)
        none_a2 = remat_num_run(gpu, w0, data, label, "none", False, 2, drop)
        vs_none = {"none_rerun": _same_traj(none2, none)}
        for name, policy, mirror, accum in REMAT_NUM_CONFIGS:
            if name == "accum2":
                continue
            got = remat_num_run(gpu, w0, data, label, policy, mirror, accum,
                                drop)
            vs_none[name] = _same_traj(got, none_a2 if accum else none)
        # the planted faults, on stage with the Dropout
        faults = {}
        real = remat.recomputing
        remat.recomputing = lambda: False
        try:
            bad = remat_num_run(gpu, w0, data, label, "stage", False, None,
                                drop)
        finally:
            remat.recomputing = real
        faults["aux_written_twice"] = _update_err(
            {k: bad[1][-1][k] for k in aux},
            {k: none[1][-1][k] for k in aux}, {k: w0[k] for k in aux})
        real = mx_random.set_state
        mx_random.set_state = lambda state: None
        try:
            bad = remat_num_run(gpu, w0, data, label, "stage", False, None,
                                drop)
        finally:
            mx_random.set_state = real
        faults["mask_redrawn"] = _traj_err(bad, none, w0)[0]
        # the executor: Module.fit under stage against none, on the card
        X = rng.uniform(-1, 1, (4 * cfg["batch"], 3, cfg["image"],
                                cfg["image"]))
        y = rng.randint(0, cfg["classes"], 4 * cfg["batch"]).astype(
            np.float64)
        start = mx.mod.Module(_remat_num_symbol(cfg["drop"]), context=cpu)
        start.bind([("data", (cfg["batch"], 3, cfg["image"], cfg["image"]))],
                   [("softmax_label", (cfg["batch"],))])
        _cast_module(start, torch.float64)
        np.random.seed(0)
        start.init_params(mx.init.Xavier())
        start = start.get_params()
        fit_none, _ = _remat_num_fit("none", X, y, start)
        fit_stage, segmented = _remat_num_fit("stage", X, y, start)
        executor_equal = _digest(fit_none) == _digest(fit_stage)
    finally:
        torch.backends.cudnn.deterministic = det
    counts = _kernel_counts()
    # the dp part: two gloo ranks on cuda:0 against one device over the
    # same microbatches
    order = _microbatch_order(cfg["batch"], 2, 2)
    torch.backends.cudnn.deterministic = True
    try:
        one = remat_num_run(gpu, w0, data[:, order], label[:, order],
                            "stage", False, 2)
    finally:
        torch.backends.cudnn.deterministic = det
    ranks = dist.launch(_remat_num_dp_rank, 2, (w0, data, label),
                        backend="gloo", device="cuda:0", timeout_s=300)
    dp = {"rank%d" % r: _traj_err(out["good"], one, w0)
          for r, out in enumerate(ranks)}
    faults["armed_every_microbatch"] = max(
        _traj_err(out["armed_every_microbatch"], one, w0)[0]
        for out in ranks)
    wall = time.perf_counter() - t0
    row = {"phase": "remat_numerics", "cfg": cfg, "dtype": "float64",
           "tol": REMAT_NUM_TOL, "cudnn_deterministic": True,
           "card_vs_cpu": {k: {"update_err": v[0], "loss_rel_err": v[1]}
                           for k, v in vs_cpu.items()},
           "card_vs_card_none_bitwise": vs_none,
           "executor_stage_fit_equals_none": executor_equal,
           "executor_segmented": segmented,
           "dp_stage_accum2_vs_one_device": {
               k: {"update_err": v[0], "loss_rel_err": v[1]}
               for k, v in dp.items()},
           "fault_update_err": faults, "kernel_launches": counts,
           "wall_s": wall}
    emit(row)
    errs = [v for pair in list(vs_cpu.values()) + list(dp.values())
            for v in pair]
    if not max(errs) <= REMAT_NUM_TOL:
        raise RuntimeError("remat_numerics: a policy on the card is off "
                           "the reference: %r" % (row,))
    if not (all(vs_none.values()) and executor_equal and segmented):
        raise RuntimeError("remat_numerics: a policy on the card differs "
                           "from none: %r" % (vs_none,))
    if not min(faults.values()) > REMAT_NUM_TOL:
        raise RuntimeError("remat_numerics: the check cannot tell a "
                           "planted fault from the reference: %r"
                           % (faults,))
    return row


# ---------------------------------------------------------------------
# sequence parallelism (ring and Ulysses over an sp axis) and the
# multi-context Module
# ---------------------------------------------------------------------
# train_lm_sp: the train_lm width (GPT-2-small, bf16 over float32
# parameters, SGD lr 0.01 momentum 0.9) at a global batch of 2 x 8192
# tokens, sequence-parallel over sp=2: two gloo ranks sharing cuda:0
# (NCCL takes one rank a card), each 2 rows x 4096 positions; ring, then
# Ulysses: LM_SP["warmup"] steps, then LM_SP["steps"] timed; the first
# loss (the mean over the ranks) within BF16_LOSS_RTOL of the one-device
# step's at the same global batch and parameters
LM_SP = dict(batch=2, seq=8192, sp=2, warmup=1, steps=2)
# after the timed steps each rank runs ring and Ulysses attention once at
# the path's shapes (bf16, (B, T/sp, H, D) = (2, 4096, 12, 64) a rank,
# causal: rank 1's ring holds a block without a mask and the diagonal)
# with a gradient, and holds its slices against the plain versions on
# the full sequence in float32: the output within SP_ATTN_FWD_RTOL of
# each head's largest value, dq/dk/dv within BWD_HEAD_RTOL of the plain
# backward from the gathered output and within BWD_AUTOGRAD_RTOL of the
# float32 one throughout
SP_ATTN_FWD_RTOL = 2e-2
# train_lm_sp_numerics: train_lm_numerics's cut (float32, both kernels on
# the simt route), ring and Ulysses at sp=2 (2 gloo ranks) and dp=2 x
# sp=2 (4 gloo ranks), all on cuda:0, against the port on the CPU in
# float64 at the global batch (the LM_NUM_* limits); ZeRO-1 with sp
# against replicated bit for bit at lr 0; a dp=2 x sp=2 ZeRO-1
# checkpoint at step LM_SP_NUM_CKPT continued at dp=1 (one device) within
# LM_NUM_UPDATE_TOL of the uninterrupted dp=2 x sp=2 run; three faults
# planted in the ring at sp=2, each read above the update limit
LM_SP_NUM_STEPS, LM_SP_NUM_CKPT = 3, 2
LM_SP_NUM_SEQS = LM_NUM_BATCH * (LM_SP_NUM_STEPS + 1)
RING_FAULTS = ("diagonal_unmasked", "merge_dropped", "dkv_not_home")
# module_dp_numerics: fit_numerics's cut (symbolic ResNet-50 v1, 64x64,
# 10 classes, float64) at batch 4 a rank: Module(context=[gpu(0),
# gpu(1)]) on two gloo ranks sharing cuda:0 against the one-device
# Module at the global batch of 8 (FIT_NUM_TOL of the update, aux
# included; under kvstore local, tpu and nccl), the list collapsed in one
# process against one device bit for bit, rank 1's gradient left
# unreduced read above the limit; group2ctx placement of a two-group
# MLP (one group on the host, one on the card) against the unplaced run
MODULE_DP = dict(batch=4, ranks=2, steps=2, mlp_batch=8, mlp_steps=4)


@contextlib.contextmanager
def _ring_fault(name):
    """Plant one fault of RING_FAULTS in ``parallel.ring_attention`` for
    the run inside (None: none): the diagonal step without its causal
    mask, the merge dropped (the last partial wins), or the dk/dv
    accumulators not brought home (each rank keeps the ones it holds
    after the last step; the rotation still runs, so ranks stay in
    step)."""
    from mxnet_tpu_torch.parallel import ring_attention as ra

    names = ("flash_attention_fwd", "flash_attention_bwd",
             "merge_partials", "_ring_backward")
    saved = {k: getattr(ra, k) for k in names}
    if name == "diagonal_unmasked":
        fwd, bwd = saved["flash_attention_fwd"], saved["flash_attention_bwd"]
        ra.flash_attention_fwd = \
            lambda *a, causal=False, **kw: fwd(*a, causal=False, **kw)
        ra.flash_attention_bwd = \
            lambda *a, causal=False, **kw: bwd(*a, causal=False, **kw)
    elif name == "merge_dropped":
        ra.merge_partials = lambda o1, l1, o2, l2: (o2.float(), l2.float())
    elif name == "dkv_not_home":
        bwd = saved["_ring_backward"]
        ra._ring_backward = lambda *a, **kw: bwd(*a, _home=False, **kw)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(ra, k, v)


def _sp_attention_check(mesh, impl, device=None, dtype=torch.bfloat16):
    """This rank's ``impl`` ("ring" or "ulysses") attention at the
    train_lm_sp shapes against the plain versions on the full sequence
    (see SP_ATTN_FWD_RTOL): the errors of the output and of dq, dk and
    dv in this rank's slice, each scaled by its head's largest value.
    ``device`` defaults to the rank's card."""
    from mxnet_tpu_torch.parallel.attention import (
        flash_attention, flash_attention_bwd_reference)
    from mxnet_tpu_torch.parallel.ring_attention import ring_attention
    from mxnet_tpu_torch.parallel.sequence import ulysses_attention
    import torch.distributed as dist

    cfg = lm_config()
    B, T, H = LM_SP["batch"], LM_SP["seq"], cfg.n_heads
    D = cfg.d_model // H
    n, i = mesh.axis_size("sp"), mesh.axis_index("sp")
    t, dt = T // n, dtype
    dev = device or torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator().manual_seed(7)
    qkv = torch.randn((B, T, 3 * H * D), generator=g).to(dev, dt)
    do = torch.randn((B, T, H, D), generator=g).to(dev, dt)
    sl = slice(i * t, (i + 1) * t)
    # the model's layout: q and k leave the rotary embedding contiguous,
    # v is a strided view of the fused projection
    q, k, v = (x.reshape(B, t, H, D) for x in
               torch.split(qkv[:, sl], H * D, dim=-1))
    q, k = q.contiguous(), k.contiguous()
    for x in (q, k, v):
        x.requires_grad_(True)
    fn = ring_attention if impl == "ring" else ulysses_attention
    o = fn(q, k, v, mesh, "sp", causal=True)
    got = torch.autograd.grad(o, (q, k, v), do[:, sl])
    o = o.detach()
    # the full output: every rank's slice, through the host on gloo
    group = mesh.axis_group("sp")
    host = dist.get_backend(group) == "gloo"
    mine = o.cpu() if host else o
    parts = [torch.empty_like(mine) for _ in range(n)]
    dist.all_gather(parts, mine, group=group)
    o_all = torch.cat(parts, dim=1).to(dev).float()
    full = [x.reshape(B, T, H, D).float()
            for x in torch.split(qkv, H * D, dim=-1)]
    ref_o, ref_lse = flash_attention(*full, causal=True, return_lse=True)
    dof = do.float()
    own = flash_attention_bwd_reference(*full, o_all, ref_lse, dof,
                                        causal=True)
    f32 = flash_attention_bwd_reference(*full, ref_o, ref_lse, dof,
                                        causal=True)
    names = ("dq", "dk", "dv")
    out = {"o": head_scaled_err(o, ref_o[:, sl]),
           "grads_from_its_output": {m: head_scaled_err(a, b[:, sl])
                                     for m, a, b in zip(names, got, own)},
           "grads_float32": {m: head_scaled_err(a, b[:, sl])
                             for m, a, b in zip(names, got, f32)},
           "finite": bool(torch.isfinite(o).all()) and all(
               bool(torch.isfinite(x).all()) for x in got)}
    del qkv, do, q, k, v, o, got, o_all, full, ref_o, ref_lse, own, f32
    torch.cuda.empty_cache()
    return out


def _lm_sp_rank():
    """One rank of ``train_lm_sp``: ring, then Ulysses, over a (1, sp)
    mesh; per impl the first loss, step ms, peak memory and the flash
    launches of the timed steps."""
    from mxnet_tpu_torch.parallel.mesh import make_mesh
    from mxnet_tpu_torch.transformer import TransformerTrainStep

    _rank_setup()
    mesh = make_mesh((1, LM_SP["sp"]), ("dp", "sp"))
    cfg = lm_config()
    B, T = LM_SP["batch"], LM_SP["seq"]
    n_steps = LM_SP["warmup"] + LM_SP["steps"]
    out = {"rank": mesh.rank, "sp_index": mesh.axis_index("sp")}
    for impl in ("ring", "ulysses"):
        step = TransformerTrainStep(cfg, mesh=mesh, attn_impl=impl,
                                    learning_rate=LM["lr"],
                                    momentum=LM["momentum"],
                                    remat=LM["remat"], seed=0)
        it = lm_iter(cfg, B, T, B * n_steps)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, times = [], []
        for i in range(n_steps):
            if i == LM_SP["warmup"]:
                _reset_kernel_counts()
            b = it.next()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(step.step(b.data[0], b.label[0])))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        timed = times[LM_SP["warmup"]:]
        out[impl] = {"losses": losses, "step_ms": statistics.median(timed),
                     "step_ms_each": timed,
                     "tokens_per_s": B * T / statistics.median(timed) * 1e3,
                     "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                     "kernel_launches": _kernel_counts(),
                     "steps_counted": LM_SP["steps"]}
        del step
        torch.cuda.empty_cache()
        # after the counts are read: these launches are not the path's
        out[impl]["attention_check"] = _sp_attention_check(mesh, impl)
    return out


def _check_launches(tag, counts, want, route):
    """Raise unless ``counts`` (``_kernel_counts``) hold ``want`` launches
    of each flash kernel, every one on ``route``."""
    for k in ("flash_attention_fwd", "flash_attention_bwd"):
        if not counts[k] == want == counts[k + "_by_route"][route]:
            raise RuntimeError("%s: launched %r (want %d forward and %d "
                               "backward, all %s)"
                               % (tag, counts, want, want, route))


def _lm_sp_check(tag, ranks, cfg, ref_loss):
    """Raise unless every rank launched both flash kernels on every
    visible ring step and every Ulysses layer (all wgmma), its attention
    check is within its limits (SP_ATTN_FWD_RTOL), and the first loss is
    within BF16_LOSS_RTOL of the one-device step's."""
    L = cfg.n_layers
    errs = {}
    for rank in ranks:
        i = rank["sp_index"]
        for impl, per_layer in (("ring", i + 1), ("ulysses", 1)):
            r = rank[impl]
            a = r["attention_check"]
            if not (a["finite"] and a["o"] <= SP_ATTN_FWD_RTOL
                    and max(a["grads_from_its_output"].values())
                    <= BWD_HEAD_RTOL[torch.bfloat16]
                    and max(a["grads_float32"].values())
                    <= BWD_AUTOGRAD_RTOL[torch.bfloat16]):
                raise RuntimeError(
                    "%s: rank %d %s attention off the plain version on "
                    "the full sequence: %r (limits %g output, %g and %g "
                    "gradients)" % (tag, rank["rank"], impl, a,
                                    SP_ATTN_FWD_RTOL,
                                    BWD_HEAD_RTOL[torch.bfloat16],
                                    BWD_AUTOGRAD_RTOL[torch.bfloat16]))
            _check_launches("%s: rank %d %s, %d steps"
                            % (tag, rank["rank"], impl, r["steps_counted"]),
                            r["kernel_launches"],
                            per_layer * L * r["steps_counted"], "wgmma")
            if not np.isfinite(r["losses"]).all():
                raise RuntimeError("%s: rank %d %s losses %r"
                                   % (tag, rank["rank"], impl, r["losses"]))
            errs[impl] = abs(r["losses"][0] - ref_loss) / abs(ref_loss)
    if not max(errs.values()) <= BF16_LOSS_RTOL:
        raise RuntimeError("%s: first loss off the one-device step's %r by "
                           "%r (limit %g)" % (tag, ref_loss, errs,
                                              BF16_LOSS_RTOL))
    return errs


def _sp_summary(ranks):
    """The train_lm_sp numbers of each impl: rank 0's step ms and
    tokens/s, every rank's peak memory and flash launches a step."""
    out = {}
    for impl in ("ring", "ulysses"):
        r0 = ranks[0][impl]
        out[impl] = {
            "tokens_per_s": r0["tokens_per_s"], "step_ms": r0["step_ms"],
            "step_ms_each": r0["step_ms_each"],
            "first_loss": r0["losses"][0],
            "peak_mem_bytes_per_rank": [r[impl]["peak_mem_bytes"]
                                        for r in ranks],
            "launches_per_step_per_rank": [
                {k: r[impl]["kernel_launches"][k + "_by_route"]["wgmma"]
                 / r[impl]["steps_counted"]
                 for k in ("flash_attention_fwd", "flash_attention_bwd")}
                for r in ranks],
            "attention_check_per_rank": [r[impl]["attention_check"]
                                         for r in ranks]}
    return out


def phase_train_lm_sp():
    """The train_lm width sequence-parallel at sp=2 (see LM_SP): two gloo
    ranks sharing cuda:0, ring then Ulysses, against the one-device
    step's first loss; the same over NCCL where there are two cards."""
    from mxnet_tpu_torch import dist
    from mxnet_tpu_torch.transformer import TransformerTrainStep

    cfg = lm_config()
    B, T = LM_SP["batch"], LM_SP["seq"]
    one = TransformerTrainStep(cfg, learning_rate=LM["lr"],
                               momentum=LM["momentum"], remat=LM["remat"],
                               seed=0)
    # the ranks' first batch: the same corpus (its draws depend on the
    # number of sequences)
    b = lm_iter(cfg, B, T, B * (LM_SP["warmup"] + LM_SP["steps"])).next()
    ref_loss = float(one.step(b.data[0], b.label[0]))
    del one
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = dist.launch(_lm_sp_rank, LM_SP["sp"], (), backend="gloo",
                        device="cuda:0", timeout_s=400)
    wall = time.perf_counter() - t0
    row = {"phase": "train_lm_sp",
           "config": dict(GPT2_SMALL, dtype="bfloat16",
                          param_dtype="float32"),
           "global_batch": B, "seq": T, "sp": LM_SP["sp"],
           "tokens_per_rank": B * T // LM_SP["sp"],
           "backend": "gloo, %d ranks sharing cuda:0 (K/V, the all-to-alls "
                      "and the gradients cross through host buffers)"
                      % LM_SP["sp"],
           "one_device_first_loss": ref_loss,
           "per_impl": _sp_summary(ranks),
           "first_loss_rel_err": _lm_sp_check("train_lm_sp", ranks, cfg,
                                              ref_loss),
           "wall_s": wall}
    emit(row)
    if torch.cuda.device_count() >= LM_SP["sp"]:
        torch.cuda.empty_cache()
        nccl = dist.launch(_lm_sp_rank, LM_SP["sp"], (), backend="nccl",
                           timeout_s=400)
        emit({"phase": "train_lm_sp_nccl", "ranks": LM_SP["sp"],
              "per_impl": _sp_summary(nccl),
              "first_loss_rel_err": _lm_sp_check("train_lm_sp_nccl", nccl,
                                                 cfg, ref_loss)})
    else:
        emit({"phase": "train_lm_sp_nccl", "ran": False,
              "why": "%d visible card: NCCL takes one rank a card"
                     % torch.cuda.device_count()})
    return row


def _lm_sp_numerics_rank(w0, ref, ref_p, shape, ckdir):
    """One rank of ``train_lm_sp_numerics`` over a ``shape`` (dp, sp)
    mesh on cuda:0, float32: ring and Ulysses trajectories, ZeRO-1 ring
    (at lr 0 against replicated, and uninterrupted), at (1, 2) the ring
    faults, at (2, 2) a ZeRO-1 checkpoint under ``ckdir``.  Each
    trajectory comes back as its errors against the CPU float64 one."""
    from mxnet_tpu_torch.parallel.mesh import make_mesh
    from mxnet_tpu_torch.transformer import TransformerTrainStep

    _rank_setup()
    mesh = make_mesh(shape, ("dp", "sp"))
    cfg = lm_config(**LM_NUM, dtype="float32", param_dtype="float32")

    def run(impl, steps, fault=None, ckpt=None, lr=LM_NUM_LR, **kw):
        step = TransformerTrainStep(cfg, mesh=mesh, attn_impl=impl,
                                    learning_rate=lr, momentum=0.9,
                                    device="cuda", **kw)
        step.load_state({"params": w0})
        it = lm_iter(cfg, LM_NUM_BATCH, LM_NUM_SEQ, LM_SP_NUM_SEQS, seed=1)
        if ckpt is not None:
            step.fit(it, steps, checkpoint_every_n=steps,
                     checkpoint_dir=ckpt)
            return None
        losses, params = [], []
        with _ring_fault(fault):
            for _ in range(steps):
                b = it.next()
                losses.append(float(step.step(b.data[0], b.label[0])))
                params.append({k: v.astype(np.float64)
                               for k, v in step.params_numpy().items()})
        loss_err, upd_err = trajectory_errors(
            np.array(losses), params, ref[:steps], ref_p[:steps], w0)
        return {"losses": losses, "loss_rel_err": loss_err.tolist(),
                "update_err": upd_err.tolist(), "zero1": step.zero1,
                "digest": _digest(params[-1]), "params": params}

    out = {"rank": mesh.rank, "index": (mesh.axis_index("dp"),
                                        mesh.axis_index("sp"))}
    for impl in ("ring", "ulysses"):
        _reset_kernel_counts()
        out[impl] = run(impl, LM_SP_NUM_STEPS, zero_stage=0)
        out[impl]["kernel_launches"] = _kernel_counts()
    out["ring_lr0_z0"] = run("ring", 1, lr=0.0, zero_stage=0)
    out["ring_lr0_z1"] = run("ring", 1, lr=0.0, zero_stage=1)
    out["ring_z1"] = run("ring", LM_SP_NUM_STEPS, zero_stage=1)
    if shape == (1, 2):
        for f in RING_FAULTS:
            out[f] = run("ring", LM_SP_NUM_STEPS, fault=f, zero_stage=0)
    if ckdir is not None:
        run("ring", LM_SP_NUM_CKPT, ckpt=ckdir, zero_stage=1)
    # only rank 0 sends parameters back (the resume check's control)
    for k, v in out.items():
        if isinstance(v, dict) and "params" in v:
            if not (mesh.rank == 0 and k == "ring_z1"):
                del v["params"]
    return out


def _lm_sp_num_check(tag, ranks, cfg):
    """The verdicts of one mesh's ranks: every trajectory within the
    LM_NUM_* limits, the launches of each impl, ZeRO-1 = replicated at
    lr 0, ranks equal; returns (row, the faults' readings)."""
    L, S = cfg.n_layers, LM_SP_NUM_STEPS
    res = {"loss_rel_err": {}, "update_err": {}, "launches": {}}
    for rank in ranks:
        d, s = rank["index"]
        for name in ("ring", "ulysses", "ring_z1"):
            r = rank[name]
            key = "rank%d_%s" % (rank["rank"], name)
            res["loss_rel_err"][key] = max(r["loss_rel_err"])
            res["update_err"][key] = max(r["update_err"])
        for impl, per_layer in (("ring", s + 1), ("ulysses", 1)):
            c = rank[impl]["kernel_launches"]
            res["launches"]["rank%d_%s" % (rank["rank"], impl)] = c
            _check_launches("%s: rank %d %s" % (tag, rank["rank"], impl), c,
                            per_layer * L * S, "simt")
    r0 = ranks[0]
    res["zero1_equals_replicated_at_lr0"] = all(
        r["ring_lr0_z0"]["digest"] == r["ring_lr0_z1"]["digest"] and
        r["ring_lr0_z0"]["losses"] == r["ring_lr0_z1"]["losses"]
        for r in ranks)
    res["ranks_equal"] = all(r[n]["digest"] == r0[n]["digest"]
                             for r in ranks for n in ("ring", "ulysses"))
    res["zero1"] = all(r["ring_z1"]["zero1"] for r in ranks)
    if not (max(res["loss_rel_err"].values()) <= LM_NUM_LOSS_RTOL and
            max(res["update_err"].values()) <= LM_NUM_UPDATE_TOL):
        raise RuntimeError("%s: off the CPU float64 trajectory: %r"
                           % (tag, res))
    if not (res["zero1_equals_replicated_at_lr0"] and res["ranks_equal"]
            and res["zero1"]):
        raise RuntimeError("%s: an exchange differs: %r" % (tag, res))
    faults = {f: max(max(r[f]["update_err"]) for r in ranks)
              for f in RING_FAULTS if f in r0}
    return res, faults


def phase_train_lm_sp_numerics():
    """train_lm_numerics's cut sequence-parallel on cuda:0 (see
    LM_SP_NUM_*): ring and Ulysses at sp=2 and dp=2 x sp=2 against the CPU
    float64 trajectory, ZeRO-1 with sp, a dp=2 x sp=2 checkpoint resumed
    at dp=1, and three planted ring faults."""
    from mxnet_tpu_torch import checkpoint as ckpt
    from mxnet_tpu_torch import dist
    from mxnet_tpu_torch.transformer import TransformerTrainStep

    cfg32 = lm_config(**LM_NUM, dtype="float32", param_dtype="float32")
    cfg64 = lm_config(**LM_NUM, dtype="float64", param_dtype="float64")
    w0 = TransformerTrainStep(cfg32, device="cpu", seed=0).params_numpy()
    ref, ref_p = _lm_numerics_run(cfg64, "cpu", w0, LM_SP_NUM_STEPS,
                                  np.float64, sequences=LM_SP_NUM_SEQS)
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_lmspnum_")
    t0 = time.perf_counter()
    try:
        torch.cuda.empty_cache()
        sp2, dpsp = side_by_side(*[
            lambda shape=shape, d=d: dist.launch(
                _lm_sp_numerics_rank, shape[0] * shape[1],
                (w0, ref, ref_p, shape, d), backend="gloo",
                device="cuda:0", timeout_s=300)
            for shape, d in (((1, 2), None), ((2, 2), ckdir))])
        # dp=2 x sp=2 -> one device: resume the ZeRO-1 checkpoint
        s = TransformerTrainStep(cfg32, learning_rate=LM_NUM_LR,
                                 momentum=0.9, device="cuda", zero_stage=1)
        payload = ckpt.load_checkpoint(ckdir, rank=0, num_ranks=1)
        s.load_state(payload)
        it = lm_iter(cfg32, LM_NUM_BATCH, LM_NUM_SEQ, LM_SP_NUM_SEQS, seed=1)
        it.skip_batches(ckpt.scale_resume_skip(payload, LM_NUM_BATCH))
        ws, resumed = s.params_numpy(), []
        for _ in range(LM_SP_NUM_STEPS - LM_SP_NUM_CKPT):
            b = it.next()
            s.step(b.data[0], b.label[0])
            resumed.append({k: v.astype(np.float64)
                            for k, v in s.params_numpy().items()})
        want = dpsp[0]["ring_z1"]["params"][LM_SP_NUM_CKPT:]
        resume_err = max(_update_err(g, w, ws)
                         for g, w in zip(resumed, want))
        elastic = payload.get("elastic")
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    wall = time.perf_counter() - t0
    sp2_res, faults = _lm_sp_num_check("train_lm_sp_numerics (sp=2)", sp2,
                                       cfg32)
    dpsp_res, _ = _lm_sp_num_check("train_lm_sp_numerics (dp=2 x sp=2)",
                                   dpsp, cfg32)
    row = {"phase": "train_lm_sp_numerics", "config": LM_NUM,
           "global_batch": LM_NUM_BATCH, "seq": LM_NUM_SEQ,
           "steps": LM_SP_NUM_STEPS, "dtype": "float32",
           "reference": "the port on the CPU, float64, one device",
           "cpu_losses": ref.tolist(),
           "loss_rtol": LM_NUM_LOSS_RTOL, "update_tol": LM_NUM_UPDATE_TOL,
           "sp2": sp2_res, "dp2_sp2": dpsp_res,
           "resume_dp2_sp2_to_one_device_update_err": resume_err,
           "resume_elastic": elastic,
           "fault_update_err": faults, "wall_s": wall}
    emit(row)
    if not resume_err <= LM_NUM_UPDATE_TOL:
        raise RuntimeError("train_lm_sp_numerics: the dp=2 x sp=2 "
                           "checkpoint resumed at dp=1 is off by %g"
                           % resume_err)
    if not (len(faults) == len(RING_FAULTS)
            and min(faults.values()) > LM_NUM_UPDATE_TOL):
        raise RuntimeError("train_lm_sp_numerics: the check cannot tell a "
                           "planted fault from the reference: %r"
                           % (faults,))
    return row


def _module_dp_rank(ref_path, runs):
    """One rank of ``module_dp_numerics``: Module(context=[gpu(0),
    gpu(1)]) fits per ``runs`` (tag, kvstore, fault), each against the
    one-device trajectory in ``ref_path``."""
    import mxnet_tpu_torch as mx

    _rank_setup()
    ref = np.load(ref_path)
    w0, aux0, flat0, X, y, ref_p, aux_names = _module_dp_inputs(mx, ref)
    out = {}
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for tag, kv, fault in runs:
            params, losses, mod = _fit_steps(
                [mx.gpu(0), mx.gpu(1)], w0, aux0, X, y, 1,
                batch=MODULE_DP["batch"] * MODULE_DP["ranks"], kvstore=kv,
                fault=fault)
            out[tag] = {"update_err": [_update_err(p, r, flat0)
                                       for p, r in zip(params, ref_p)],
                        "aux_update_err": _update_err(
                            {k: params[-1][k] for k in aux_names},
                            {k: ref_p[-1][k] for k in aux_names},
                            {k: flat0[k] for k in aux_names}),
                        "ranks": mod._dp.num_ranks,
                        "losses": losses.tolist()}
    finally:
        torch.backends.cudnn.deterministic = det
    return out


def _module_dp_inputs(mx, ref):
    """The start (Xavier from numpy seed 0, float64), the global batches
    and the one-device trajectory, from the arrays of ``ref``."""
    w0 = {k[3:]: mx.nd.array(ref[k], ctx=mx.cpu(), dtype="float64")
          for k in ref.files if k.startswith("w0/")}
    aux0 = {k[3:]: mx.nd.array(ref[k], ctx=mx.cpu(), dtype="float64")
            for k in ref.files if k.startswith("x0/")}
    flat0 = {k[3:]: ref[k] for k in ref.files
             if k.startswith(("w0/", "x0/"))}
    ref_p = [{k[3:]: ref[k] for k in ref.files if k.startswith("p%d/" % i)}
             for i in range(MODULE_DP["steps"])]
    aux_names = sorted(k[3:] for k in ref.files if k.startswith("x0/"))
    return w0, aux0, flat0, ref["X"], ref["y"], ref_p, aux_names


def _placement_mlp(mx):
    """A two-group MLP (ref: tests/test_model_parallel.py): the hidden
    layer in group dev1, the head in dev2."""
    with mx.name.NameManager():
        data = mx.sym.Variable("data")
        with mx.AttrScope(ctx_group="dev1"):
            h = mx.sym.Activation(mx.sym.FullyConnected(
                data, num_hidden=256, name="fc1"), act_type="relu")
        with mx.AttrScope(ctx_group="dev2"):
            out = mx.sym.FullyConnected(h, num_hidden=10, name="fc2")
            return mx.sym.SoftmaxOutput(out, name="softmax")


def _placement_check(mx, group2ctxs):
    """The MLP placed by ``group2ctxs`` against the unplaced run on
    gpu(0), float64, MODULE_DP["mlp_steps"] steps: the update error, and
    the device each layer's weight lives on."""
    rng = np.random.RandomState(5)
    n = MODULE_DP["mlp_batch"] * MODULE_DP["mlp_steps"]
    X, y = rng.randn(n, 64), rng.randint(0, 10, n).astype(np.float64)
    w0 = {"fc1_weight": rng.randn(256, 64) * 0.1, "fc1_bias": np.zeros(256),
          "fc2_weight": rng.randn(10, 256) * 0.1, "fc2_bias": np.zeros(10)}
    start = {k: mx.nd.array(v, ctx=mx.cpu(), dtype="float64")
             for k, v in w0.items()}
    runs = {}
    for tag, g2c in (("unplaced", None), ("placed", group2ctxs)):
        params, _, mod = _fit_steps(mx.gpu(0), start, {}, X, y, 1,
                                    batch=MODULE_DP["mlp_batch"],
                                    symbol=_placement_mlp(mx),
                                    group2ctxs=g2c)
        runs[tag] = (params, {k: str(mod._exec.arg_dict[k]._data.device)
                              for k in ("fc1_weight", "fc2_weight")})
    err = max(_update_err(p, u, w0) for p, u in zip(runs["placed"][0],
                                                    runs["unplaced"][0]))
    return {"update_err": err, "devices": runs["placed"][1]}


def phase_module_dp_numerics():
    """The multi-context Module, kvstore tpu/nccl and group2ctx placement
    on the card (see MODULE_DP)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import dist

    gb = MODULE_DP["batch"] * MODULE_DP["ranks"]
    X, y = _fit_data(gb, FIT_NUM["image"], FIT_NUM["classes"],
                     MODULE_DP["steps"], seed=9)
    X = X.astype(np.float64)
    start = mx.mod.Module(sym_resnet50(FIT_NUM["classes"]),
                          context=mx.cpu())
    start.bind([("data", (gb, 3, FIT_NUM["image"], FIT_NUM["image"]))],
               [("softmax_label", (gb,))])
    _cast_module(start, torch.float64)
    np.random.seed(0)
    start.init_params(mx.init.Xavier())
    w0, aux0 = start.get_params()
    flat0 = {k: v.asnumpy() for k, v in list(w0.items()) +
             list(aux0.items())}
    aux_names = sorted(aux0)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ref_p, ref_loss, _ = _fit_steps(mx.gpu(0), w0, aux0, X, y, 1,
                                        batch=gb)
        # no process group here: the list collapses onto cuda:0
        collapsed, _, cmod = _fit_steps([mx.gpu(0), mx.gpu(1)], w0, aux0,
                                        X, y, 1, batch=gb)
    finally:
        torch.backends.cudnn.deterministic = det
    collapse_bitwise = all(np.array_equal(c[k], r[k]) for c, r in
                           zip(collapsed, ref_p) for k in r)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_moddp_")
    ref_path = str(Path(tmp) / "reference.npz")
    arrays = {"X": X, "y": y}
    arrays.update({"w0/" + k: v.asnumpy() for k, v in w0.items()})
    arrays.update({"x0/" + k: v.asnumpy() for k, v in aux0.items()})
    for i, p in enumerate(ref_p):
        arrays.update({"p%d/%s" % (i, k): v for k, v in p.items()})
    np.savez(ref_path, **arrays)
    runs = (("local", "local", None), ("tpu", "tpu", None),
            ("nccl", "nccl", None),
            ("grad_not_reduced", "local", "grad_not_reduced"))
    try:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out = dist.launch(_module_dp_rank, MODULE_DP["ranks"],
                          (ref_path, runs), backend="gloo",
                          device="cuda:0", timeout_s=300)
        gloo_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    good = {"rank%d_%s" % (r, tag): max(rank[tag]["update_err"])
            for r, rank in enumerate(out) for tag in ("local", "tpu", "nccl")}
    aux_err = max(rank[tag]["aux_update_err"] for rank in out
                  for tag in ("local", "tpu", "nccl"))
    fault = max(max(rank["grad_not_reduced"]["update_err"])
                for rank in out)
    placed = _placement_check(mx, {"dev1": mx.cpu(), "dev2": mx.gpu(0)})
    row = {"phase": "module_dp_numerics", "model": "sym_resnet50",
           "cut": {"batch_per_rank": MODULE_DP["batch"],
                   "ranks": MODULE_DP["ranks"], "image": FIT_NUM["image"],
                   "classes": FIT_NUM["classes"],
                   "steps": MODULE_DP["steps"]},
           "dtype": "float64", "backend": "gloo, 2 ranks sharing cuda:0",
           "reference": "one-device Module on the card, global batch %d"
                        % gb,
           "reference_ce": ref_loss.tolist(),
           "update_err": good, "aux_update_err": aux_err,
           "tol": FIT_NUM_TOL, "ranks": [rank["local"]["ranks"]
                                         for rank in out],
           "collapsed_one_process_bitwise": collapse_bitwise,
           "collapsed_ranks": cmod._dp.num_ranks,
           "fault_grad_not_reduced_update_err": fault,
           "placement_host_and_card": placed, "gloo_s": gloo_s}
    if torch.cuda.device_count() >= 2:
        row["placement_two_cards"] = _placement_check(
            mx, {"dev1": mx.gpu(0), "dev2": mx.gpu(1)})
    else:
        row["placement_two_cards"] = {
            "ran": False, "why": "%d visible card"
                                 % torch.cuda.device_count()}
    emit(row)
    if not (max(good.values()) <= FIT_NUM_TOL and aux_err <= FIT_NUM_TOL
            and row["ranks"] == [2, 2]):
        raise RuntimeError("module_dp_numerics: the two-context Module is "
                           "off the one-device trajectory: %r" % (row,))
    if not (collapse_bitwise and row["collapsed_ranks"] == 1):
        raise RuntimeError("module_dp_numerics: the collapsed list differs "
                           "from one device")
    if not fault > FIT_NUM_TOL:
        raise RuntimeError("module_dp_numerics: the check cannot tell an "
                           "unreduced gradient (%g) from the reference"
                           % fault)
    placements = [placed] + ([row["placement_two_cards"]]
                             if "update_err" in row["placement_two_cards"]
                             else [])
    if not all(p["update_err"] <= FIT_NUM_TOL for p in placements) or \
            placed["devices"] != {"fc1_weight": "cpu",
                                  "fc2_weight": "cuda:0"}:
        raise RuntimeError("module_dp_numerics: group2ctx placement is off "
                           "the unplaced run: %r" % (placements,))
    return row


# ---------------------------------------------------------------------------
# tensor parallelism (parallel/tensor.py) and the parameter server
# ---------------------------------------------------------------------------
TP = dict(batch=128, warmup=1, steps=1, mp=2)
TP_NUM = dict(batch=4, image=8, classes=5, steps=2, lr=0.1, momentum=0.9,
              wd=1e-4)
TP_NUM_TOL = 1e-10
TP_FAULTS = ("input_grad_not_reduced", "shard_grad_not_reduced")


def tp_resnet_spec(P, mp=TP["mp"]):
    """``__graft_entry__.py:136-149``'s spec at ResNet-50 widths: the
    classifier's weight and bias over ``mp`` by class, every conv weight
    of at least 256 output channels over ``mp`` by output channel."""
    def spec(name, shape):
        if name.endswith("dense0_weight") and shape[0] % mp == 0:
            return P("mp", None)
        if name.endswith("dense0_bias") and shape[0] % mp == 0:
            return P("mp")
        if name.endswith("weight") and len(shape) == 4 and \
                shape[0] >= 256 and shape[0] % mp == 0:
            return P("mp", None, None, None)
        return None
    return spec


def tp_net(pkg, prefix="tp_"):
    """The tensor-parallel numerics net (either package): a conv with a
    bias, BatchNorm, a conv without one, BatchNorm, global pooling and
    two Dense layers."""
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(nn.Conv2D(8, 3, padding=1), nn.BatchNorm(),
                nn.Activation("relu"),
                nn.Conv2D(6, 3, padding=1, use_bias=False), nn.BatchNorm(),
                nn.Activation("relu"), nn.GlobalAvgPool2D(),
                nn.Dense(8), nn.Activation("relu"), nn.Dense(5))
    return net


def tp_spec(P):
    """``tp_net``'s spec over ``mp``: column-parallel ``conv2d0`` (its
    bias with it) and ``dense0``, row-parallel ``dense1``, and gathered
    on use: ``conv2d1``'s weight over its input channels (a short spec),
    BatchNorm's gamma and running mean."""
    table = (("conv2d0_weight", P("mp", None, None, None)),
             ("conv2d0_bias", P("mp")),
             ("conv2d1_weight", P(None, "mp")),
             ("batchnorm0_gamma", P("mp")),
             ("batchnorm0_running_mean", P("mp")),
             ("dense0_weight", P("mp", None)),
             ("dense0_bias", P("mp")),
             ("dense1_weight", P(None, "mp")))

    def spec(name, shape):
        for suffix, sp in table:
            if name.endswith(suffix):
                return sp
        return None
    return spec


def _global_bytes(step) -> int:
    """Parameter bytes of the replicated step (every cell in full),
    read from the global shapes (no gather)."""
    return sum(int(np.prod(p.data().shape)) * step._value(i).element_size()
               for i, p in enumerate(step._cells))


def _tp_rank():
    """One rank of ``tp``: warm-up, then timed steps, one of them with
    its collectives counted."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import dist, gluon
    from mxnet_tpu_torch.parallel import tensor
    from mxnet_tpu_torch.parallel.dp import FusedTrainStep
    from mxnet_tpu_torch.parallel.mesh import make_mesh

    _rank_setup()
    mesh = make_mesh((1, TP["mp"]), ("dp", "mp"))
    ctx = mx.gpu(dist.device().index)
    net = resnet50(ctx)
    data, label = train_batch(TP["batch"], ctx)
    step = FusedTrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                          mesh=mesh, learning_rate=TRAIN_LR,
                          momentum=TRAIN_MOMENTUM, dtype="bfloat16",
                          param_spec_fn=tp_resnet_spec(tensor.P))
    torch.cuda.reset_peak_memory_stats()
    warm = step.run_steps(data, label, steps=TP["warmup"]).asnumpy()
    with _CollectiveCount() as count:
        step.run_steps(data, label, steps=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = step.run_steps(data, label, steps=TP["steps"]).asnumpy()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / TP["steps"] * 1e3
    full = _global_bytes(step)
    return {"step_ms": step_ms,
            "images_per_s": TP["batch"] / step_ms * 1e3,
            "first_loss": float(warm[0]), "last_loss": float(losses[-1]),
            "sharded_params": len(step._layouts),
            "modes": sorted({lay.mode for lay in step._layouts.values()}),
            "param_bytes": step.param_bytes_per_rank(),
            "momenta_bytes": step.optimizer_state_bytes_per_rank(),
            "replicated_param_bytes": full,
            "replicated_momenta_bytes": full,
            "collectives_per_step": count.calls,
            "kernel_launches": _kernel_counts(),
            "peak_mem_bytes": torch.cuda.max_memory_allocated()}


def phase_tp():
    """ResNet-50 v1 bf16 tensor-parallel over dp=1 x mp=2 on two gloo
    ranks sharing cuda:0 (see TP)."""
    from mxnet_tpu_torch import dist

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = dist.launch(_tp_rank, TP["mp"], (), backend="gloo",
                        device="cuda:0", timeout_s=600)
    r0 = ranks[0]
    state = r0["param_bytes"] + r0["momenta_bytes"]
    rep = r0["replicated_param_bytes"] + r0["replicated_momenta_bytes"]
    row = {"phase": "tp", "model": "resnet50_v1", "dtype": "bfloat16",
           "mesh": {"dp": 1, "mp": TP["mp"]},
           "backend": "gloo, %d ranks sharing cuda:0" % TP["mp"],
           "batch": TP["batch"], "image": 224,
           "spec": "__graft_entry__.py:136-149 at ResNet-50 widths",
           "ranks": ranks, "state_bytes_per_rank": state,
           "replicated_state_bytes": rep,
           "state_ratio": state / rep,
           "images_per_s": r0["images_per_s"], "step_ms": r0["step_ms"],
           "wall_s": time.perf_counter() - t0}
    emit(row)
    for r in ranks:
        if not (np.isfinite(r["first_loss"]) and np.isfinite(r["last_loss"])):
            raise RuntimeError("tp: a loss is not finite: %r" % (r,))
        if not (r["param_bytes"] < r["replicated_param_bytes"] and
                r["collectives_per_step"].get("all_gather_into_tensor")):
            raise RuntimeError("tp: the step did not shard: %r" % (r,))
    if ranks[0]["last_loss"] != ranks[1]["last_loss"]:
        raise RuntimeError("tp: the mp ranks' losses differ")
    return row


def _tp_num_rank(w0, data, label, shape, faults):
    """One rank of ``tp_numerics`` on ``shape`` (dp, mp): the clean run,
    then each planted fault (set on every rank, so the collectives stay
    paired); the parameters of each (a global read)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import convert, dist, gluon
    from mxnet_tpu_torch.parallel import tensor
    from mxnet_tpu_torch.parallel.dp import FusedTrainStep
    from mxnet_tpu_torch.parallel.mesh import make_mesh

    _rank_setup()
    torch.backends.cudnn.deterministic = True
    mesh = make_mesh(shape, ("dp", "mp"))
    ctx = mx.gpu(dist.device().index)
    out = {}
    for fault in (None,) + tuple(faults):
        net = tp_net(mx)
        net.initialize(mx.init.Xavier(), ctx=ctx)
        with mx.autograd.pause():
            net(mx.nd.zeros((2,) + data.shape[2:], ctx=ctx))
        convert.load_block_params(net, w0)
        step = FusedTrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                              mesh=mesh, learning_rate=TP_NUM["lr"],
                              momentum=TP_NUM["momentum"],
                              weight_decay=TP_NUM["wd"], dtype="float64",
                              param_spec_fn=tp_spec(tensor.P))
        if fault:
            tensor.FAULTS.add(fault)
        try:
            losses = step.run_steps(mx.nd.array(data, ctx=ctx),
                                    mx.nd.array(label, ctx=ctx)).asnumpy()
        finally:
            tensor.FAULTS.discard(fault)
        out[fault or "clean"] = {
            "losses": losses.tolist(),
            "params": {k: p.data().asnumpy()
                       for k, p in net.collect_params().items()},
            "param_bytes": step.param_bytes_per_rank(),
            "sharded": len(step._layouts)}
    return out


def phase_tp_numerics():
    """The float64 tensor-parallel net on cuda:0 at dp=1 x mp=2 and
    dp=2 x mp=2 against the one-device step at the global batch."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import convert, dist, gluon
    from mxnet_tpu_torch.parallel.dp import FusedTrainStep

    rng = np.random.RandomState(5)
    gb = TP_NUM["batch"] * 2
    data = rng.uniform(-1, 1, (TP_NUM["steps"], gb, 3, TP_NUM["image"],
                               TP_NUM["image"]))
    label = rng.randint(0, TP_NUM["classes"],
                        (TP_NUM["steps"], gb)).astype(np.float64)
    ctx = mx.gpu(0)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        np.random.seed(0)
        net = tp_net(mx)
        net.initialize(mx.init.Xavier(), ctx=ctx)
        with mx.autograd.pause():
            net(mx.nd.zeros((2,) + data.shape[2:], ctx=ctx))
        # float32 values (exact in float64): the step casts at build
        w0 = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
        step = FusedTrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                              learning_rate=TP_NUM["lr"],
                              momentum=TP_NUM["momentum"],
                              weight_decay=TP_NUM["wd"], dtype="float64")
        ref = step.run_steps(mx.nd.array(data, ctx=ctx),
                             mx.nd.array(label, ctx=ctx)).asnumpy()
        ref_p = {k: p.data().asnumpy()
                 for k, p in net.collect_params().items()}
    finally:
        torch.backends.cudnn.deterministic = det
    row = {"phase": "tp_numerics", "net": "tp_net (2 conv + BN, 2 Dense)",
           "dtype": "float64", "global_batch": gb, "cut": TP_NUM,
           "tol": TP_NUM_TOL,
           "reference": "one device on the card, float64, global batch",
           "reference_losses": ref.tolist()}
    t0 = time.perf_counter()
    shapes = ((1, 2), (2, 2))
    faults_of = {s: TP_FAULTS if s[0] > 1 else TP_FAULTS[:1] for s in shapes}
    launched = side_by_side(*[
        lambda s=s: dist.launch(_tp_num_rank, s[0] * s[1],
                                (w0, data, label, s, faults_of[s]),
                                backend="gloo", device="cuda:0",
                                timeout_s=300)
        for s in shapes])
    for shape, ranks in zip(shapes, launched):
        faults = faults_of[shape]
        tag = "dp%d_mp%d" % shape
        good = [_update_err(r["clean"]["params"], ref_p, w0) for r in ranks]
        loss = max(float(np.abs(np.array(r["clean"]["losses"]) - ref).max()
                         / np.abs(ref).max()) for r in ranks)
        fault = {f: max(_update_err(r[f]["params"], ref_p, w0)
                        for r in ranks) for f in faults}
        row[tag] = {"update_err": max(good), "loss_rel_err": loss,
                    "fault_update_err": fault,
                    "sharded_params": ranks[0]["clean"]["sharded"],
                    "param_bytes_per_rank": ranks[0]["clean"]["param_bytes"],
                    "full_param_bytes": int(sum(v.nbytes
                                                for v in ref_p.values()))}
    row["wall_s"] = time.perf_counter() - t0
    emit(row)
    for tag in ("dp1_mp2", "dp2_mp2"):
        r = row[tag]
        if not (r["update_err"] <= TP_NUM_TOL and
                r["loss_rel_err"] <= TP_NUM_TOL):
            raise RuntimeError("tp_numerics: %s is off the one-device "
                               "float64 trajectory: %r" % (tag, r))
        if not min(r["fault_update_err"].values()) > TP_NUM_TOL:
            raise RuntimeError("tp_numerics: %s cannot tell a planted "
                               "fault from the reference: %r" % (tag, r))
        if not r["param_bytes_per_rank"] < r["full_param_bytes"]:
            raise RuntimeError("tp_numerics: %s holds every parameter in "
                               "full" % tag)
    return row


DIST = dict(batch=32, warmup=1, steps=1, workers=2, servers=1)
DIST_NUM = dict(batch=8, image=8, classes=10, steps=3, lr=0.125,
                momentum=0.9, wd=1e-3, async_pushes=5)
DIST_NUM_TOL = 1e-10


def _ps_cluster(kind, out_dir, env=None, timeout_s=600, servers=None):
    """A loopback cluster from the port's launcher: DIST's workers run
    this script's ``--ps-worker`` mode for ``kind`` on cuda:0, each
    writing ``rank{r}.json`` (and arrays) into ``out_dir``, beside
    ``servers`` servers (DIST's by default); raises unless every worker
    exits 0.  Returns the workers' results."""
    from mxnet_tpu_torch.launch import launch_local

    cmd = [sys.executable, str(Path(__file__).resolve()), "--ps-worker",
           kind, str(out_dir)]
    e = {"OMP_NUM_THREADS": "2"}
    e.update(env or {})
    codes = launch_local(DIST["workers"], servers or DIST["servers"], cmd,
                         env=e, grace_s=5.0)
    if codes != [0] * DIST["workers"]:
        raise RuntimeError("%s: the PS workers exited %r" % (kind, codes))
    out = []
    for r in range(DIST["workers"]):
        with open(Path(out_dir) / ("rank%d.json" % r)) as f:
            out.append(json.load(f))
    return out


def _ps_dist_worker(kv, out_dir):
    """A ``dist`` worker: ResNet-50 bf16 at DIST's batch through
    gluon.Trainer over the store with the server's SGD (rescale
    1/(batch x workers)); each step's push, pull and server seconds and
    bytes."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, diagnostics, gluon

    ctx = mx.gpu(0)
    nw, b = kv.num_workers, DIST["batch"]
    net = resnet50(ctx, seed=0)
    net.cast("bfloat16")
    data, label = train_batch(b * nw, ctx)
    data = data[kv.rank * b:(kv.rank + 1) * b].astype("bfloat16")
    label = label[kv.rank * b:(kv.rank + 1) * b]
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": TRAIN_LR,
                             "momentum": TRAIN_MOMENTUM,
                             "rescale_grad": 1.0 / (b * nw)}, kvstore=kv)
    trainer._init_kvstore()
    ctr = {op: diagnostics.metrics.counter("mxnet_kvstore_bytes_total",
                                           labels={"op": op})
           for op in ("push", "pull")}
    rows = []
    for i in range(DIST["warmup"] + DIST["steps"]):
        kv.barrier()
        before = {op: c.value for op, c in ctr.items()}
        srv0 = sum(s["apply_s"] for s in kv.server_stats())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with autograd.record():
            loss = loss_fn(net(data), label)
        loss.backward()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        trainer._allreduce_grads()
        t2 = time.perf_counter()
        trainer._update()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        srv1 = sum(s["apply_s"] for s in kv.server_stats())
        rows.append({"step_ms": (t3 - t0) * 1e3,
                     "compute_ms": (t1 - t0) * 1e3,
                     "push_s": t2 - t1, "pull_s": t3 - t2,
                     "server_s": srv1 - srv0,
                     "push_bytes": ctr["push"].value - before["push"],
                     "pull_bytes": ctr["pull"].value - before["pull"],
                     "loss": float(loss.mean().asscalar())})
    timed = rows[DIST["warmup"]:]
    n_elems = [int(np.prod(p.data().shape))
               for p in net.collect_params().values()
               if p.grad_req != "null"]
    return {"steps": rows,
            "step_ms": statistics.median(r["step_ms"] for r in timed),
            "images_per_s_per_worker":
                b / statistics.median(r["step_ms"] for r in timed) * 1e3,
            "push_s": statistics.median(r["push_s"] for r in timed),
            "pull_s": statistics.median(r["pull_s"] for r in timed),
            "server_s": statistics.median(r["server_s"] for r in timed),
            "push_bytes": timed[-1]["push_bytes"],
            "pull_bytes": timed[-1]["pull_bytes"],
            "keys": len(n_elems), "grad_elements": sum(n_elems),
            "codes_bytes": sum((n + 3) // 4 for n in n_elems),
            "dense_push_bytes": 2 * sum(n_elems),
            "compressed": kv._gc is not None,
            "kernel_launches": _kernel_counts()}


def dist_num_net(mx, ctx):
    """The float64 parameter-server numerics net: a conv, max pooling
    and two Dense layers (no BatchNorm: a worker's batch statistics are
    its own rows')."""
    nn = mx.gluon.nn
    np.random.seed(0)
    net = nn.HybridSequential(prefix="dn_")
    with net.name_scope():
        net.add(nn.Conv2D(8, 3, padding=1), nn.Activation("relu"),
                nn.MaxPool2D(2), nn.Dense(16), nn.Activation("relu"),
                nn.Dense(DIST_NUM["classes"]))
    net.initialize(mx.init.Xavier(), ctx=ctx)
    with mx.autograd.pause():
        net(mx.nd.zeros((2, 3, DIST_NUM["image"], DIST_NUM["image"]),
                        ctx=ctx))
    net.cast("float64")
    return net


def dist_num_data():
    rng = np.random.RandomState(9)
    gb = DIST_NUM["batch"] * DIST["workers"]
    data = rng.uniform(-1, 1, (DIST_NUM["steps"], gb, 3, DIST_NUM["image"],
                               DIST_NUM["image"]))
    label = rng.randint(0, DIST_NUM["classes"],
                        (DIST_NUM["steps"], gb)).astype(np.float64)
    return data, label


def ps_train(kv, net, data, label, prefix, drop=None):
    """``DIST_NUM["steps"]`` SGD steps of ``net`` through ``kv`` on this
    worker's rows of each global batch (all of them on one process):
    the summed gradient of each parameter pushed under ``prefix + name``
    and the server-updated value pulled back.  ``drop=(rank, step)``:
    that worker's part of that round is lost (it pushes zeros)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon

    ctx = next(iter(net.collect_params().values())).list_ctx()[0]
    nw, r = kv.num_workers, kv.rank
    b = data.shape[1] // nw
    params = [p for p in net.collect_params().values()
              if p.grad_req != "null"]
    for p in params:
        kv.init(prefix + p.name, p.data())
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    for k in range(len(data)):
        x = mx.nd.array(data[k, r * b:(r + 1) * b], ctx=ctx, dtype="float64")
        y = mx.nd.array(label[k, r * b:(r + 1) * b], ctx=ctx)
        with autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        for p in params:
            g = p.grad()
            if drop == (r, k):
                g = g * 0
            kv.push(prefix + p.name, g)
        for p in params:
            kv.pull(prefix + p.name, out=p.data())
    return {p.name: p.data().asnumpy() for p in params}


def _ps_num_optimizer(nw):
    import mxnet_tpu_torch as mx

    return mx.optimizer.SGD(learning_rate=DIST_NUM["lr"],
                            momentum=DIST_NUM["momentum"],
                            wd=DIST_NUM["wd"],
                            rescale_grad=1.0 / (DIST_NUM["batch"] * nw))


def _ps_num_worker(kv, out_dir):
    """A ``dist_numerics`` worker over dist_sync: the clean run and a run
    with rank 1's part of step 1 dropped, under their own keys."""
    import mxnet_tpu_torch as mx

    data, label = dist_num_data()
    kv.set_optimizer(_ps_num_optimizer(kv.num_workers))
    out = {}
    for tag, drop in (("clean", None), ("dropped_push", (1, 1))):
        net = dist_num_net(mx, mx.gpu(0))
        out[tag] = ps_train(kv, net, data, label, tag + ":", drop)
        kv.barrier()
    if kv.rank == 0:
        np.savez(Path(out_dir) / "params.npz",
                 **{t + "/" + k: v for t, ps in out.items()
                    for k, v in ps.items()})
    return {"keys": len(out["clean"])}


def _ps_async_worker(kv, out_dir):
    """A dist_async worker: a constant gradient pushed P times; every
    push applies exactly once."""
    import mxnet_tpu_torch as mx

    ctx = mx.gpu(0)
    lr, g, w0 = 0.25, 0.5, 4.0
    kv.set_optimizer(mx.optimizer.SGD(learning_rate=lr, momentum=0.0,
                                      rescale_grad=1.0, wd=0.0))
    kv.init("x", mx.nd.ones((1024,), ctx=ctx) * w0)
    for _ in range(DIST_NUM["async_pushes"]):
        kv.push("x", mx.nd.ones((1024,), ctx=ctx) * g)
    kv.barrier()
    out = mx.nd.zeros((1024,), ctx=ctx)
    kv.pull("x", out=out)
    want = w0 - lr * g * kv.num_workers * DIST_NUM["async_pushes"]
    return {"value": float(out.asnumpy()[0]), "want": want,
            "exact": bool((out.asnumpy() == want).all())}


def ps_worker_main(kind, out_dir) -> None:
    """This script as a PS worker (``--ps-worker``): runs ``kind`` over
    the launcher's cluster and writes its result to
    ``out_dir/rank{r}.json``."""
    import mxnet_tpu_torch as mx

    _rank_setup()
    torch.backends.cudnn.deterministic = kind == "dist_numerics"
    store = "dist_async" if kind == "dist_async" else "dist_sync"
    kv = mx.kv.create(store)
    fn = {"dist": _ps_dist_worker, "dist_numerics": _ps_num_worker,
          "dist_async": _ps_async_worker, "recommender": _ps_rec_worker,
          "recommender_numerics": _ps_rec_num_worker}[kind]
    res = fn(kv, out_dir)
    res["rank"] = kv.rank
    kv.barrier()
    kv.close()
    with open(Path(out_dir) / ("rank%d.json" % res["rank"]), "w") as f:
        json.dump(res, f)


def phase_dist():
    """ResNet-50 v1 bf16 over dist_sync on a loopback cluster (see DIST),
    then the same under MXNET_GRADIENT_COMPRESSION=2bit."""
    runs = {}
    t0 = time.perf_counter()
    for tag, env in (("dense", {}),
                     ("2bit", {"MXNET_GRADIENT_COMPRESSION": "2bit"})):
        tmp = tempfile.mkdtemp(prefix="chip_smoke_ps_")
        try:
            ranks = _ps_cluster("dist", tmp, env)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        runs[tag] = {k: ranks[0][k] for k in (
            "step_ms", "images_per_s_per_worker", "push_s", "pull_s",
            "server_s", "push_bytes", "pull_bytes", "keys",
            "grad_elements", "codes_bytes", "dense_push_bytes",
            "compressed", "kernel_launches")}
        runs[tag]["losses"] = [[s["loss"] for s in r["steps"]]
                               for r in ranks]
        runs[tag]["step_ms_per_worker"] = [r["step_ms"] for r in ranks]
        runs[tag]["compute_ms"] = statistics.median(
            s["compute_ms"] for s in ranks[0]["steps"][DIST["warmup"]:])
    row = {"phase": "dist", "model": "resnet50_v1", "dtype": "bfloat16",
           "store": "dist_sync", "workers": DIST["workers"],
           "servers": DIST["servers"], "batch_per_worker": DIST["batch"],
           "image": 224, "optimizer": "server SGD lr %g momentum %g"
           % (TRAIN_LR, TRAIN_MOMENTUM),
           "placement": "2 workers on cuda:0, scheduler and server on "
                        "the host", "runs": runs,
           "wall_s": time.perf_counter() - t0}
    emit(row)
    d, c = runs["dense"], runs["2bit"]
    if not all(np.isfinite(x) for r in (d, c) for ls in r["losses"]
               for x in ls):
        raise RuntimeError("dist: a loss is not finite: %r" % (row,))
    if d["push_bytes"] != d["dense_push_bytes"] or d["compressed"]:
        raise RuntimeError("dist: the dense push bytes %r are not the "
                           "gradients' %r" % (d["push_bytes"],
                                              d["dense_push_bytes"]))
    if not (c["compressed"] and c["push_bytes"] == c["codes_bytes"]
            and c["pull_bytes"] == d["pull_bytes"]):
        raise RuntimeError("dist: the 2-bit push bytes %r are not the "
                           "codes' %r (or the pull bytes moved)"
                           % (c["push_bytes"], c["codes_bytes"]))
    return row


def _codes_on_card_vs_host(steps=4):
    """The card's 2-bit codes and residuals against the host's numpy
    computation over ``steps`` calls of seeded gradients (the residual
    carries), at a ResNet-50 layer's and classifier's sizes."""
    from mxnet_tpu_torch.gradient_compression import GradientCompression

    rng = np.random.RandomState(13)
    card, host = GradientCompression(), GradientCompression()
    shapes = {"conv": (512, 512, 3, 3), "fc": (1000, 2048)}
    same, n = True, 0
    for _ in range(steps):
        for key, shape in shapes.items():
            g = (rng.randn(*shape) * 0.3).astype(np.float32)
            c_codes, _ = card.compress(key, torch.from_numpy(g).cuda())
            h_codes, _ = host.compress(key, g)
            same &= c_codes.cpu().numpy().tobytes() == h_codes
            same &= card.residual(key).cpu().numpy().tobytes() == \
                host.residual(key).tobytes()
            n += g.size
    return {"bitwise": bool(same), "steps": steps, "elements": n,
            "shapes": {k: list(v) for k, v in shapes.items()}}


def phase_dist_numerics():
    """The float64 net over dist_sync on the card against one process at
    the global batch under kvstore local; a dropped push; the 2-bit codes
    on the card against the host; dist_async's exactly-once."""
    import mxnet_tpu_torch as mx

    data, label = dist_num_data()
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        kv = mx.kv.create("local")
        kv.set_optimizer(_ps_num_optimizer(DIST["workers"]))
        net = dist_num_net(mx, mx.gpu(0))
        w0 = {p.name: p.data().asnumpy()
              for p in net.collect_params().values()}
        ref = ps_train(kv, net, data, label, "ref:")
    finally:
        torch.backends.cudnn.deterministic = det
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_psnum_")
    try:
        _ps_cluster("dist_numerics", tmp)
        with np.load(Path(tmp) / "params.npz") as f:
            got = {t: {k.split("/", 1)[1]: f[k] for k in f.files
                       if k.startswith(t + "/")}
                   for t in ("clean", "dropped_push")}
        asy = _ps_cluster("dist_async", tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    codes = _codes_on_card_vs_host()
    row = {"phase": "dist_numerics", "net": "dist_num_net (conv, 2 Dense)",
           "dtype": "float64", "workers": DIST["workers"],
           "batch_per_worker": DIST_NUM["batch"], "cut": DIST_NUM,
           "reference": "one process on the card, kvstore local, batch %d"
                        % (DIST_NUM["batch"] * DIST["workers"]),
           "tol": DIST_NUM_TOL,
           "update_err": _update_err(got["clean"], ref, w0),
           "fault_dropped_push_update_err":
               _update_err(got["dropped_push"], ref, w0),
           "codes_card_vs_host": codes,
           "async": asy, "wall_s": time.perf_counter() - t0}
    emit(row)
    if not row["update_err"] <= DIST_NUM_TOL:
        raise RuntimeError("dist_numerics: dist_sync is off the one-process "
                           "trajectory: %r" % (row,))
    if not row["fault_dropped_push_update_err"] > DIST_NUM_TOL:
        raise RuntimeError("dist_numerics: the check cannot tell a dropped "
                           "push from the reference: %r" % (row,))
    if not codes["bitwise"]:
        raise RuntimeError("dist_numerics: the card's 2-bit codes differ "
                           "from the host's")
    if not all(r["exact"] for r in asy):
        raise RuntimeError("dist_numerics: dist_async did not apply every "
                           "push once: %r" % (asy,))
    return row


# ---------------------------------------------------------------------------
# sparse storage and the recommender tier
# ---------------------------------------------------------------------------
# the shape of example/sparse/linear_classification at a million features
SPARSE = dict(rows=8192, features=2 ** 20, nnz=(8, 56), batch=512, dim=16,
              seed=11)
SPARSE_RTOL = 1e-5
# bench.py:1110's batch and shards at RecommenderConfig's own width
REC = dict(batch=128, shards=4, warmup=2, steps=10, lr=0.05, seed=7,
           lr0_steps=4, profile_steps=5, sync_steps=2, dist_steps=4,
           dist_2bit_steps=2, workers=2, servers=2)
# tests/test_sparse.py:485-524's configuration
REC_NUM = dict(cfg=dict(n_fields=3, vocab=500, embed_dim=4,
                        mlp_hidden=(8,)),
               batch=16, shards=3, steps=8, lr=0.05, samples=256, seed=1)
REC_NUM_LOSS_TOL = 1e-6
REC_NUM_UPDATE_TOL = 1e-5
REC_FAULT_MIN = 1e-2


def write_libsvm(path, rows, features, nnz, seed) -> int:
    """A seeded LibSVM file: ``rows`` lines, a 0/1 label and ``nnz[0]``
    to ``nnz[1]`` distinct sorted feature ids (uniform over
    ``features``) with N(0, 1) values; returns the stored elements."""
    rng = np.random.RandomState(seed)
    counts = rng.randint(nnz[0], nnz[1] + 1, rows)
    labels = rng.randint(0, 2, rows)
    total = 0
    with open(path, "w") as f:
        for n, y in zip(counts, labels):
            cols = np.unique(rng.randint(0, features, n))
            while cols.size < n:
                cols = np.unique(np.concatenate(
                    [cols, rng.randint(0, features, n - cols.size)]))
            vals = rng.randn(n)
            f.write("%d %s\n" % (y, " ".join(
                "%d:%.6g" % cv for cv in zip(cols, vals))))
            total += int(n)
    return total


def csr_dot_bound(nnz, rows, dim, touched_rows, features, transpose):
    """(bound_ms, bound_by) of ``dot(csr, W)`` / ``dot(csr.T, G)``
    float32: the CSR parts read once (values 4, column ids 8, row
    pointers 8 bytes), the dense rows the product needs (the touched
    rows of W; all of G) read once, the output written once (csr.T's is
    a whole ``features x dim`` table); 2 operations a stored element a
    column against the float32 peak."""
    nbytes = nnz * 12 + (rows + 1) * 8
    if transpose:
        nbytes += rows * dim * 4 + features * dim * 4
    else:
        nbytes += touched_rows * dim * 4 + rows * dim * 4
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = 2.0 * nnz * dim / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def lazy_update_bound(n_rows, dim, n_states):
    """(bound_ms, "bytes") of one lazy row update: the gradient rows and
    ids read, the weight and state rows read and written."""
    nbytes = n_rows * (8 + dim * 4 * (1 + 2 * (1 + n_states)))
    return nbytes / PEAK_BYTES_S * 1e3, "bytes"


def lazy_reference(name, w0, steps, lr, momentum=0.9, beta1=0.9,
                   beta2=0.999, eps_adam=1e-8, eps_adagrad=1e-7):
    """The lazy update in float64 numpy over ``w0`` (the rows touched by
    any step): ``steps`` is a list of (positions into w0, gradient
    rows).  Returns the weight and state rows."""
    import math

    w = np.asarray(w0, np.float64).copy()
    s1, s2 = np.zeros_like(w), np.zeros_like(w)
    for t, (pos, g) in enumerate(steps, 1):
        g = np.asarray(g, np.float64)
        if name == "sgd":
            s1[pos] = momentum * s1[pos] - lr * g
            w[pos] += s1[pos]
        elif name == "adam":
            lr_t = lr * math.sqrt(1.0 - beta2 ** t) / (1.0 - beta1 ** t)
            s1[pos] = beta1 * s1[pos] + (1.0 - beta1) * g
            s2[pos] = beta2 * s2[pos] + (1.0 - beta2) * g * g
            w[pos] -= lr_t * s1[pos] / (np.sqrt(s2[pos]) + eps_adam)
        else:
            s1[pos] += g * g
            w[pos] -= lr * g / np.sqrt(s1[pos] + eps_adagrad)
    return w, {"sgd": [s1], "adam": [s1, s2], "adagrad": [s1]}[name]


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _sparse_parts_equal(a, b) -> bool:
    names = ("data", "indices") + (("indptr",) if a.stype == "csr" else ())
    return a.stype == b.stype and a.shape == b.shape and all(
        np.array_equal(getattr(a, n).asnumpy(), getattr(b, n).asnumpy())
        for n in names)


def sparse_checks(ctx, batches, features, dim, seed, timed=True):
    """The card's sparse storage on ``batches`` (LibSVM CSR batches on
    the host): the two CSR products against float64 numpy (row-scaled),
    SGD momentum / Adam / AdaGrad lazy updates over two batches' columns
    against float64 numpy with untouched rows and states held bitwise,
    rsp add / subtract / retain exact, a ``.params`` round trip bitwise;
    with ``timed`` the times and bounds."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ndarray import sparse as sp
    from mxnet_tpu_torch.ops import optimizer_ops

    dev = ctx.torch_device()
    rng = np.random.RandomState(seed)
    w_np = rng.randn(features, dim).astype(np.float32)
    csr_h = batches[0].data[0]
    rows = csr_h.shape[0]
    data = csr_h.data.asnumpy().astype(np.float64)
    cols = csr_h.indices.asnumpy()
    row_of = np.repeat(np.arange(rows), np.diff(csr_h.indptr.asnumpy()))
    csr = csr_h.copyto(ctx)
    w = mx.nd.array(w_np, ctx=ctx)
    g_np = rng.randn(rows, dim).astype(np.float32)
    g = mx.nd.array(g_np, ctx=ctx)
    out = sp.dot(csr, w)
    out_t = sp.dot(csr, g, transpose_a=True)
    ref = np.zeros((rows, dim))
    np.add.at(ref, row_of, data[:, None] * w_np[cols])
    ref_t = np.zeros((features, dim))
    np.add.at(ref_t, cols, data[:, None] * g_np[row_of])
    row = {"nnz": int(data.size), "batch_shape": list(csr.shape),
           "dot_err": row_scaled_err(out._data.cpu(), torch.from_numpy(ref)),
           "dot_t_err": row_scaled_err(out_t._data.cpu(),
                                       torch.from_numpy(ref_t))}
    # lazy updates over two batches' columns
    r1 = np.unique(cols)
    r2 = np.unique(batches[1].data[0].indices.asnumpy())
    union = np.union1d(r1, r2)
    g1 = rng.randn(r1.size, dim).astype(np.float32)
    g2 = rng.randn(r2.size, dim).astype(np.float32)
    untouched = torch.ones(features, dtype=torch.bool, device=dev)
    untouched[torch.from_numpy(union).to(dev)] = False
    lazy = {}
    for name, kw in (("sgd", {"momentum": 0.9}), ("adam", {}),
                     ("adagrad", {})):
        opt = mx.optimizer.create(name, learning_rate=0.1, **kw)
        wt = mx.nd.array(w_np, ctx=ctx)
        state = opt.create_state(0, wt)
        states = list(state) if isinstance(state, tuple) else [state]
        for r, gr in ((r1, g1), (r2, g2)):
            opt.update(0, wt, sp.row_sparse_array(
                (gr, r), shape=(features, dim), ctx=ctx), state)
        want_w, want_s = lazy_reference(
            name, w_np[union], [(np.searchsorted(union, r1), g1),
                                (np.searchsorted(union, r2), g2)], 0.1)
        idx = torch.from_numpy(union).to(dev)
        lazy[name] = {
            "weight_err": _rel(wt._data[idx].cpu(), want_w),
            "state_err": max(_rel(s._data[idx].cpu(), ws)
                             for s, ws in zip(states, want_s)),
            "untouched_bitwise": bool(
                torch.equal(wt._data[untouched],
                            torch.from_numpy(w_np).to(dev)[untouched])
                and all(int(torch.count_nonzero(s._data[untouched])) == 0
                        for s in states))}
    row["lazy"] = lazy
    row["touched_rows"] = [int(r1.size), int(r2.size)]
    # row-sparse arithmetic, exact in float32
    a = sp.row_sparse_array((g1, r1), shape=(features, dim), ctx=ctx)
    b = sp.row_sparse_array((g2, r2), shape=(features, dim), ctx=ctx)
    va = np.zeros((union.size, dim), np.float32)
    vb = np.zeros((union.size, dim), np.float32)
    va[np.searchsorted(union, r1)] = g1
    vb[np.searchsorted(union, r2)] = g2
    keep = np.isin(r1, r2)
    arith = {}
    for fn, want in (("add", va + vb), ("subtract", va - vb)):
        got = getattr(sp, fn)(a, b)
        arith[fn] = bool(np.array_equal(got.indices.asnumpy(), union)
                         and np.array_equal(got.data.asnumpy(), want))
    kept = sp.retain(a, r2)
    arith["retain"] = bool(
        np.array_equal(kept.indices.asnumpy(), r1[keep])
        and np.array_equal(kept.data.asnumpy(), g1[keep]))
    row["rsp_ops_exact"] = arith
    # a .params file with a CSR and a row-sparse array from the card
    tmp = tempfile.mkdtemp(prefix="chip_smoke_params_")
    try:
        f = os.path.join(tmp, "sparse.params")
        mx.nd.save(f, {"csr": csr, "rsp": a})
        back = mx.nd.load(f, ctx=ctx)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    row["params_roundtrip_bitwise"] = bool(
        _sparse_parts_equal(back["csr"], csr)
        and _sparse_parts_equal(back["rsp"], a)
        and back["csr"].context == ctx)
    if not timed:
        return row
    touched_w = int(np.unique(cols).size)
    times = {"dot_ms": time_ms(lambda: sp.dot(csr, w)),
             "dot_t_ms": time_ms(lambda: sp.dot(csr, g, transpose_a=True))}
    # the plain version: the dense product of the densified batch
    dense_csr = csr.todense()
    times["dot_dense_ms"] = time_ms(lambda: mx.nd.dot(dense_csr, w))
    p = csr._parts()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # "support is in beta state"
        lib = torch.sparse_csr_tensor(p["indptr"], p["indices"], p["data"],
                                      csr.shape, check_invariants=False)
    times["dot_library_ms"] = time_ms(lambda: torch.sparse.mm(lib, w._data))
    times["dot_bound_ms"], times["dot_bound_by"] = csr_dot_bound(
        row["nnz"], rows, dim, touched_w, features, False)
    times["dot_t_bound_ms"], times["dot_t_bound_by"] = csr_dot_bound(
        row["nnz"], rows, dim, touched_w, features, True)
    wt = w._data.clone()
    mt = torch.zeros_like(wt)
    gd = torch.from_numpy(g1).to(dev)
    rt = torch.from_numpy(r1).to(dev)
    times["lazy_sgd_mom_ms"] = time_ms(lambda: optimizer_ops.lazy_update_(
        "_sparse_sgd_mom_update", wt, gd, rt, (mt,), lr=0.1, momentum=0.9))
    g_dense = torch.zeros_like(wt)
    g_dense[rt] = gd
    times["dense_sgd_mom_ms"] = time_ms(lambda: optimizer_ops._sgd_mom_update(
        wt, g_dense, mt, lr=0.1, momentum=0.9))
    times["lazy_bound_ms"], _ = lazy_update_bound(r1.size, dim, 1)
    times["dense_bound_ms"] = 5 * wt.numel() * 4 / PEAK_BYTES_S * 1e3
    opt = mx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9)
    wt_nd = mx.nd.array(w_np, ctx=ctx)
    st = opt.create_state(0, wt_nd)
    grad = sp.row_sparse_array((g1, r1), shape=(features, dim), ctx=ctx)

    def host_update():
        opt.update(0, wt_nd, grad, st)
        torch.cuda.synchronize()

    for _ in range(3):
        host_update()
    t0 = time.perf_counter()
    for _ in range(20):
        host_update()
    times["optimizer_update_host_ms"] = (time.perf_counter() - t0) / 20e-3
    row.update(times)
    return row


def phase_sparse():
    """LibSVM -> CSR batches -> the card's sparse ops (see SPARSE)."""
    import mxnet_tpu_torch as mx

    _reset_kernel_counts()
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_libsvm_")
    try:
        path = os.path.join(tmp, "train.libsvm")
        t0 = time.perf_counter()
        nnz = write_libsvm(path, SPARSE["rows"], SPARSE["features"],
                           SPARSE["nnz"], SPARSE["seed"])
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        it = mx.io.LibSVMIter(data_libsvm=path,
                              data_shape=(SPARSE["features"],),
                              batch_size=SPARSE["batch"])
        parse_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        batches = list(it)
        batch_s = time.perf_counter() - t0
        file_mb = os.path.getsize(path) / 1e6
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    row = {"phase": "sparse", "cut": SPARSE, "file_mb": file_mb,
           "stored_elements": nnz, "write_s": write_s,
           "parse_rows_per_s": SPARSE["rows"] / parse_s,
           "batches": len(batches),
           "batches_per_s": len(batches) / batch_s,
           "batch_stype": batches[0].data[0].stype}
    row.update(sparse_checks(mx.gpu(0), batches, SPARSE["features"],
                             SPARSE["dim"], SPARSE["seed"]))
    row["kernel_launches"] = _kernel_counts()
    row["wall_s"] = time.perf_counter() - t_phase
    emit(row)
    bad = [k for k in ("dot_err", "dot_t_err") if not row[k] <= SPARSE_RTOL]
    bad += ["lazy:" + n for n, v in row["lazy"].items()
            if not (v["weight_err"] <= SPARSE_RTOL
                    and v["state_err"] <= SPARSE_RTOL
                    and v["untouched_bitwise"])]
    bad += [k for k, v in row["rsp_ops_exact"].items() if not v]
    if not row["params_roundtrip_bitwise"]:
        bad.append("params_roundtrip")
    if row["batch_stype"] != "csr" or len(batches) != \
            -(-SPARSE["rows"] // SPARSE["batch"]):
        bad.append("batches")
    if bad:
        raise RuntimeError("sparse: %s failed: %r" % (bad, row))
    return row


def rec_fit(ctx, cfg, kv, sparse, lr, steps, batch, shards, seed,
            warmup=0, momentum=0.0, rescale=1.0, params=None,
            num_parts=1, part_index=0, optimizer=None, batches=None):
    """A RecommenderTrainStep on ``kv`` fed by the clickstream of
    ``seed`` (``batches`` batches a part, default ``warmup + steps +
    2``): ``warmup`` untimed steps, then ``steps`` timed ones with the
    byte counters' deltas; returns (trainer, iterator, result)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import diagnostics
    from mxnet_tpu_torch import recommender as rec

    it = rec.ClickstreamIter(batch_size=batch, n_fields=cfg.n_fields,
                             vocab=cfg.vocab,
                             num_samples=batch * num_parts
                             * (batches or warmup + steps + 2),
                             seed=seed, num_parts=num_parts,
                             part_index=part_index)
    if optimizer is None:
        optimizer = mx.optimizer.SGD(learning_rate=lr, momentum=momentum,
                                     wd=0.0, rescale_grad=rescale)
    trainer = rec.RecommenderTrainStep(
        cfg, kv, optimizer=optimizer, n_shards=shards if sparse else 1,
        seed=0, sparse=sparse, params=params, ctx=ctx)
    if warmup:
        trainer.fit(it, warmup)
    ctrs = {op: diagnostics.metrics.counter("mxnet_kvstore_bytes_total",
                                            labels={"op": op})
            for op in ("row_sparse_pull", "row_sparse_push", "pull",
                       "push")}
    base = {op: c.value for op, c in ctrs.items()}
    res = trainer.fit(it, steps)
    res["counter_deltas"] = {op: c.value - base[op]
                             for op, c in ctrs.items()}
    return trainer, it, res


def rec_state(trainer) -> dict:
    """Every table row and head parameter of ``trainer``'s store, as
    numpy (a pull of every row: the traffic is not counted here)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import recommender as rec

    cfg, kv, ctx = trainer.cfg, trainer.kv, trainer.ctx
    out = {}
    for name in rec.table_names(cfg):
        if trainer.sparse:
            out[name] = trainer.tables[name].pull_rows(
                kv, np.arange(cfg.vocab))
        else:
            o = mx.nd.zeros((cfg.vocab, cfg.embed_dim), ctx=ctx)
            kv.pull("rec:" + name, out=o)
            out[name] = o.asnumpy()
    for name in rec.dense_param_names(cfg):
        o = mx.nd.zeros(tuple(trainer.dense_params[name].shape), ctx=ctx)
        kv.pull("rec:" + name, out=o)
        out[name] = o.asnumpy()
    return out


def rec_update_err(got, want, start) -> float:
    """The worst parameter's max |got - want| over its update's largest
    element (|want - start|)."""
    return max(float(np.abs(np.asarray(got[k], np.float64) - want[k]).max())
               / max(float(np.abs(np.asarray(want[k], np.float64)
                                  - start[k]).max()), 1e-30)
               for k in want)


def pulled_bytes_ratio(sparse_deltas, dense_deltas):
    """The sparse tier's table traffic (its row_sparse_pull bytes) over
    the dense control's (its pull bytes less the sparse run's, which
    are the MLP head's, pulled alike by both)."""
    tables = dense_deltas["pull"] - sparse_deltas["pull"]
    return sparse_deltas["row_sparse_pull"] / max(tables, 1), tables


def _digest_state(state) -> str:
    import hashlib

    h = hashlib.sha256()
    for k in sorted(state):
        h.update(k.encode())
        h.update(np.ascontiguousarray(state[k]).tobytes())
    return h.hexdigest()[:16]


def count_host_syncs(fn) -> int:
    """The synchronizing CUDA calls ``fn`` makes, from
    ``torch.cuda.set_sync_debug_mode("warn")``'s warnings."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum(1 for w in caught if "synchroniz" in str(w.message))


def _rec_profile(trainer, it, steps, untraced_ms):
    """``steps`` sparse steps under torch.profiler: device-busy ms a
    step (kernels and copies), the idle share against the untraced step
    time, the copies' ms and the launches a step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.fit(it, steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [(ev.name, ev.device_time_total) for ev in prof.events()
              if ev.device_type == DeviceType.CUDA
              and not getattr(ev, "is_user_annotation", False)]
    busy = sum(us for _, us in events) / 1e3 / steps
    copies = sum(us for n, us in events if n.startswith("Memcpy")) \
        / 1e3 / steps
    return {"steps": steps, "traced_wall_ms_per_step": wall * 1e3 / steps,
            "device_busy_ms_per_step": busy,
            "copy_ms_per_step": copies,
            "idle_share": 1.0 - busy / untraced_ms,
            "idle_share_traced": 1.0 - busy / (wall * 1e3 / steps),
            "device_ops_per_step": len(events) / steps}


def phase_recommender():
    """bench.py:1121's row at RecommenderConfig's full width on the
    card's local store, its profile and host syncs, two identical runs
    compared bitwise, then a dist_sync cluster (see REC)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import recommender as rec

    _reset_kernel_counts()
    t_phase = time.perf_counter()
    ctx = mx.gpu(0)
    cfg = rec.RecommenderConfig()
    common = dict(batch=REC["batch"], shards=REC["shards"], seed=REC["seed"])
    runs, states = {}, {}
    for tag, sparse in (("sparse", True), ("dense", False),
                        ("sparse_again", True), ("dense_again", False)):
        trainer, it, res = rec_fit(ctx, cfg, mx.kv.create("local"), sparse,
                                   REC["lr"], REC["steps"],
                                   warmup=REC["warmup"], **common)
        runs[tag] = res
        states[tag] = rec_state(trainer)
        if tag == "sparse":
            untraced_ms = 1e3 * REC["batch"] / res["samples_per_s"]
            profile = _rec_profile(trainer, it, REC["profile_steps"],
                                   untraced_ms)
            syncs = count_host_syncs(
                lambda: trainer.fit(it, REC["sync_steps"]))
            sparse_trainer = trainer
        del trainer
    s, d = runs["sparse"], runs["dense"]
    ratio, dense_table_bytes = pulled_bytes_ratio(s["counter_deltas"],
                                                  d["counter_deltas"])
    ideal = s["mean_unique_rows_per_batch"] / (cfg.n_fields * cfg.vocab)
    lr0 = {}
    for tag, sparse in (("sparse", True), ("dense", False)):
        lr0[tag] = rec_fit(ctx, cfg, mx.kv.create("local"), sparse, 0.0,
                           REC["lr0_steps"], **common)[2]["losses"]
    keys = [k for t in sparse_trainer.tables.values() for k in t.keys]
    del sparse_trainer
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_rec_")
    try:
        dist = _ps_cluster("recommender", tmp, servers=REC["servers"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    dist_s = time.perf_counter() - t0
    row = {
        "phase": "recommender", "config": dict(cfg._asdict()),
        "cut": REC, "store": "local on cuda:0",
        "table_rows": cfg.n_fields * cfg.vocab,
        "table_mb": cfg.n_fields * cfg.vocab * cfg.embed_dim * 4 / 1e6,
        "samples_per_s_sparse": s["samples_per_s"],
        "samples_per_s_dense_control": d["samples_per_s"],
        "speedup_vs_dense": s["samples_per_s"] / d["samples_per_s"],
        "step_ms_sparse": 1e3 * REC["batch"] / s["samples_per_s"],
        "step_ms_dense": 1e3 * REC["batch"] / d["samples_per_s"],
        "mean_unique_rows_per_batch": s["mean_unique_rows_per_batch"],
        "pulled_bytes_sparse": s["counter_deltas"]["row_sparse_pull"],
        "pulled_bytes_dense_tables": dense_table_bytes,
        "pushed_bytes_sparse": s["counter_deltas"]["row_sparse_push"],
        "pushed_bytes_dense": d["counter_deltas"]["push"],
        "pulled_bytes_ratio": ratio, "ideal_ratio": ideal,
        "ratio_over_ideal": ratio / ideal,
        "first_last_loss_sparse": [s["losses"][0], s["losses"][-1]],
        "first_last_loss_dense": [d["losses"][0], d["losses"][-1]],
        "lr0_losses_bitwise": lr0["sparse"] == lr0["dense"],
        "lr0_max_abs_diff": max(abs(a - b) for a, b in
                                zip(lr0["sparse"], lr0["dense"])),
        "repeat": {tag: {
            "losses_bitwise": runs[tag]["losses"]
            == runs[tag + "_again"]["losses"],
            "state_bitwise": _digest_state(states[tag])
            == _digest_state(states[tag + "_again"]),
            "state_max_abs_diff": max(
                float(np.abs(states[tag][k] - states[tag + "_again"][k])
                      .max()) for k in states[tag])}
            for tag in ("sparse", "dense")},
        "profile": profile,
        "host_syncs_per_step": syncs / REC["sync_steps"],
        "dist": dist, "dist_wall_s": dist_s,
        "shard_keys": len(keys)}
    row["kernel_launches"] = _kernel_counts()
    row["wall_s"] = time.perf_counter() - t_phase
    emit(row)
    bad = []
    if not ratio <= 2 * ideal:
        bad.append("pulled-bytes ratio %g over 2x the ideal %g"
                   % (ratio, ideal))
    if not row["lr0_losses_bitwise"]:
        bad.append("the lr 0 pin")
    if not all(np.isfinite(x) for x in s["losses"] + d["losses"]):
        bad.append("a loss is not finite")
    for r in dist:
        if r["servers_used"] != list(range(REC["servers"])):
            bad.append("rank %d: the shard keys use servers %r"
                       % (r["rank"], r["servers_used"]))
        if r["push_bytes_2bit"] != r["push_bytes_2bit_expected"]:
            bad.append("rank %d: 2-bit push bytes %r, rows_wire_nbytes "
                       "%r" % (r["rank"], r["push_bytes_2bit"],
                               r["push_bytes_2bit_expected"]))
        if r["push_bytes_per_step"] != r["push_bytes_per_step_expected"]:
            bad.append("rank %d: push bytes %r, want %r" % (
                r["rank"], r["push_bytes_per_step"],
                r["push_bytes_per_step_expected"]))
    if bad:
        raise RuntimeError("recommender: %s" % bad)
    return row


def _rec_shard_push_bytes(cfg, shards, ids, compressed):
    """The row_sparse_push bytes of one sparse step on ``ids``: per field
    and shard key, its unique rows x (row bytes + 8), or the 2-bit
    ``rows_wire_nbytes`` (an empty shard moves 0 bytes)."""
    from mxnet_tpu_torch.gradient_compression import GradientCompression

    per = -(-cfg.vocab // shards)
    total = 0
    for f in range(cfg.n_fields):
        counts = np.bincount(np.unique(ids[:, f]) // per, minlength=shards)
        for c in counts:
            total += (GradientCompression.rows_wire_nbytes(c, cfg.embed_dim)
                      if compressed and c else
                      int(c) * (cfg.embed_dim * 4 + 8))
    return total


def _ps_rec_worker(kv, out_dir):
    """A ``recommender`` worker: REC's full-width sparse tier over
    dist_sync on this worker's part of the clickstream, then under 2-bit
    compression; bytes a step against the formulas."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import diagnostics
    from mxnet_tpu_torch import recommender as rec

    ctx = mx.gpu(0)
    cfg = rec.RecommenderConfig()
    nw, r = kv.num_workers, kv.rank
    trainer, it, _ = rec_fit(
        ctx, cfg, kv, True, REC["lr"], 0, REC["batch"], REC["shards"],
        REC["seed"], warmup=1, rescale=1.0 / nw, num_parts=nw,
        part_index=r,
        batches=2 + REC["dist_steps"] + REC["dist_2bit_steps"])
    ctr = {op: diagnostics.metrics.counter("mxnet_kvstore_bytes_total",
                                           labels={"op": op})
           for op in ("row_sparse_pull", "row_sparse_push")}
    out = {"rank": r, "servers_used": sorted({
        kv._server_idx(k) for t in trainer.tables.values()
        for k in t.keys})}
    for tag, steps in (("dense_wire", REC["dist_steps"]),
                       ("2bit", REC["dist_2bit_steps"])):
        if tag == "2bit":
            kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
        step_s, pulls, pushes, want = [], [], [], []
        for _ in range(steps):
            data, label, _pad = it.next_raw()
            base = {op: c.value for op, c in ctr.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.step(data[0], label[0])
            step_s.append(time.perf_counter() - t0)
            pulls.append(ctr["row_sparse_pull"].value
                         - base["row_sparse_pull"])
            pushes.append(ctr["row_sparse_push"].value
                          - base["row_sparse_push"])
            want.append(_rec_shard_push_bytes(cfg, REC["shards"], data[0],
                                              tag == "2bit"))
        if tag == "2bit":
            out.update(push_bytes_2bit=pushes,
                       push_bytes_2bit_expected=want,
                       step_ms_2bit=statistics.median(step_s) * 1e3)
        else:
            out.update(
                step_ms=statistics.median(step_s) * 1e3,
                samples_per_s_per_worker=REC["batch"]
                / statistics.median(step_s),
                pull_bytes_per_step=statistics.mean(pulls),
                push_bytes_per_step=pushes,
                push_bytes_per_step_expected=want)
    return out


def _ps_rec_num_worker(kv, out_dir):
    """A ``recommender_numerics`` worker: REC_NUM's sparse tier at half
    the batch on this worker's part (rescale 1/nw: the loss is a
    batch mean); rank 0 writes every parameter after the last step."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import recommender as rec

    cfg = rec.RecommenderConfig(**REC_NUM["cfg"])
    nw = kv.num_workers
    with np.load(Path(out_dir) / "start.npz") as f:
        start = {k: f[k] for k in f.files}
    trainer, _, res = rec_fit(
        mx.gpu(0), cfg, kv, True, REC_NUM["lr"], REC_NUM["steps"],
        REC_NUM["batch"] // nw, REC_NUM["shards"], REC_NUM["seed"],
        rescale=1.0 / nw, params=start, num_parts=nw,
        part_index=kv.rank, batches=REC_NUM["samples"] // REC_NUM["batch"])
    state = rec_state(trainer)
    if kv.rank == 0:
        np.savez(Path(out_dir) / "params.npz", **state)
    return {"losses": res["losses"]}


def _rec_num_start(cfg):
    from mxnet_tpu_torch import recommender as rec

    p = rec.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    return {k: v.numpy() for k, v in p.items()}


def decaying_sgd(**kw):
    """Planted fault: an SGD whose lazy update also decays the momentum
    of every row the gradient does not carry."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ndarray import sparse as sp

    class DecayingSGD(mx.optimizer.SGD):
        def update(self, index, weight, grad, state):
            super().update(index, weight, grad, state)
            if state is not None and isinstance(grad,
                                                sp.RowSparseNDArray):
                rest = torch.ones(state.shape[0], dtype=torch.bool,
                                  device=state._data.device)
                rest[grad._parts()["indices"]] = False
                state._data[rest] *= self.momentum
                state._bump_version()

    return DecayingSGD(**kw)


@contextlib.contextmanager
def permuted_push_rows():
    """Planted fault: every row-sparse push carries its gradient rows in
    reverse order against their ids."""
    from mxnet_tpu_torch.recommender import train

    orig = train.ShardedEmbeddingTable.push_rows

    def push_rows(self, kv, rows, values, always_all_shards=True):
        return orig(self, kv, rows, values.flip(0), always_all_shards)

    train.ShardedEmbeddingTable.push_rows = push_rows
    try:
        yield
    finally:
        train.ShardedEmbeddingTable.push_rows = orig


def rec_numerics(ctx, ref_ctx):
    """REC_NUM on ``ctx``: sparse against dense control (lr 0 and lr),
    against the same run on ``ref_ctx``, and the two planted faults
    against the clean run at momentum 0.9."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import recommender as rec

    cfg = rec.RecommenderConfig(**REC_NUM["cfg"])
    start = _rec_num_start(cfg)
    kw = dict(steps=REC_NUM["steps"], batch=REC_NUM["batch"],
              shards=REC_NUM["shards"], seed=REC_NUM["seed"], params=start,
              batches=REC_NUM["samples"] // REC_NUM["batch"])

    def run(c, sparse, lr, momentum=0.0, optimizer=None):
        trainer, _, res = rec_fit(c, cfg, mx.kv.create("local"), sparse,
                                  lr, momentum=momentum,
                                  optimizer=optimizer, **kw)
        return res["losses"], rec_state(trainer)

    s0, d0 = run(ctx, True, 0.0), run(ctx, False, 0.0)
    s1, d1 = run(ctx, True, REC_NUM["lr"]), run(ctx, False, REC_NUM["lr"])
    ref = run(ref_ctx, True, REC_NUM["lr"])
    clean_m = run(ctx, True, REC_NUM["lr"], momentum=0.9)
    decayed = run(ctx, True, REC_NUM["lr"], optimizer=decaying_sgd(
        learning_rate=REC_NUM["lr"], momentum=0.9, wd=0.0))
    with permuted_push_rows():
        permuted = run(ctx, True, REC_NUM["lr"])
    return {
        "lr0_bitwise": s0[0] == d0[0] and all(
            np.array_equal(s0[1][k], d0[1][k]) for k in start),
        "sparse_vs_dense_loss_abs": max(abs(a - b)
                                        for a, b in zip(s1[0], d1[0])),
        # numpy's allclose at rtol 1e-6, atol 1e-7
        "sparse_vs_dense_loss_close": all(
            abs(a - b) <= 1e-7 + 1e-6 * abs(b) for a, b in zip(s1[0], d1[0])),
        "sparse_vs_dense_update_err": rec_update_err(s1[1], d1[1], start),
        "vs_ref_loss_abs": max(abs(a - b) for a, b in zip(s1[0], ref[0])),
        "vs_ref_update_err": rec_update_err(s1[1], ref[1], start),
        "fault_momentum_decay_update_err":
            rec_update_err(decayed[1], clean_m[1], start),
        "fault_permuted_rows_update_err":
            rec_update_err(permuted[1], s1[1], start),
        "_sparse_state": s1[1], "_start": start}


def phase_recommender_numerics():
    """REC_NUM on the card against its dense control and the port on the
    CPU, two planted faults, and 2 workers over dist_sync against one
    local worker at the doubled batch."""
    import mxnet_tpu_torch as mx

    _reset_kernel_counts()
    t0 = time.perf_counter()
    row = {"phase": "recommender_numerics"}
    row.update(rec_numerics(mx.gpu(0), mx.cpu()))
    local, start = row.pop("_sparse_state"), row.pop("_start")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_recnum_")
    try:
        np.savez(Path(tmp) / "start.npz", **start)
        ranks = _ps_cluster("recommender_numerics", tmp,
                            servers=REC["servers"])
        with np.load(Path(tmp) / "params.npz") as f:
            dist = {k: f[k] for k in f.files}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    row.update(cut=REC_NUM,
               dtype="float32", loss_tol=REC_NUM_LOSS_TOL,
               update_tol=REC_NUM_UPDATE_TOL, fault_min=REC_FAULT_MIN,
               reference="the port on the CPU, float32",
               dist_vs_local_update_err=rec_update_err(dist, local, start),
               dist_losses=[r["losses"] for r in ranks],
               kernel_launches=_kernel_counts(),
               wall_s=time.perf_counter() - t0)
    emit(row)
    checks = {
        "lr0_bitwise": row["lr0_bitwise"],
        "sparse_vs_dense": row["sparse_vs_dense_loss_close"],
        "sparse_vs_dense_update":
            row["sparse_vs_dense_update_err"] <= REC_NUM_UPDATE_TOL,
        "vs_ref_loss": row["vs_ref_loss_abs"] <= REC_NUM_LOSS_TOL,
        "vs_ref_update": row["vs_ref_update_err"] <= REC_NUM_UPDATE_TOL,
        "dist_vs_local":
            row["dist_vs_local_update_err"] <= REC_NUM_UPDATE_TOL,
        "fault_momentum_decay":
            row["fault_momentum_decay_update_err"] >= REC_FAULT_MIN,
        "fault_permuted_rows":
            row["fault_permuted_rows_update_err"] >= REC_FAULT_MIN}
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise RuntimeError("recommender_numerics: %s failed: %r"
                           % (bad, row))
    return row


# ---------------------------------------------------------------------
# the observability tier: mx.profiler, traceview, the async checkpoint
# writer
# ---------------------------------------------------------------------
# profiler: the host cost of one nd.invoke over a chain of PROF_CHAIN
# scalar ops on a (64, 64) array, stopped and running; the ndarray
# chain at (ND_N, ND_N); PROF_BATCHES batches of the fit cell
PROF_CHAIN = 2000
PROF_BATCHES = 3
# traceview: train_lm traced for TV_LM_STEPS windows after one warmup;
# its attributed device-busy ms a step within TV_BUSY_RTOL of the
# train_lm phase's lm_profile
TV_LM_STEPS = 3
TV_BUSY_RTOL = 0.10
TV_SERVE_REQUESTS = 8
# ckpt_async: train_lm's fit for CKPT["steps"] steps with a checkpoint
# every CKPT["every"], asynchronous then blocking; the asynchronous
# shard of CKPT["resume_at"] resumed to CKPT["steps"]
CKPT = dict(steps=4, every=2, resume_at=2)
# the SIGTERM child: Module.fit of an MLP (256 -> 6144 -> 6144 -> 10)
# on the card, a checkpoint every 2 steps (~0.3 GB a shard with its
# momenta), a 20 ms pause a batch; started at the phase's outset, it
# builds its model and waits for a go file, so its start-up overlaps
# the parent's runs
CKPT_CHILD = dict(inputs=256, hidden=6144, batch=32, batches=200,
                  every=2, pause_s=0.02)
STEP_ANNOT_RE = re.compile(r"^mxnet:(step|serve):(\d+)(?::k=(\d+))?$")
TRACE_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_windows(trace):
    """Per ``mxnet:step`` window of a torch.profiler chrome trace (the
    host-side annotations, in time order): the device events (kernels,
    copies, memsets) launched inside it — by their host launch, through
    the correlation id, where the trace holds it — counted by name, and
    their device-busy ms."""
    events = trace["traceEvents"]
    wins = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in events if e.get("ph") == "X"
                  and e.get("cat") == "user_annotation"
                  and STEP_ANNOT_RE.match(str(e.get("name", ""))))
    launch = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("ph") == "X" and corr is not None and \
                e.get("cat") in ("cuda_runtime", "cuda_driver"):
            launch[corr] = float(e["ts"])
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in TRACE_DEVICE_CATS]
    out = []
    for t0, t1 in wins:
        counts, busy = {}, 0.0
        for e in dev:
            t = launch.get((e.get("args") or {}).get("correlation"),
                           float(e["ts"]))
            if t0 <= t < t1:
                counts[e["name"]] = counts.get(e["name"], 0) + 1
                busy += float(e["dur"])
        out.append({"launches": counts, "busy_ms": busy / 1e3,
                    "wall_ms": (t1 - t0) / 1e3})
    return out


def flash_launches(counts):
    """Flash-attention launches in a window's counts: forward, backward
    (one ``flash_bwd_dkv`` a backward call, beside its ``flash_bwd_dq``)
    and whether every one of them took the ``wgmma`` route."""
    flash = {k: n for k, n in counts.items() if "flash_" in k}
    return {"fwd": sum(n for k, n in flash.items() if "flash_fwd" in k),
            "bwd": sum(n for k, n in flash.items() if "flash_bwd_dkv" in k),
            "bwd_dq": sum(n for k, n in flash.items()
                          if "flash_bwd_dq" in k),
            "all_wgmma": all("wgmma" in k for k in flash)}


def collective_launches(counts):
    """NCCL kernel launches in a window's counts, by (cut) name."""
    out = {}
    for k, n in counts.items():
        if "nccl" in k.lower():
            out[k[:80]] = out.get(k[:80], 0) + n
    return out


@contextlib.contextmanager
def _trace_armed(trace_dir, steps):
    """The step tracer armed through its environment
    (``MXNET_TRACE_DIR`` / ``MXNET_TRACE_STEPS``) and re-armed; yields
    ``traceview.capture``."""
    from mxnet_tpu_torch.traceview import capture

    keys = ("MXNET_TRACE_DIR", "MXNET_TRACE_STEPS")
    saved = {k: os.environ.get(k) for k in keys}
    capture.reset()
    os.environ.update(MXNET_TRACE_DIR=str(trace_dir),
                      MXNET_TRACE_STEPS=str(steps))
    try:
        yield capture
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _captured(capture, what, timeout_s=0.0):
    """The summary the tracer wrote (waiting up to ``timeout_s`` for a
    capture finishing on another thread) and its raw trace's windows;
    raises when there is none or when the trace holds no CUDA
    activity."""
    deadline = time.monotonic() + timeout_s
    while capture.last_summary() is None and time.monotonic() < deadline:
        time.sleep(0.05)
    summ = capture.last_summary()
    if summ is None:
        raise RuntimeError("traceview: %s wrote no summary" % what)
    if summ["capture"]["device"] == "cpu" or not summ["n_device_events"]:
        raise RuntimeError("traceview: %s traced no CUDA activity: %r"
                           % (what, summ["capture"]))
    with open(summ["capture"]["trace_path"]) as f:
        wins = trace_windows(json.load(f))
    if len(wins) != summ["steps"]["n"]:
        raise RuntimeError("traceview: %s: %d windows in the trace, %d "
                           "in the summary" % (what, len(wins),
                                               summ["steps"]["n"]))
    return summ, wins


def _busy_ms(summ):
    """Attributed device-busy ms a step: every phase's mean."""
    return sum((v["mean_s"] or 0.0) for v in summ["phases"].values()) * 1e3


def _phase_ms(summ):
    return {p: (v["mean_s"] or 0.0) * 1e3 for p, v in summ["phases"].items()}


def phase_profiler():
    """``mx.profiler`` on the card: the host cost of one ``nd.invoke``
    with the profiler stopped and running (profile_sync), the ndarray
    chain at (ND_N, ND_N) and PROF_BATCHES batches of the ``fit`` cell
    (symbolic ResNet-50, batch 32, local kvstore, SGD) with the
    profiler on and the memory counters sampled; the dump's spans and
    the push byte counter against the parameters' bytes."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import profiler

    nd, ctx = mx.nd, mx.gpu(0)
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_prof_")
    try:
        x0 = nd.ones((64, 64), ctx=ctx)

        def chain():
            x = x0
            for _ in range(PROF_CHAIN // 2):
                x = x * 1.0001
                x = x + 0.0001
            return x

        chain().wait_to_read()
        host_s = {}
        for state in ("stopped", "running", "stopped_again"):
            if state == "running":
                profiler.set_config(filename=str(Path(tmp) / "chain.json"))
                profiler.set_state("run")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = chain()
            host_s[state] = time.perf_counter() - t0
            out.wait_to_read()
            if state == "running":
                profiler.set_state("stop")
                chain_ops = profiler.summary()["spans"]["operator"]

        # the ndarray chain and the fit cell, profiler on
        path = str(Path(tmp) / "profile.json")
        profiler.set_config(filename=path, profile_memory=True)
        profiler.set_state("run")
        rng = np.random.RandomState(0)
        n = ND_N
        a = nd.array(rng.randn(n, n).astype(np.float32), ctx=ctx)
        w = nd.array(rng.randn(n, n).astype(np.float32), ctx=ctx)
        c = nd.array(rng.randn(1, n).astype(np.float32), ctx=ctx)
        h = nd.dot(a, w) / float(n // 64)
        z = nd.relu(nd.broadcast_add(h, c)) * nd.sigmoid(a + w)
        m = z.mean(axis=1)
        loss = float((m * m).sum().asnumpy())
        X, y = _fit_data(FIT["batch"], FIT["image"], FIT["classes"],
                         PROF_BATCHES)
        it = mx.io.NDArrayIter(X, y, batch_size=FIT["batch"],
                               label_name="softmax_label")
        mod = mx.mod.Module(sym_resnet50(FIT["classes"]), context=ctx)
        np.random.seed(0)
        _reset_kernel_counts()
        t0 = time.perf_counter()
        mod.fit(it, num_epoch=1, optimizer="sgd", kvstore="local",
                optimizer_params=(("learning_rate", FIT["lr"]),
                                  ("momentum", FIT["momentum"])),
                initializer=mx.init.Xavier())
        fit_s = time.perf_counter() - t0
        it.reset()
        mod.forward(it.next(), is_train=False)
        mod.get_outputs()[0].wait_to_read()
        launches = _kernel_counts()
        profiler.set_state("stop")          # dumps the trace
        summ = profiler.summary()
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        if profiler.is_running():
            profiler.set_state("stop")
        profiler.set_config()
        shutil.rmtree(tmp, ignore_errors=True)
    spans = {}
    for e in events:
        if e.get("ph") == "X":
            spans[e["name"]] = spans.get(e["name"], 0) + 1
    last = {}
    for e in events:
        if e.get("ph") == "C":
            last[e["name"]] = e["args"][e["name"]]
    arg_params, _ = mod.get_params()
    param_bytes = sum(v.size * 4 for v in arg_params.values())
    out_name = mod.symbol.list_outputs()[0]
    want_spans = ["dot", "relu", "sigmoid", "Forward<%s>" % out_name,
                  "Backward<%s>" % out_name, "Module::update",
                  "SGD::update", "KVStore::Push", "KVStore::Pull",
                  "NDArrayIter::next"]
    top = sorted(((n, s["total_ms"], s["count"])
                  for cat in summ["spans"].values()
                  for n, s in cat.items()), key=lambda r: -r[1])[:10]
    row = {"phase": "profiler", "chain_invokes": PROF_CHAIN,
           "host_us_per_invoke": {k: v / PROF_CHAIN * 1e6
                                  for k, v in host_s.items()},
           "profile_sync": True,
           "chain_spans": {k: v["count"] for k, v in chain_ops.items()},
           "ndarray_loss": loss,
           "fit": {"batches": PROF_BATCHES, "batch": FIT["batch"],
                   "kvstore": "local", "seconds": fit_s},
           "span_counts": {k: spans.get(k, 0) for k in want_spans},
           "n_span_names": len(spans), "n_events": len(events),
           "push_bytes": last.get("kvstore:push_bytes"),
           "pull_bytes": last.get("kvstore:pull_bytes"),
           "param_bytes": param_bytes,
           "push_bytes_want": param_bytes * PROF_BATCHES,
           "memory_peak_bytes": last.get("memory:peak_bytes_in_use"),
           "backward_ms": summ["spans"]["symbolic"][
               "Backward<%s>" % out_name]["avg_ms"],
           "backward_ms_min": summ["spans"]["symbolic"][
               "Backward<%s>" % out_name]["min_ms"],
           "update_ms": summ["spans"]["optimizer"]["Module::update"][
               "avg_ms"],
           "top_spans_ms": [[n[:60], ms, cnt] for n, ms, cnt in top],
           "kernel_launches": launches,
           "wall_s": time.perf_counter() - t_phase}
    emit(row)
    missing = [k for k in want_spans if not spans.get(k)]
    if missing:
        raise RuntimeError("profiler: the dump lacks spans %r" % missing)
    if row["push_bytes"] != row["push_bytes_want"]:
        raise RuntimeError("profiler: kvstore:push_bytes %r != the "
                           "parameters' bytes x batches %r"
                           % (row["push_bytes"], row["push_bytes_want"]))
    if spans["Backward<%s>" % out_name] != PROF_BATCHES or \
            spans["Module::update"] != PROF_BATCHES:
        raise RuntimeError("profiler: %r steps stamped for %d batches"
                           % (row["span_counts"], PROF_BATCHES))
    if row["chain_spans"] != {"_mul_scalar": PROF_CHAIN // 2,
                              "_plus_scalar": PROF_CHAIN // 2}:
        raise RuntimeError("profiler: the chain stamped %r"
                           % (row["chain_spans"],))
    if not row["memory_peak_bytes"]:
        raise RuntimeError("profiler: no memory counter on the card")
    return row


def _tv_dp_rank(trace_dir):
    """traceview's dp cell on this process's rank: the bucketed
    ResNet-50 bf16 step over the process group, one untraced and one
    traced window."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import dist, gluon
    from mxnet_tpu_torch.parallel.dp import FusedTrainStep
    from mxnet_tpu_torch.parallel.mesh import data_parallel_mesh

    mesh = data_parallel_mesh()
    ctx = mx.gpu(dist.device().index)
    net = resnet50(ctx)
    data, label = train_batch(DP["batch"] * mesh.size, ctx)
    step = FusedTrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                          mesh=mesh, learning_rate=TRAIN_LR,
                          momentum=TRAIN_MOMENTUM, dtype="bfloat16")
    with _trace_armed(trace_dir, 1) as capture:
        for _ in range(2):
            step.run_steps(data, label, steps=1).asnumpy()
        summ, wins = _captured(capture, "dp")
    with open(summ["capture"]["trace_path"]) as f:
        names = [e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"
                 and str(e.get("name", "")).startswith("mxbkt")]
    return {"summary": summ, "windows": wins,
            "plan": step.bucket_accounting(),
            "bucket_scopes": sorted(set(names))}


def phase_traceview(lm_row):
    """``traceview`` on the card through its environment: 3 windows of
    ``train_lm`` (the flash launches a step, all wgmma, read from the
    trace; the attributed device-busy ms against ``lm_profile``'s),
    then one window each of ResNet-50 ``FusedTrainStep`` at batch 32,
    of the serving generation tier, and of the ``dp`` cell at one NCCL
    rank with its buckets (the bucket reduces found against the plan,
    the other collectives by name).  Every trace must hold the kernel
    of every launch in its windows."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import dist, gluon, serving
    from mxnet_tpu_torch.parallel.dp import FusedTrainStep
    from mxnet_tpu_torch.transformer import TransformerTrainStep
    from mxnet_tpu_torch.transformer import model as tm

    t_phase = time.perf_counter()
    ctx = mx.gpu(0)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_tv_"))
    row = {"phase": "traceview"}
    failed = []        # checked after the row is printed
    try:
        # train_lm
        cfg = lm_config()
        step = TransformerTrainStep(cfg, learning_rate=LM["lr"],
                                    momentum=LM["momentum"],
                                    remat=LM["remat"], seed=0)
        it = lm_iter(cfg, LM["batch"], LM["seq"], LM_SEQUENCES)
        step.bucket_plan_meta()
        _reset_kernel_counts()
        with _trace_armed(tmp / "lm", TV_LM_STEPS) as capture:
            for _ in range(TV_LM_STEPS + 1):
                b = it.next()
                step.step(b.data[0], b.label[0])
            torch.cuda.synchronize()
            summ, wins = _captured(capture, "train_lm")
        lm_launches = _kernel_counts()
        # lm_profile of the same step right after, so the card's clocks
        # are the capture's
        ref = lm_profile(step, it, LM_PROFILE_STEPS,
                         lm_row["step_ms"])["device_busy_ms_per_step"]
        del step
        flash = [flash_launches(w["launches"]) for w in wins]
        busy = _busy_ms(summ)
        row["train_lm"] = {
            "steps": summ["steps"]["n"], "flash_per_window": flash,
            "busy_ms_per_step": busy, "lm_profile_busy_ms": ref,
            "busy_vs_lm_profile": busy / ref,
            "train_lm_row_lm_profile_busy_ms":
                lm_row["profile"]["device_busy_ms_per_step"],
            "window_busy_ms": [w["busy_ms"] for w in wins],
            "window_wall_ms": [w["wall_ms"] for w in wins],
            "phase_ms_per_step": _phase_ms(summ),
            "lost_launches": summ["capture"]["lost_launches"],
            "idle_share_traced": 1.0 - busy / (summ["steps"]["mean_s"]
                                               * 1e3),
            "launches_per_step": sum(sum(w["launches"].values())
                                     for w in wins) / len(wins),
            "capture_cost_s": summ["capture"]["capture_cost_s"],
            "kernel_launches": lm_launches}
        n_layers = cfg.n_layers
        if summ["steps"]["n"] != TV_LM_STEPS or any(
                f["fwd"] != n_layers or f["bwd"] != n_layers
                or f["bwd_dq"] != n_layers or not f["all_wgmma"]
                for f in flash):
            failed.append("train_lm windows %r (want %d steps of %d wgmma "
                          "forward and backward launches)"
                          % (flash, TV_LM_STEPS, n_layers))
        if abs(busy / ref - 1.0) > TV_BUSY_RTOL:
            failed.append("train_lm busy %.3f ms a step against "
                          "lm_profile's %.3f" % (busy, ref))

        # ResNet-50 FusedTrainStep at batch 32
        net = resnet50(ctx)
        rn = FusedTrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                            learning_rate=TRAIN_LR,
                            momentum=TRAIN_MOMENTUM, dtype="bfloat16")
        data, label = train_batch(32, ctx)
        with _trace_armed(tmp / "rn", 1) as capture:
            for _ in range(2):
                rn.run_steps(data, label, steps=1).asnumpy()
            summ, wins = _captured(capture, "FusedTrainStep")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rn.run_steps(data, label, steps=3).asnumpy()
        untraced_ms = (time.perf_counter() - t0) / 3 * 1e3
        del rn, net
        busy = _busy_ms(summ)
        row["resnet50_b32"] = {
            "steps": summ["steps"]["n"], "workload": summ["workload"],
            "busy_ms_per_step": busy,
            "wall_ms_per_step_traced": summ["steps"]["mean_s"] * 1e3,
            "step_ms_untraced": untraced_ms,
            "idle_share": 1.0 - busy / untraced_ms,
            "idle_share_traced": 1.0 - busy / (summ["steps"]["mean_s"]
                                               * 1e3),
            "phase_ms_per_step": _phase_ms(summ),
            "lost_launches": summ["capture"]["lost_launches"],
            "launches_per_step": sum(wins[0]["launches"].values())}
        for p in ("forward", "backward", "optimizer"):
            if not row["resnet50_b32"]["phase_ms_per_step"][p] > 0:
                failed.append("ResNet-50's %s phase is empty" % p)

        # the serving generation tier at the serve cell's width
        scfg = tm.TransformerConfig(dtype="bfloat16",
                                    param_dtype="bfloat16", **GPT2_SMALL)
        params = tm.init_params(torch.Generator().manual_seed(0), scfg)
        rt = serving.GenerationRuntime("gpt2_small", params, scfg, **SERVE)
        srv = serving.ModelServer()
        srv.add_generator(rt)
        rng = np.random.RandomState(1)
        prompts = [rng.randint(1, scfg.vocab_size, size=int(n)) for n in
                   np.linspace(16, SERVE["max_prompt"], TV_SERVE_REQUESTS)]
        _reset_kernel_counts()
        pb0 = rt.engine.prefill_batches
        with _trace_armed(tmp / "serve", 1) as capture:
            reqs = [srv.submit_generation("gpt2_small", p,
                                          max_new=SERVE["max_new"],
                                          deadline_ms=None)
                    for p in prompts]
            results = [r.wait(600.0) for r in reqs]
            summ, wins = _captured(capture, "serving", timeout_s=60.0)
        serve_launches = _kernel_counts()
        prefill_batches = rt.engine.prefill_batches - pb0
        drain = srv.drain(timeout_s=60.0)
        del srv, rt, params
        flash = flash_launches(wins[0]["launches"])
        row["serve"] = {
            "workload": summ["workload"], "steps": summ["steps"]["n"],
            "requests": len(prompts),
            "requests_ok": sum(len(r["tokens"]) == SERVE["max_new"]
                               for r in results),
            "window_flash": flash,
            "window_busy_ms": wins[0]["busy_ms"],
            "window_wall_ms": wins[0]["wall_ms"],
            "window_launches": sum(wins[0]["launches"].values()),
            "lost_launches": summ["capture"]["lost_launches"],
            "prefill_batches": prefill_batches,
            "drained": drain["drained"], "kernel_launches": serve_launches}
        if row["serve"]["requests_ok"] != len(prompts):
            failed.append("serving answered %d of %d"
                          % (row["serve"]["requests_ok"], len(prompts)))
        if not (flash["fwd"] > 0 and flash["fwd"] % scfg.n_layers == 0
                and flash["all_wgmma"]):
            failed.append("the traced serving tick holds %r flash "
                          "launches (want a positive multiple of %d, all "
                          "wgmma)" % (flash, scfg.n_layers))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # the dp cell at one NCCL rank, bucketed: this process joins a
    # one-rank group for it (a spawned rank costs a new process's start)
    dtmp = tempfile.mkdtemp(prefix="chip_smoke_tvdp_")
    try:
        dist.initialize(init_method="file://" + os.path.join(dtmp, "rdv"),
                        num_processes=1, process_id=0, backend="nccl")
        res = _tv_dp_rank(os.path.join(dtmp, "tv"))
    finally:
        dist.shutdown()
        shutil.rmtree(dtmp, ignore_errors=True)
    summ, wins = res["summary"], res["windows"]
    row["dp"] = {
        "ranks": 1, "backend": "nccl", "batch_per_rank": DP["batch"],
        "plan_buckets": len(res["plan"] or ()),
        "bucket_scopes_in_trace": len(res["bucket_scopes"]),
        "bucket_reduces_found": len(summ["buckets"]),
        "plan_match": summ["plan_match"], "bucket_map": summ["bucket_map"],
        "bucket_reduce_ms_per_step":
            (summ["phases"]["bucket_reduce"]["mean_s"] or 0.0) * 1e3,
        "collectives_per_step": collective_launches(wins[0]["launches"]),
        "busy_ms_per_step": _busy_ms(summ),
        "phase_ms_per_step": _phase_ms(summ),
        "lost_launches": summ["capture"]["lost_launches"]}
    row["wall_s"] = time.perf_counter() - t_phase
    emit(row)
    for key in ("train_lm", "resnet50_b32", "serve", "dp"):
        if any(row[key]["lost_launches"]):
            failed.append("the %s trace lost the kernels of %r launches "
                          "in its windows" % (key,
                                              row[key]["lost_launches"]))
    if row["dp"]["bucket_scopes_in_trace"] != row["dp"]["plan_buckets"]:
        failed.append("dp's trace holds %d bucket scopes for a plan of %d"
                      % (row["dp"]["bucket_scopes_in_trace"],
                         row["dp"]["plan_buckets"]))
    if failed:
        raise RuntimeError("traceview: %s" % "; ".join(failed))
    return row


def ckpt_child_main(ckdir) -> None:
    """This script as the ``ckpt_async`` SIGTERM child
    (``--ckpt-child``): ``Module.fit`` on the card with a checkpoint
    every CKPT_CHILD["every"] steps on the asynchronous writer, paced by
    a short pause a batch, until the parent's SIGTERM."""
    import mxnet_tpu_torch as mx

    c = CKPT_CHILD
    go = os.path.join(os.path.dirname(ckdir), "go")
    rng = np.random.RandomState(0)
    X = rng.rand(c["batch"] * c["batches"], c["inputs"]).astype(np.float32)
    y = rng.randint(0, 10, len(X)).astype(np.float32)
    x = mx.sym.Variable("data")
    for i in (1, 2):
        x = mx.sym.Activation(mx.sym.FullyConnected(
            x, num_hidden=c["hidden"], name="fc%d" % i), act_type="relu")
    x = mx.sym.FullyConnected(x, num_hidden=10, name="fc3")
    mod = mx.mod.Module(mx.sym.SoftmaxOutput(x, name="softmax"),
                        context=mx.gpu(0))
    it = mx.io.NDArrayIter(X, y, batch_size=c["batch"])
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(mx.init.Xavier())
    torch.cuda.synchronize()
    with open(go + ".ready", "w"):
        pass
    deadline = time.monotonic() + 600
    while not os.path.exists(go):
        if time.monotonic() > deadline:
            raise SystemExit("ckpt child: no go file")
        time.sleep(0.01)
    mod.fit(it, num_epoch=1,
            optimizer_params=(("learning_rate", 0.01), ("momentum", 0.9)),
            checkpoint_every_n=c["every"], checkpoint_dir=ckdir,
            batch_end_callback=lambda _p: time.sleep(c["pause_s"]))


def _ckpt_child_start():
    """Start the SIGTERM child (it builds its model, then waits for the
    go file); returns its handle."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckterm_")
    log = open(os.path.join(tmp, "child.log"), "w+")
    child = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--ckpt-child",
         os.path.join(tmp, "ck")],
        stdout=log, stderr=subprocess.STDOUT,
        env=dict(os.environ, MXNET_CKPT_ASYNC="1"))
    return {"child": child, "tmp": tmp, "log": log,
            "t0": time.perf_counter()}


def _ckpt_child_stop(handle) -> None:
    child = handle["child"]
    if child.poll() is None:
        child.kill()
        child.wait()
    handle["log"].close()
    shutil.rmtree(handle["tmp"], ignore_errors=True)


def _ckpt_sigterm(handle):
    """The SIGTERM child: let it fit, wait for a shard's ``.tmp`` (the
    writer thread busy), send SIGTERM, expect exit 83 and a complete
    verified directory."""
    import signal

    from mxnet_tpu_torch import checkpoint as ck

    child, tmp, log = handle["child"], handle["tmp"], handle["log"]
    ckdir = os.path.join(tmp, "ck")
    try:
        deadline = time.monotonic() + 180
        while not os.path.exists(os.path.join(tmp, "go.ready")):
            if child.poll() is not None or time.monotonic() > deadline:
                raise RuntimeError("ckpt_async: the child did not get "
                                   "ready (exit %r)" % child.poll())
            time.sleep(0.01)
        ready_s = time.perf_counter() - handle["t0"]
        with open(os.path.join(tmp, "go"), "w"):
            pass
        seen = None
        deadline = time.monotonic() + 120
        while seen is None and child.poll() is None:
            if time.monotonic() > deadline:
                raise RuntimeError("ckpt_async: the child's writer never "
                                   "started a shard")
            for root, _, files in os.walk(ckdir):
                if any(f.endswith(".ckpt.tmp") for f in files):
                    seen = os.path.basename(root)
                    break
            time.sleep(0.002)
        t_sig = time.perf_counter()
        child.send_signal(signal.SIGTERM)
        rc = child.wait(timeout=120)
        exit_s = time.perf_counter() - t_sig
        log.seek(0)
        tail = log.read()[-2000:]
        report = ck.verify_dir(ckdir) if os.path.isdir(ckdir) else None
        latest = ck.latest_step(ckdir) if report else None
        leftovers = [f for _, _, files in os.walk(ckdir) for f in files
                     if f.endswith(".tmp")]
    finally:
        _ckpt_child_stop(handle)
    out = {"writing_when_signalled": seen, "exit_code": rc,
           "exit_s_after_sigterm": exit_s, "child_ready_s": ready_s,
           "child_s": time.perf_counter() - handle["t0"],
           "latest_step": latest, "verified_steps":
               report["n_verified"] if report else 0,
           "verify_ok": bool(report and report["ok"]),
           "tmp_left": leftovers}
    if rc != 83 or seen is None or not out["verify_ok"] or \
            latest is None or leftovers:
        raise RuntimeError("ckpt_async: the SIGTERM drain failed: %r\n%s"
                           % (out, tail))
    return out


def phase_ckpt_async():
    """``TransformerTrainStep.fit`` at the ``train_lm`` cell's width with
    a checkpoint every CKPT["every"] steps, on the asynchronous writer
    and then blocking: ``save()``'s return time, the blocking save's
    time, ``wait()``'s time, the step ms while a write is in flight
    against steady steps; the asynchronous shard bitwise the blocking
    one and verified; a resume from it bitwise the uninterrupted run;
    a SIGTERM to a child fit while its writer writes."""
    from mxnet_tpu_torch import checkpoint as ck
    from mxnet_tpu_torch.transformer import TransformerTrainStep

    t_phase = time.perf_counter()
    cfg = lm_config()
    B, T = LM["batch"], LM["seq"]
    managers, timing = [], {"save_s": [], "wait_s": []}
    real_save, real_wait = ck.CheckpointManager.save, \
        ck.CheckpointManager.wait

    def save(self, *a, **k):
        if self not in managers:
            managers.append(self)
        t0 = time.perf_counter()
        out = real_save(self, *a, **k)
        timing["save_s"].append(time.perf_counter() - t0)
        return out

    def wait(self, *a, **k):
        t0 = time.perf_counter()
        out = real_wait(self, *a, **k)
        timing["wait_s"].append(time.perf_counter() - t0)
        return out

    def run(async_write, steps, ckdir=None, resume=None, seed=0):
        os.environ["MXNET_CKPT_ASYNC"] = "1" if async_write else "0"
        st = TransformerTrainStep(cfg, learning_rate=LM["lr"],
                                  momentum=LM["momentum"],
                                  remat=LM["remat"], seed=seed)
        st.bucket_plan_meta()
        real_step, step_ms = st.step, []

        def timed(tokens, labels):
            inflight = any(m._q.unfinished_tasks for m in managers)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real_step(tokens, labels)
            torch.cuda.synchronize()
            step_ms.append([inflight, (time.perf_counter() - t0) * 1e3])
            return out

        st.step = timed
        del managers[:]
        timing["save_s"], timing["wait_s"] = [], []
        t0 = time.perf_counter()
        losses = st.fit(lm_iter(cfg, B, T, LM_SEQUENCES), steps,
                        checkpoint_every_n=None if resume else CKPT["every"],
                        checkpoint_dir=ckdir, resume_from=resume)
        return {"losses": losses, "wall_s": time.perf_counter() - t0,
                "step_ms": step_ms, "save_s": list(timing["save_s"]),
                "wait_s": list(timing["wait_s"]),
                "params": st.params_numpy()}

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    saved_env = os.environ.get("MXNET_CKPT_ASYNC")
    handle = _ckpt_child_start()
    ck.CheckpointManager.save, ck.CheckpointManager.wait = save, wait
    try:
        d_async, d_block = (os.path.join(tmp, n) for n in ("a", "b"))
        _reset_kernel_counts()
        arun = run(True, CKPT["steps"], d_async)
        launches = _kernel_counts()
        brun = run(False, CKPT["steps"], d_block)
        resumed = run(True, CKPT["steps"], resume=os.path.join(
            d_async, "step_%08d" % CKPT["resume_at"]), seed=1)
        report = ck.verify_dir(d_async)
        sa = ck.load_checkpoint(d_async, step=CKPT["steps"])
        sb = ck.load_checkpoint(d_block, step=CKPT["steps"])
    except BaseException:
        _ckpt_child_stop(handle)
        raise
    finally:
        ck.CheckpointManager.save, ck.CheckpointManager.wait = \
            real_save, real_wait
        if saved_env is None:
            os.environ.pop("MXNET_CKPT_ASYNC", None)
        else:
            os.environ["MXNET_CKPT_ASYNC"] = saved_env
        shutil.rmtree(tmp, ignore_errors=True)

    def same(x, y):
        if isinstance(x, torch.Tensor):
            return isinstance(y, torch.Tensor) and torch.equal(
                x.view(torch.int16), y.view(torch.int16))
        return np.asarray(x).tobytes() == np.asarray(y).tobytes()

    shard_differs = sorted(
        k for k in sb["params"] if not same(sa["params"][k], sb["params"][k]))
    # steady: no write in flight (the async run's, and the blocking
    # run's steps, whose saves run between steps), first steps aside
    steady = [ms for busy, ms in arun["step_ms"][1:] + brun["step_ms"][1:]
              if not busy]
    inflight = [ms for busy, ms in arun["step_ms"] if busy]
    at = CKPT["resume_at"]
    resume_differs = sorted(k for k in brun["params"] if not np.array_equal(
        resumed["params"][k], brun["params"][k]))
    term = _ckpt_sigterm(handle)
    shard_bytes = sum(np.asarray(v).nbytes if not isinstance(
        v, torch.Tensor) else v.numel() * v.element_size()
        for v in sa["params"].values()) + len(sa["optimizer_states"] or b"")
    row = {"phase": "ckpt_async", "config": "train_lm (GPT-2 small width, "
           "bf16 over float32 parameters, 8 x 1024)", "ckpt": CKPT,
           "shard_bytes": shard_bytes,
           "async_save_return_s": arun["save_s"],
           "blocking_save_s": brun["save_s"],
           "async_wait_s": arun["wait_s"],
           "async_fit_s": arun["wall_s"], "blocking_fit_s": brun["wall_s"],
           "step_ms_steady_median": statistics.median(steady)
           if steady else None,
           "step_ms_write_in_flight_median": statistics.median(inflight)
           if inflight else None,
           "step_ms": arun["step_ms"],
           "blocking_step_ms": [ms for _, ms in brun["step_ms"]],
           "losses_equal": arun["losses"] == brun["losses"],
           "shard_params_differ": shard_differs,
           "shard_optimizer_states_equal":
               sa["optimizer_states"] == sb["optimizer_states"],
           "verify": {k: report[k] for k in ("ok", "n_steps",
                                             "n_verified")},
           "resume": {"from_step": at, "losses_equal":
                      resumed["losses"] == brun["losses"][at:],
                      "params_differ": resume_differs},
           "sigterm": term, "kernel_launches": launches,
           "wall_s": time.perf_counter() - t_phase}
    emit(row)
    if not (row["losses_equal"] and not shard_differs
            and row["shard_optimizer_states_equal"]):
        raise RuntimeError("ckpt_async: the asynchronous shard is not the "
                           "blocking one bitwise: %r" % (row,))
    if not (report["ok"] and report["n_verified"] == report["n_steps"]
            == CKPT["steps"] // CKPT["every"]):
        raise RuntimeError("ckpt_async: the asynchronous directory does "
                           "not verify: %r" % (report,))
    if not (row["resume"]["losses_equal"] and not resume_differs):
        raise RuntimeError("ckpt_async: the resume from the asynchronous "
                           "shard is not bitwise: %r" % (row["resume"],))
    if not inflight:
        raise RuntimeError("ckpt_async: no step ran with a write in "
                           "flight: %r" % (arun["step_ms"],))
    return row


# the tuning phase: the sweep, the autotuner on the dp cell, the auditor
TUNE = dict(sweep_counts=(1, 2), sweep_steps=3, sweep_batch=8,
            sweep_image=32, sweep_classes=8, dp_batch=32, windows=1,
            chips=8, fit_batches=2, budget_s=60.0)
#: the link a tuned plan is scored for: NVLink between H100 SXM cards.
#: One card measures no collective, so the figure is given, with its
#: source; tools/torch_autotune_scale.py measures NCCL over it
TUNE_LINK_GBPS = 450.0
TUNE_LINK_SOURCE = ("NVIDIA H100 SXM datasheet: NVLink 900 GB/s total "
                    "bandwidth a card, 450 GB/s each way (explicit, not "
                    "measured here)")


def _bucket_scopes(trace_path):
    """The distinct ``mxbkt`` annotations of a trace."""
    with open(trace_path) as f:
        return sorted({e["name"] for e in json.load(f)["traceEvents"]
                       if e.get("cat") == "user_annotation"
                       and str(e.get("name", "")).startswith("mxbkt")})


def _tuning_dp_rank(tmp):
    """The ``dp`` cell at TUNE["dp_batch"] on this rank: untuned (traced,
    audited), tuned from its summary, then under the plan file and the
    plan directory (one traced window each, three in all); each run
    from the same weights and batch."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autotune, dist, gluon
    from mxnet_tpu_torch.analysis import auditor
    from mxnet_tpu_torch.autotune import plan as aplan
    from mxnet_tpu_torch.autotune import search, timing
    from mxnet_tpu_torch.parallel import scaling
    from mxnet_tpu_torch.parallel.dp import FusedTrainStep
    from mxnet_tpu_torch.parallel.mesh import data_parallel_mesh

    # bitwise across runs: the same convolution algorithms every time
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    tmp = Path(tmp)
    mesh = data_parallel_mesh()
    ctx = mx.gpu(dist.device().index)
    data, label = train_batch(TUNE["dp_batch"] * mesh.size, ctx)
    knobs = ("MXNET_AUTOTUNE_PLAN", "MXNET_AUTOTUNE_DIR")

    def run(tag, env, audit=False):
        saved = {k: os.environ.pop(k, None) for k in knobs}
        os.environ.update(env)
        try:
            step = FusedTrainStep(resnet50(ctx),
                                  gluon.loss.SoftmaxCrossEntropyLoss(),
                                  mesh=mesh, learning_rate=TRAIN_LR,
                                  momentum=TRAIN_MOMENTUM,
                                  dtype="bfloat16")
            with _trace_armed(tmp / tag, TUNE["windows"]) as capture:
                losses = [float(step(data, label)[0].asnumpy())
                          for _ in range(TUNE["windows"] + 1)]
                summ, _wins = _captured(capture, "tuning " + tag)
            out = {"losses": [float(v) for v in losses],
                   "loss_bits": [np.float32(v).tobytes().hex()
                                 for v in losses],
                   "summary": summ,
                   "scopes": _bucket_scopes(summ["capture"]["trace_path"]),
                   "plan_meta": step.bucket_plan_meta(),
                   "entries": step.grad_entries()}
            if audit:
                rep = auditor.audit_recorded_steps()
                out["audit"] = {"sites": rep.sites,
                                "new": [f.fingerprint()
                                        for f in rep.findings]}
            return out
        finally:
            for k in knobs:
                os.environ.pop(k, None)
                if saved[k] is not None:
                    os.environ[k] = saved[k]

    base = run("untuned", {}, audit=True)
    from_summary = timing.from_trace(base["summary"])
    # the tuned model: the summary's measured step time (and overlap,
    # where a collective ran) over the step's own gradient leaves, so
    # the scored plan is the one buckets.partition builds
    leaves = list(reversed(base["entries"]))
    model = timing.TimingModel(
        [(b, dt) for b, (_k, _s, dt) in zip(
            scaling.grad_leaf_bytes(leaves), leaves)], "leaf",
        step_time_s=from_summary.step_time_s,
        source=dict(from_summary.source, granularity="leaf"))
    model.measured_overlap_frac = from_summary.measured_overlap_frac
    kw = dict(chips=TUNE["chips"], ici_GBps=TUNE_LINK_GBPS)
    tuned_summary = search.tune(from_summary, **kw)
    tuned = search.tune(model, **kw)
    path = aplan.save_plan(tuned, str(tmp / "plan.json"))
    planned = run("plan", {"MXNET_AUTOTUNE_PLAN": path})
    pdir = tmp / "plans"
    dir_path = aplan.save_plan(tuned, aplan.default_plan_path(
        tuned, str(pdir)))
    dirrun = run("dir", {"MXNET_AUTOTUNE_DIR": str(pdir)})
    assert autotune.load_plan(dir_path)["cap_bytes"] == tuned["cap_bytes"]

    def brief(r):
        s = r["summary"]
        return {"losses": r["losses"], "loss_bits": r["loss_bits"],
                "scopes": len(r["scopes"]),
                "n_buckets": r["plan_meta"]["n_buckets"],
                "autotune": r["plan_meta"].get("autotune"),
                "step_ms": s["steps"]["mean_s"] * 1e3,
                "busy_ms": _busy_ms(s), "plan_match": s["plan_match"],
                "lost_launches": s["capture"]["lost_launches"]}

    return {"untuned": dict(brief(base), audit=base["audit"]),
            "plan": dict(brief(planned), plan_path=path),
            "dir": dict(brief(dirrun), plan_path=dir_path),
            "tuned": {k: tuned[k] for k in ("cap_bytes", "first_cap_bytes",
                                            "last_cap_bytes", "n_buckets",
                                            "score", "assumptions")},
            "tuned_from_summary": {
                k: tuned_summary[k] for k in ("cap_bytes",
                                              "first_cap_bytes",
                                              "last_cap_bytes",
                                              "n_buckets")},
            "summary_model": {"n_units": from_summary.n_units,
                              "step_time_s": from_summary.step_time_s,
                              "measured_GBps": from_summary.measured_GBps,
                              "granularity": from_summary.granularity}}


def _tuning_audit_steps():
    """The steps the audit reads, built and run once on the card in this
    process: ``train_lm`` (GPT-2-small width, bf16), ResNet-50 bf16
    ``FusedTrainStep`` at batch 32 on one device, and the symbolic
    ResNet-50's bulk fit (K = TUNE["fit_batches"]).  Returned to keep
    them alive (the recorded-step list holds them weakly)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import engine, gluon
    from mxnet_tpu_torch.parallel.dp import FusedTrainStep
    from mxnet_tpu_torch.transformer import TransformerTrainStep

    ctx = mx.gpu(0)
    cfg = lm_config()
    lm = TransformerTrainStep(cfg, learning_rate=LM["lr"],
                              momentum=LM["momentum"], remat=LM["remat"],
                              seed=0)
    b = lm_iter(cfg, LM["batch"], LM["seq"], LM_SEQUENCES).next()
    lm.step(b.data[0], b.label[0]).item()
    rn = FusedTrainStep(resnet50(ctx), gluon.loss.SoftmaxCrossEntropyLoss(),
                        learning_rate=TRAIN_LR, momentum=TRAIN_MOMENTUM,
                        dtype="bfloat16")
    data, label = train_batch(TUNE["dp_batch"], ctx)
    rn(data, label)[0].asnumpy()
    X, y = _fit_data(FIT["batch"], FIT["image"], FIT["classes"],
                     TUNE["fit_batches"])
    it = mx.io.NDArrayIter(X, y, batch_size=FIT["batch"],
                           label_name="softmax_label")
    mod = mx.mod.Module(sym_resnet50(FIT["classes"]), context=ctx)
    np.random.seed(0)
    prev = engine.set_bulk_size(TUNE["fit_batches"])
    try:
        mod.fit(it, num_epoch=1, optimizer="sgd",
                optimizer_params=(("learning_rate", FIT["lr"]),
                                  ("momentum", FIT["momentum"])),
                initializer=mx.init.Xavier())
    finally:
        engine.set_bulk_size(prev)
    torch.cuda.synchronize()
    return lm, rn, mod


def phase_tuning():
    """The tuning and analysis tier on the card: the rank sweep, the
    autotuner's loop on the ``dp`` cell (a one-rank NCCL child), the
    auditor over the steps built here, and both self-tests (run as
    subprocesses beside the rest)."""
    from mxnet_tpu_torch import diagnostics, dist
    from mxnet_tpu_torch.analysis import auditor
    from mxnet_tpu_torch.parallel import scaling

    t_phase = time.perf_counter()
    selftests = {name: subprocess.Popen(
        [sys.executable, "-m", "mxnet_tpu_torch.%s" % name, "--self-test"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in ("analysis", "autotune")}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    got, took = {}, {}

    def background(name, fn):
        # the sweep's ranks and the dp child run in processes of their
        # own, beside this process's audit: the phase's wall is theirs
        def run():
            t0 = time.perf_counter()
            try:
                got[name] = fn()
            except BaseException as exc:     # re-raised below
                got[name] = exc
            took[name] = time.perf_counter() - t0
        th = threading.Thread(target=run, name="tuning-" + name)
        th.start()
        return th

    try:
        _reset_kernel_counts()
        threads = [
            background("sweep", lambda: scaling.sweep(
                TUNE["sweep_counts"], steps=TUNE["sweep_steps"],
                batch=TUNE["sweep_batch"], device="cuda:0", backend="gloo",
                model="resnet18_v1", classes=TUNE["sweep_classes"],
                image=TUNE["sweep_image"], timeout=300)),
            background("dp", lambda: dist.launch(
                _tuning_dp_rank, 1, (tmp,), backend="nccl",
                timeout_s=300)[0])]
        t0 = time.perf_counter()
        diagnostics.reset_recompile_stats()
        keep = _tuning_audit_steps()
        report = auditor.audit_recorded_steps()
        del keep
        audit_s = time.perf_counter() - t0
        launches = _kernel_counts()
        for th in threads:
            th.join()
        for name in ("sweep", "dp"):
            if isinstance(got.get(name), BaseException):
                raise got[name]
        sw, dp = got["sweep"], got["dp"]
        sweep_s, dp_s = took["sweep"], took["dp"]
        tests = {}
        for name, proc in selftests.items():
            out, _ = proc.communicate(timeout=120)
            tests[name] = {"rc": proc.returncode,
                           "last": out.strip().splitlines()[-1][:200]
                           if out.strip() else ""}
    finally:
        for proc in selftests.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    points = {r["n"]: r for r in sw["sweep"]}
    row = {"phase": "tuning",
           "sweep": {"model": "resnet18_v1", "classes": TUNE["sweep_classes"],
                     "global_batch": TUNE["sweep_batch"],
                     "steps": TUNE["sweep_steps"],
                     "backend": "gloo on cuda:0",
                     "losses": {n: r["losses"] for n, r in points.items()},
                     "first_step_rel_err": {
                         n: r.get("first_step_rel_err")
                         for n, r in points.items() if n != 1},
                     "consistent": {n: r.get("numerically_consistent")
                                    for n, r in points.items() if n != 1},
                     "collectives_per_step": {
                         n: {v: {k: x for k, x in c.items()
                                 if x is not None}
                             for v, c in r["collectives"].items()}
                         for n, r in points.items()},
                     "buckets": {n: len(r["buckets"] or [])
                                 for n, r in points.items()},
                     "wall_s": sweep_s},
           "link_GBps": TUNE_LINK_GBPS, "link_source": TUNE_LINK_SOURCE,
           "dp": dict(dp, wall_s=dp_s),
           "audit": {"sites": {k: {"findings_by_check":
                                   v.get("findings_by_check"),
                                   "n_ops": v.get("n_eqns"),
                                   "n_collectives": v.get("n_collectives"),
                                   "peak_live_bytes":
                                       v.get("peak_live_bytes"),
                                   "device_peak_bytes":
                                       v.get("device_peak_bytes"),
                                   "donation": v.get("donation"),
                                   "audit_error": v.get("audit_error")}
                               for k, v in report.sites.items()},
                     "new_findings": [[f.fingerprint(), f.message[:160]]
                                      for f in report.findings],
                     "suppressed": [f.fingerprint()
                                    for f in report.suppressed],
                     "wall_s": audit_s},
           "self_tests": tests, "kernel_launches": launches,
           "budget_s": TUNE["budget_s"],
           "wall_s": time.perf_counter() - t_phase}
    emit(row)
    bad = [n for n, ok in row["sweep"]["consistent"].items() if not ok]
    if bad or set(points) != set(TUNE["sweep_counts"]):
        raise RuntimeError("tuning: the sweep's trajectories disagree at "
                           "%r ranks: %r" % (bad, row["sweep"]))
    un = dp["untuned"]
    for tag in ("untuned", "plan", "dir"):
        r = dp[tag]
        if r["scopes"] != r["n_buckets"] or any(r["lost_launches"]):
            raise RuntimeError("tuning: %s run: %d mxbkt scopes in the "
                               "trace for %d buckets (lost %r)"
                               % (tag, r["scopes"], r["n_buckets"],
                                  r["lost_launches"]))
        if tag == "untuned":
            continue
        if r["n_buckets"] != dp["tuned"]["n_buckets"] or \
                not r["autotune"] or \
                r["autotune"]["plan_path"] != r["plan_path"]:
            raise RuntimeError("tuning: the %s run did not apply the tuned "
                               "plan: %r" % (tag, r))
        if r["loss_bits"] != un["loss_bits"]:
            raise RuntimeError("tuning: the %s run's losses are not the "
                               "untuned run's bitwise: %r vs %r"
                               % (tag, r["losses"], un["losses"]))
    sites = row["audit"]["sites"]
    want = ("TransformerTrainStep.step", "FusedTrainStep.step",
            "Module.bulk_fit")
    errors = {k: v["audit_error"] for k, v in sites.items()
              if v["audit_error"]}
    errors.update({k: v["audit_error"] for k, v in
                   un["audit"]["sites"].items() if v.get("audit_error")})
    if errors or not all(k in sites for k in want):
        raise RuntimeError("tuning: the audit failed: %r (sites %r)"
                           % (errors, sorted(sites)))
    if not any(v.get("n_collectives") for v in
               un["audit"]["sites"].values()):
        raise RuntimeError("tuning: the NCCL step's op log holds no c10d "
                           "collective: %r" % (un["audit"],))
    failed = {k: v for k, v in tests.items() if v["rc"] != 0}
    if failed:
        raise RuntimeError("tuning: self-test failed: %r" % (failed,))
    return row


# ---------------------------------------------------------------------------
# the recurrent tier: BASELINE config 3 (the bucketing LSTM LM)
# ---------------------------------------------------------------------------
# example/rnn/bucketing/lstm_bucketing.py's defaults (PTB's vocabulary)
RNN_LM = dict(vocab=10000, num_hidden=200, num_embed=200, num_layers=2,
              batch=32, buckets=(10, 20, 30, 40, 50, 60), invalid_label=0,
              lr=0.01, momentum=0.0, wd=1e-5)
RNN_TRAIN_BATCHES = 2       # a bucket, for variants (a) and (b)
RNN_GLUON = dict(bptt=35, steps=20, warmup=2, dropout=0.2, lr=20.0,
                 clip=0.25)
RNN_TRACE_STEPS = 3
RNN_NUM_TOL = 1e-10         # float64, card against the CPU
RNN_FAULT_MIN = 1e-3        # a planted fault must move a check this far
# one call in float32 (TF32 off) and bf16 against the CPU in float64,
# relative to the output's largest magnitude: the roundings of each type
# over 7 steps of 2 layers in two directions (measured on the H100:
# float32 1.0e-5, bf16 3.5e-3)
RNN_F32_TOL, RNN_BF16_TOL = 1e-4, 5e-2


def rnn_words(n, rng, vocab=RNN_LM["vocab"]):
    """``n`` word ids in [1, vocab): a Zipf unigram draw, half of them
    followed by their successor id, so an LM has something to learn."""
    ranks = np.arange(1, vocab, dtype=np.float64)
    p = 1.0 / ranks
    p /= p.sum()
    out = rng.choice(np.arange(1, vocab), size=n, p=p)
    follow = rng.rand(n) < 0.5
    for t in range(1, n):
        if follow[t]:
            out[t] = out[t - 1] % (vocab - 1) + 1
    return out


def rnn_corpus(per_bucket, seed, buckets=RNN_LM["buckets"]):
    """``per_bucket`` sentences a bucket, lengths uniform over each
    bucket's range, so every bucket fills."""
    rng = np.random.RandomState(seed)
    sents, lo = [], 1
    for b in buckets:
        for _ in range(per_bucket):
            n = rng.randint(lo + 1, b + 1)
            sents.append([int(w) for w in rnn_words(n, rng)])
        lo = b
    rng.shuffle(sents)
    return sents


def rnn_lm_sym_gen(mx, fused, cfg=RNN_LM):
    """lstm_bucketing.py's ``sym_gen``: the unrolled ``LSTMCell`` stack
    or the same model as one ``FusedRNNCell`` (the ``RNN`` op)."""
    H = cfg["num_hidden"]
    if fused:
        stack = mx.rnn.FusedRNNCell(H, num_layers=cfg["num_layers"],
                                    prefix="lstm_")
    else:
        stack = mx.rnn.SequentialRNNCell()
        for i in range(cfg["num_layers"]):
            stack.add(mx.rnn.LSTMCell(num_hidden=H, prefix="lstm_l%d_" % i))

    def sym_gen(seq_len):
        data = mx.sym.Variable("data")
        label = mx.sym.Variable("softmax_label")
        embed = mx.sym.Embedding(data=data, input_dim=cfg["vocab"],
                                 output_dim=cfg["num_embed"], name="embed")
        stack.reset()
        outputs, _ = stack.unroll(seq_len, inputs=embed, merge_outputs=True)
        pred = mx.sym.Reshape(outputs, shape=(-1, H))
        pred = mx.sym.FullyConnected(data=pred, num_hidden=cfg["vocab"],
                                     name="pred")
        label = mx.sym.Reshape(label, shape=(-1,))
        pred = mx.sym.SoftmaxOutput(data=pred, label=label, name="softmax")
        return pred, ("data",), ("softmax_label",)

    return sym_gen


def rnn_lm_init(mx):
    """lstm_bucketing.py's Xavier; the fused blob is 1-D, which Xavier
    refuses (the reference gives it a FusedRNN initializer, which
    neither package has), so it draws from a uniform."""
    return mx.init.Mixed([".*parameters", ".*"],
                         [mx.init.Uniform(0.07),
                          mx.init.Xavier(factor_type="in", magnitude=2.34)])


def _shares_parameters(mod) -> bool:
    """Every bucket's executor holds the default bucket's parameter
    storage."""
    mods = list(mod._buckets.values())
    names = mods[0]._param_names
    return all(len({m._exec.arg_dict[n]._data.data_ptr() for m in mods}) == 1
               for n in names)


def _rnn_trace(name, step, dev):
    """``RNN_TRACE_STEPS`` windows of ``step`` (after the tracer's
    warm-up dispatch) through traceview: device-busy ms, idle share and
    device launches a step."""
    tdir = tempfile.mkdtemp(prefix="chip_smoke_rnn_trace_")
    try:
        with _trace_armed(tdir, RNN_TRACE_STEPS) as capture:
            for _ in range(RNN_TRACE_STEPS + 1):
                with capture.step_window(name, device=dev) as w:
                    step()
                    if w:
                        w.block()
            summ, _ = _captured(capture, name, timeout_s=30.0)
        busy = _busy_ms(summ)
        wall = summ["steps"]["mean_s"] * 1e3
        return {"steps": summ["steps"]["n"], "step_ms_traced": wall,
                "device_busy_ms_per_step": busy,
                "idle_share": 1.0 - busy / wall,
                "device_launches_per_step":
                    summ["n_device_events"] / summ["steps"]["n"],
                "lost_launches": summ["capture"].get("lost_launches")}
    finally:
        from mxnet_tpu_torch.traceview import capture as _cap

        _cap.reset()
        shutil.rmtree(tdir, ignore_errors=True)


def _rnn_bucketing_variant(fused, train, held_out):
    """Variants (a) and (b): ``BucketingModule.fit`` over every bucket,
    ``RNN_TRAIN_BATCHES`` batches each, at lstm_bucketing.py's
    settings; perplexity on the held-out batches before and after."""
    import random

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import rnn as trnn

    cfg = RNN_LM
    ctx = mx.gpu(0)
    kw = dict(batch_size=cfg["batch"], buckets=list(cfg["buckets"]),
              invalid_label=cfg["invalid_label"])
    random.seed(0)
    np.random.seed(0)
    it = mx.rnn.BucketSentenceIter(train, **kw)
    ev = mx.rnn.BucketSentenceIter(held_out, **kw)
    mod = mx.mod.BucketingModule(rnn_lm_sym_gen(mx, fused),
                                 default_bucket_key=it.default_bucket_key,
                                 context=ctx)
    mod.bind(it.provide_data, it.provide_label)
    np.random.seed(1)
    mod.init_params(rnn_lm_init(mx))
    ppl0 = dict(mod.score(ev, mx.metric.Perplexity(cfg["invalid_label"])))
    trnn.reset_counts()
    _reset_kernel_counts()
    steps = []
    last = [0.0]

    def stamp(param):
        torch.cuda.synchronize()
        now = time.perf_counter()
        b = mod._curr_bucket_key
        steps.append((b, now - last[0]))
        last[0] = now

    torch.cuda.synchronize()
    last[0] = time.perf_counter()
    mod.fit(it, num_epoch=1, kvstore="local", optimizer="sgd",
            optimizer_params={"learning_rate": cfg["lr"],
                              "momentum": cfg["momentum"], "wd": cfg["wd"]},
            eval_metric=mx.metric.Perplexity(cfg["invalid_label"]),
            batch_end_callback=stamp)
    routes = trnn.route_counts()
    calls = trnn.calls()
    counts = _kernel_counts()
    ppl1 = dict(mod.score(ev, mx.metric.Perplexity(cfg["invalid_label"])))
    seen, steady = set(), []
    for b, s in steps:
        if b in seen:
            steady.append((b, s))
        seen.add(b)
    tokens = sum(cfg["batch"] * b for b, _ in steady)
    wall = sum(s for _, s in steady)
    shares = _shares_parameters(mod)
    # a traced window: the longest bucket, one batch again and again
    ev.reset()
    batch = next(b for b in ev if b.bucket_key == max(cfg["buckets"]))
    n_before = trnn.route_counts()["cudnn"]

    def one_step():
        mod.forward_backward(batch)
        mod.update()

    trace = _rnn_trace("BucketingModule[%s]" % ("fused" if fused
                                                else "unrolled"),
                       one_step, torch.device("cuda", 0))
    row = {
        "cell": "FusedRNNCell" if fused else "LSTMCell stack",
        "batches": len(steps), "buckets_visited": sorted(seen),
        "steady_batches": len(steady),
        "tokens_per_s": tokens / wall,
        "step_ms": wall * 1e3 / len(steady),
        "step_ms_by_bucket": {
            b: 1e3 * statistics.mean(s for k, s in steady if k == b)
            for b in sorted({k for k, _ in steady})},
        "perplexity_start": ppl0["perplexity"],
        "perplexity_end": ppl1["perplexity"],
        "rnn_op_routes": routes, "rnn_op_calls": calls,
        "rnn_op_calls_per_traced_step":
            (trnn.route_counts()["cudnn"] - n_before)
            / (RNN_TRACE_STEPS + 1),
        "shares_parameters": shares, "trace": trace,
        "kernel_launches": counts,
    }
    bad = []
    if sorted(seen) != list(cfg["buckets"]):
        bad.append("buckets visited %s" % sorted(seen))
    if not shares:
        bad.append("a bucket holds its own parameters")
    if not row["perplexity_end"] < row["perplexity_start"]:
        bad.append("perplexity did not fall")
    if fused and (routes["scan"] or not routes["cudnn"]):
        bad.append("RNN op routes %s" % routes)
    if not fused and (routes["scan"] or routes["cudnn"]):
        bad.append("the unrolled stack ran the RNN op: %s" % routes)
    return row, bad


def _gluon_lm(mx, cfg=RNN_LM):
    """gluon/word_language_model's model at config 3's widths:
    Embedding, a 2-layer LSTM with dropout between its layers, a Dense
    decoder over the vocabulary."""
    gluon = mx.gluon

    class LM(gluon.Block):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.embedding = gluon.nn.Embedding(cfg["vocab"],
                                                    cfg["num_embed"])
                self.rnn = gluon.rnn.LSTM(
                    cfg["num_hidden"], num_layers=cfg["num_layers"],
                    dropout=RNN_GLUON["dropout"],
                    input_size=cfg["num_embed"])
                self.decoder = gluon.nn.Dense(cfg["vocab"],
                                              in_units=cfg["num_hidden"])

        def forward(self, x, hidden):
            out, hidden = self.rnn(self.embedding(x), hidden)
            return self.decoder(out.reshape((-1, cfg["num_hidden"]))), hidden

        def begin_state(self, *args, **kw):
            return self.rnn.begin_state(*args, **kw)

    return LM(prefix="lm_")


def _clip_global_norm(grads, max_norm):
    """The reference's ``gluon.utils.clip_global_norm`` (not ported yet):
    scale every gradient by min(1, max_norm / global norm)."""
    total = sum(float((g * g).sum().asscalar()) for g in grads) ** 0.5
    scale = max_norm / (total + 1e-8)
    if scale < 1.0:
        for g in grads:
            g *= scale
    return total


def _rnn_gluon_variant():
    """Variant (c): ``gluon.rnn.LSTM(200, num_layers=2, dropout=0.2)``
    between ``Embedding(10000, 200)`` and ``Dense(10000)``, bptt 35,
    batch 32, ``Trainer`` SGD with the global norm clipped."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import rnn as trnn

    cfg, g = RNN_LM, RNN_GLUON
    ctx = mx.gpu(0)
    B, T = cfg["batch"], g["bptt"]
    rng = np.random.RandomState(11)
    n_rows = (g["steps"] + g["warmup"] + 3) * T + 1
    stream = rnn_words(n_rows * B, rng).reshape(B, n_rows).T  # (rows, B)
    eval_rows = stream[-(3 * T + 1):]
    net = _gluon_lm(mx)
    np.random.seed(2)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": g["lr"]})
    params = [p for p in net.collect_params().values()
              if p.grad_req != "null"]

    def chunk(rows, i):
        x = mx.nd.array(rows[i * T:(i + 1) * T], ctx=ctx, dtype="float32")
        y = mx.nd.array(rows[i * T + 1:(i + 1) * T + 1], ctx=ctx,
                        dtype="float32")
        return x, y.reshape((-1,))

    def perplexity():
        hidden = net.begin_state(batch_size=B, ctx=ctx)
        total, n = 0.0, 0
        for i in range(3):
            x, y = chunk(eval_rows, i)
            out, hidden = net(x, hidden)
            total += float(loss_fn(out, y).sum().asscalar())
            n += y.shape[0]
        return float(np.exp(total / n))

    state = [net.begin_state(batch_size=B, ctx=ctx)]

    def step(i):
        x, y = chunk(stream, i % (g["steps"] + g["warmup"]))
        hidden = [h.detach() for h in state[0]]
        with mx.autograd.record():
            out, hidden = net(x, hidden)
            loss = loss_fn(out, y)
        loss.backward()
        _clip_global_norm([p.grad(ctx) for p in params],
                          g["clip"] * T * B)
        trainer.step(T * B)
        state[0] = hidden
        return loss

    ppl0 = perplexity()
    for i in range(g["warmup"]):
        step(i)
    trnn.reset_counts()
    _reset_kernel_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(g["warmup"], g["warmup"] + g["steps"]):
        step(i)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    routes, calls = trnn.route_counts(), trnn.calls()
    passes = trnn.passes()
    counts = _kernel_counts()
    ppl1 = perplexity()
    n_before = trnn.route_counts()["cudnn"]
    k = [0]

    def traced():
        step(k[0])
        k[0] += 1

    trace = _rnn_trace("gluon.rnn.LSTM", traced, torch.device("cuda", 0))
    row = {"bptt": T, "batch": B, "steps": g["steps"],
           "tokens_per_s": g["steps"] * T * B / wall,
           "step_ms": wall * 1e3 / g["steps"],
           "perplexity_start": ppl0, "perplexity_end": ppl1,
           "rnn_op_routes": routes, "rnn_op_calls": calls,
           "rnn_op_passes": passes,
           "rnn_op_calls_per_traced_step":
               (trnn.route_counts()["cudnn"] - n_before)
               / (RNN_TRACE_STEPS + 1),
           "trace": trace, "kernel_launches": counts}
    bad = []
    if not ppl1 < ppl0:
        bad.append("perplexity did not fall")
    # one op call a step; dropout between the layers: one fused pass a
    # layer
    if routes != {"cudnn": g["steps"], "scan": 0} or \
            passes != {"cudnn": g["steps"] * cfg["num_layers"], "scan": 0}:
        bad.append("RNN op routes %s, passes %s" % (routes, passes))
    return row, bad


def phase_rnn():
    """BASELINE config 3 at full width on the card, three ways."""
    cfg = RNN_LM
    t0 = time.perf_counter()
    train = rnn_corpus(RNN_TRAIN_BATCHES * cfg["batch"], seed=3)
    held_out = rnn_corpus(cfg["batch"], seed=4)
    rows, bad = {}, []
    for name, fused in (("a_unrolled", False), ("b_fused", True)):
        rows[name], b = _rnn_bucketing_variant(fused, train, held_out)
        bad += ["%s: %s" % (name, m) for m in b]
    rows["c_gluon"], b = _rnn_gluon_variant()
    bad += ["c_gluon: %s" % m for m in b]
    counts = {k: sum(r["kernel_launches"][k] for r in rows.values())
              for k in ("flash_attention_fwd", "flash_attention_bwd",
                        "rtc_add", "box_nms")}
    row = {"phase": "rnn",
           "config": {k: list(v) if isinstance(v, tuple) else v
                      for k, v in cfg.items()},
           "corpus_sentences": {"train": len(train),
                                "held_out": len(held_out)},
           "variants": rows, "kernel_launches": counts,
           "wall_s": time.perf_counter() - t0}
    emit(row)
    if bad:
        raise RuntimeError("rnn: %s" % "; ".join(bad))
    return row


# -- rnn_numerics ------------------------------------------------------------
RNN_NUM_SHAPE = dict(T=7, N=3, I=5, H=8)
RNN_MODES = ("lstm", "gru", "rnn_tanh", "rnn_relu")


def _rnn_num_inputs(mode, layers, bidir, seed=0):
    s = RNN_NUM_SHAPE
    from mxnet_tpu_torch.ops.rnn import rnn_param_size

    rng = np.random.RandomState(seed)
    nd_ = 2 if bidir else 1
    arrays = [rng.uniform(-1, 1, (s["T"], s["N"], s["I"])),
              rng.uniform(-0.5, 0.5, (rnn_param_size(
                  layers, s["I"], s["H"], bidir, mode),)),
              rng.uniform(-0.5, 0.5, (layers * nd_, s["N"], s["H"]))]
    if mode == "lstm":
        arrays.append(rng.uniform(-0.5, 0.5, arrays[2].shape))
    outs = [(s["T"], s["N"], s["H"] * nd_)] + [arrays[2].shape] * (
        2 if mode == "lstm" else 1)
    return arrays, [rng.uniform(-1, 1, o) for o in outs]


def _rnn_num_run(device, route, mode, layers, bidir, clip=None,
                 state_outputs=True):
    """The RNN op on ``device``: through the op (which chooses ``cudnn``
    on the card, or ``scan`` under a clip) or, for ``route="scan"`` on
    the card, its scan; outputs and input gradients in float64."""
    from mxnet_tpu_torch.ops import registry
    from mxnet_tpu_torch.ops import rnn as trnn

    arrays, cots = _rnn_num_inputs(mode, layers, bidir)
    xs = [torch.tensor(a, device=device, requires_grad=True)
          for a in arrays]
    kw = dict(state_size=RNN_NUM_SHAPE["H"], num_layers=layers,
              bidirectional=bidir, mode=mode, state_outputs=state_outputs)
    gen = torch.Generator(device=device)
    if route == "op":
        if clip is not None:
            kw.update(lstm_state_clip_min=clip[0],
                      lstm_state_clip_max=clip[1])
        outs = registry.get("RNN").fn(gen, *xs, **kw)
    else:
        outs = trnn.rnn_forward(
            route, gen, xs[0], xs[1], xs[2], xs[3] if mode == "lstm"
            else None, clip_min=clip and clip[0], clip_max=clip and clip[1],
            **kw)
    outs = outs if isinstance(outs, tuple) else (outs,)
    grads = torch.autograd.grad(
        outs, xs, [torch.tensor(c, device=device)
                   for c in cots[:len(outs)]])
    return [t.detach().cpu().numpy() for t in list(outs) + list(grads)]


def _rnn_num_err(got, want):
    return max(float(np.abs(g - w).max()) / max(float(np.abs(w).max()),
                                                1e-30)
               for g, w in zip(got, want))


def _rnn_op_checks(cases=None):
    """The card (the op's route, and the scan) against the scan on the
    CPU; the worst error over every case and the routes the op took."""
    from mxnet_tpu_torch.ops import rnn as trnn

    cuda = torch.device("cuda", 0)
    cpu = torch.device("cpu")
    cases = cases or [(m, l, b, None, True) for m in RNN_MODES
                      for l in (1, 2) for b in (False, True)] + [
        ("lstm", 2, True, (-0.2, 0.25), True),
        ("gru", 2, True, None, False), ("lstm", 1, False, None, False)]
    worst = {"op": 0.0, "scan": 0.0}
    trnn.reset_counts()
    for mode, layers, bidir, clip, so in cases:
        want = _rnn_num_run(cpu, "scan", mode, layers, bidir, clip, so)
        for route in ("op", "scan"):
            got = _rnn_num_run(cuda, route, mode, layers, bidir, clip, so)
            worst[route] = max(worst[route], _rnn_num_err(got, want))
    return worst, trnn.calls()


def _rnn_dtype_probe():
    """One call of the op on the card in each dtype (LSTM, 2 layers,
    bidirectional): its recorded route, the CUDA kernels torch's fused
    RNN ran (from torch.profiler: whether cuDNN's), and its error against
    the CPU scan in float64.  A dtype torch's fused RNN refuses is
    reported with its error, not run another way."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mxnet_tpu_torch.ops import registry
    from mxnet_tpu_torch.ops import rnn as trnn

    arrays, _ = _rnn_num_inputs("lstm", 2, True)
    kw = dict(state_size=RNN_NUM_SHAPE["H"], num_layers=2,
              bidirectional=True, mode="lstm")
    fn = registry.get("RNN").fn
    want = fn(torch.Generator(), *[torch.tensor(a) for a in arrays],
              **kw).numpy()
    out = {}
    for dt in (torch.float32, torch.float64, torch.bfloat16):
        xs = [torch.tensor(a, device="cuda", dtype=dt) for a in arrays]
        trnn.reset_counts()
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                # a capture in a long-lived process can lose its first
                # few dozen device records: tiny kernels take the loss
                # (traceview's primer)
                primer = torch.zeros(1, device="cuda")
                for _ in range(256):
                    primer.add_(1.0)
                torch.cuda.synchronize()
                got = fn(torch.Generator(device="cuda"), *xs, **kw)
                torch.cuda.synchronize()
        except RuntimeError as e:
            out[str(dt)[6:]] = {"calls": trnn.calls(), "error": str(e)}
            continue
        names = sorted({ev.name for ev in prof.events()
                        if ev.device_type == DeviceType.CUDA
                        and "add" not in ev.name.lower()
                        and "fill" not in ev.name.lower()})
        err = float(np.abs(got.double().cpu().numpy() - want).max()
                    / np.abs(want).max())
        out[str(dt)[6:]] = {
            "calls": trnn.calls(), "max_rel_err": err,
            "cudnn_kernels": sum("cudnn" in n.lower() or "rnn" in n.lower()
                                 for n in names),
            "kernels": names[:16]}
    return out


def _seq_checks():
    """The sequence ops with lengths, card against CPU, forward and the
    gradient, float64."""
    from mxnet_tpu_torch.ops import registry

    rng = np.random.RandomState(5)
    data = rng.uniform(-1, 1, (9, 4, 3))
    cot = {}
    worst = 0.0
    for op, kw in (("SequenceMask", dict(value=-1.5)),
                   ("SequenceMask", dict(axis=1)),
                   ("SequenceLast", dict()), ("SequenceLast", dict(axis=1)),
                   ("SequenceReverse", dict())):
        axis = kw.get("axis", 0)
        lengths = rng.randint(1, data.shape[axis] + 1,
                              data.shape[1 - axis]).astype(np.float64)
        res = []
        for dev in ("cpu", "cuda"):
            x = torch.tensor(data, device=dev, requires_grad=True)
            ln = torch.tensor(lengths, device=dev)
            out = registry.get(op).fn(x, ln, use_sequence_length=True, **kw)
            c = cot.setdefault((op, out.shape), rng.uniform(-1, 1,
                                                            out.shape))
            (g,) = torch.autograd.grad(out, x, torch.tensor(c, device=dev))
            res.append([out.detach().cpu().numpy(), g.cpu().numpy()])
        worst = max(worst, _rnn_num_err(res[1], res[0]))
    return worst


def rnn_bucket_fit(ctx, fused, H=16, vocab=24):
    """Three batches of ``BucketingModule.fit`` over buckets 4 and 6 (two,
    then one) of a small LSTM LM in float64 on ``ctx``: the start and
    end parameters, the buckets in order and whether every bucket holds
    the same parameter storage."""
    import random

    import mxnet_tpu_torch as mx

    cfg = dict(RNN_LM, vocab=vocab, num_hidden=H, num_embed=H // 2)
    sents = ([[1 + (i + t) % (vocab - 1) for t in range(3 + i % 2)]
              for i in range(8)]
             + [[1 + (2 * i + t) % (vocab - 1) for t in range(6)]
                for i in range(4)])
    random.seed(0)
    np.random.seed(0)
    it = mx.rnn.BucketSentenceIter(sents, 4, buckets=[4, 6],
                                   invalid_label=0)
    mod = mx.mod.BucketingModule(rnn_lm_sym_gen(mx, fused, cfg),
                                 default_bucket_key=6, context=ctx)
    mod.bind(it.provide_data, it.provide_label)
    np.random.seed(7)
    mod.init_params(rnn_lm_init(mx))
    mod.switch_bucket(4, [mx.io.DataDesc("data", (4, 4))],
                      [mx.io.DataDesc("softmax_label", (4, 4))])
    for m in mod._buckets.values():
        _cast_module(m, torch.float64)
    mod.switch_bucket(6, None, None)
    start = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    keys = []
    mod.fit(it, num_epoch=1, optimizer="sgd",
            optimizer_params={"learning_rate": 0.125, "momentum": 0.5,
                              "wd": 1e-5},
            eval_metric=mx.metric.Perplexity(0),
            batch_end_callback=lambda p: keys.append(mod._curr_bucket_key))
    end = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    return start, end, keys, _shares_parameters(mod)


def _bucket_err(got, want, start):
    """The largest parameter error, relative to max(1, |w|), and over
    the size of the update."""
    return (max(float(np.abs(got[k] - want[k]).max())
                / max(1.0, float(np.abs(want[k]).max())) for k in want),
            max(float(np.abs(got[k] - want[k]).max())
                / max(float(np.abs(want[k] - start[k]).max()), 1e-30)
                for k in want))


def phase_rnn_numerics():
    """The recurrent tier in float64 on the card against the port on the
    CPU, with three planted faults."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.module import bucketing_module
    from mxnet_tpu_torch.ops import rnn as trnn

    t0 = time.perf_counter()
    _reset_kernel_counts()
    op_err, calls = _rnn_op_checks()
    dtypes = _rnn_dtype_probe()
    seq_err = _seq_checks()
    fit = {}
    for name, fused in (("unrolled", False), ("fused", True)):
        s_gpu, e_gpu, k_gpu, share_gpu = rnn_bucket_fit(mx.gpu(0), fused)
        s_cpu, e_cpu, k_cpu, share_cpu = rnn_bucket_fit(mx.cpu(), fused)
        fit[name] = {"start_err": _rnn_num_err(
                         [s_gpu[k] for k in s_cpu], list(s_cpu.values())),
                     "param_err": _bucket_err(e_gpu, e_cpu, s_cpu)[0],
                     "update_err": _bucket_err(e_gpu, e_cpu, s_cpu)[1],
                     "buckets": k_gpu, "same_buckets": k_gpu == k_cpu,
                     "shares_parameters": share_gpu and share_cpu}
    counts = _kernel_counts()
    # planted faults: each must move its check past RNN_FAULT_MIN
    lstm_bi = [("lstm", 2, True, None, True)]
    faults = {}
    for fault in ("cudnn_swap_if", "scan_reverse_unflipped"):
        trnn.FAULTS.add(fault)
        try:
            faults[fault] = _rnn_op_checks(lstm_bi)[0]["op"]
        finally:
            trnn.FAULTS.discard(fault)
    s_cpu, e_cpu = rnn_bucket_fit(mx.cpu(), True)[:2]
    bucketing_module.FAULTS.add("bucket_own_params")
    try:
        _, e_gpu, _, share = rnn_bucket_fit(mx.gpu(0), True)
    finally:
        bucketing_module.FAULTS.discard("bucket_own_params")
    faults["bucket_own_params"] = {
        "param_err": _bucket_err(e_gpu, e_cpu, s_cpu)[0],
        "shares_parameters": share}
    row = {"phase": "rnn_numerics", "dtype": "float64",
           "shape": RNN_NUM_SHAPE, "op_err": op_err, "op_calls": calls,
           "dtypes_on_the_card": dtypes,
           "sequence_err": seq_err, "fit": fit, "tolerance": RNN_NUM_TOL,
           "fault_err": faults, "kernel_launches": counts,
           "wall_s": time.perf_counter() - t0}
    emit(row)
    bad = []
    if max(op_err.values()) > RNN_NUM_TOL:
        bad.append("RNN op error %s" % op_err)
    if not any(k.startswith("cudnn/float64") for k in calls) or \
            not any(k.startswith("scan/float64/lstm") for k in calls):
        bad.append("routes %s" % calls)
    for dt, tol in (("float32", RNN_F32_TOL), ("float64", RNN_NUM_TOL)):
        if not dtypes[dt].get("max_rel_err", 1.0) <= tol:
            bad.append("%s on the card: %s" % (dt, dtypes[dt]))
    if "max_rel_err" in dtypes["bfloat16"] and \
            not dtypes["bfloat16"]["max_rel_err"] <= RNN_BF16_TOL:
        bad.append("bfloat16 on the card: %s" % dtypes["bfloat16"])
    if seq_err > RNN_NUM_TOL:
        bad.append("sequence ops error %g" % seq_err)
    for name, f in fit.items():
        if f["param_err"] > RNN_NUM_TOL or f["start_err"] or \
                not f["same_buckets"] or not f["shares_parameters"] or \
                sorted(set(f["buckets"])) != [4, 6]:
            bad.append("fit %s: %s" % (name, f))
    for fault in ("cudnn_swap_if", "scan_reverse_unflipped"):
        if not faults[fault] > RNN_FAULT_MIN:
            bad.append("fault %s not caught (%g)" % (fault, faults[fault]))
    f = faults["bucket_own_params"]
    if f["shares_parameters"] or not f["param_err"] > RNN_FAULT_MIN:
        bad.append("fault bucket_own_params not caught: %s" % f)
    if bad:
        raise RuntimeError("rnn_numerics: %s" % "; ".join(bad))
    return row


# ---------------------------------------------------------------------------
# the detection tier: BASELINE config 4 (SSD, example/ssd)
# ---------------------------------------------------------------------------
# example/ssd/symbol/symbol_factory.py's entry ``resnet50`` at
# ``--data-shape 512``: the last units of stages 3 and 4 (``_plus12``,
# ``_plus15``: features[6] and features[7] of the port's ResNetV1,
# strides 16 and 32), four extra layers, six heads, no normalisation
# layer, priors without steps or clip: 4, 6, 6, 6, 4, 4 anchors a cell
# on maps of 32, 16, 8, 4, 2, 1 = 6,132 anchors
SSD_LAYOUT = dict(
    from_layers=(6, 7), num_filters=(512, 256, 256, 128),
    sizes=((.1, .141), (.2, .272), (.37, .447), (.54, .619), (.71, .79),
           (.88, .961)),
    ratios=((1, 2, .5),) + ((1, 2, .5, 3, 1. / 3),) * 3 + ((1, 2, .5),) * 2)
SSD_ANCHORS = 6132
SSD_MAPS = (32, 16, 8, 4, 2, 1)   # the six maps' sides at 512²
SSD = dict(classes=20, image=512, batch=32, lr=0.004, momentum=0.9,
           wd=5e-4, overlap_threshold=0.5, negative_mining_ratio=3.0,
           negative_mining_thresh=0.5, variances=(0.1, 0.1, 0.2, 0.2),
           max_objects=3, record_size=160, train_batches=3, warmup=1,
           fixed_steps=10, trace_steps=3, eval_images=32,
           mean=(123.68, 116.78, 103.94),
           detection=dict(threshold=0.01, nms_threshold=0.45,
                          nms_topk=400))
# tests/test_ssd_e2e.py:26-28: the example's SSDNet and its three bars
SSD_EXAMPLE = dict(classes=("square", "disk", "cross"), max_objects=3,
                   epochs=4, batch=16, lr=0.06, image=40, train_n=128,
                   val_n=48, seed=3)
SSD_NUM_TOL = 1e-10
SSD_FFT_TOL = 1e-5          # fft / ifft transform in float32 inside
# outside the tensor cores, by element size (H100 SXM data sheet:
# float32 67 TFLOP/s, float64 34)
PEAK_VECTOR_FLOPS = {4: 67e12, 8: 34e12}
NMS_PAIR_OPS = 12           # operations of one IoU test (contrib.py)


def ssd_net(pkg, backbone, layout=SSD_LAYOUT, classes=SSD["classes"],
            prefix="ssd_"):
    """The SSD of ``example/ssd`` on ``backbone`` (a gluon ResNetV1 of
    either package: its ``features`` up to ``layout["from_layers"]``):
    the extra layers (a 1x1 conv of max(128, f // 2) + ReLU, a 3x3 conv
    of f, stride 2, pad 1, + ReLU), a 3x3 class conv (anchors x
    (classes + 1)) and box conv (anchors x 4) on each map, and the
    maps' MultiBoxPrior anchors.  ``net(x)`` returns cls (B, classes + 1,
    N), loc (B, N * 4) and anchors (1, N, 4)."""
    gluon = pkg.gluon
    nn = gluon.nn
    nc = classes + 1
    per_cell = [len(s) + len(r) - 1 for s, r in zip(layout["sizes"],
                                                     layout["ratios"])]

    class SSD512(gluon.HybridBlock):
        def __init__(self):
            super().__init__(prefix=prefix)
            with self.name_scope():
                self.backbone = backbone
                # the backbone's classifier is not on the path
                for p in backbone.output.collect_params().values():
                    p.grad_req = "null"
                self.extras = nn.HybridSequential(prefix="extra_")
                for f in layout["num_filters"]:
                    blk = nn.HybridSequential(prefix="")
                    blk.add(nn.Conv2D(max(128, f // 2), 1),
                            nn.Activation("relu"),
                            nn.Conv2D(f, 3, strides=2, padding=1),
                            nn.Activation("relu"))
                    self.extras.add(blk)
                self.cls_heads = nn.HybridSequential(prefix="cls_")
                self.loc_heads = nn.HybridSequential(prefix="loc_")
                for a in per_cell:
                    self.cls_heads.add(nn.Conv2D(a * nc, 3, padding=1))
                    self.loc_heads.add(nn.Conv2D(a * 4, 3, padding=1))

        def hybrid_forward(self, F, x):
            maps = []
            for i in range(max(layout["from_layers"]) + 1):
                x = self.backbone.features[i](x)
                if i in layout["from_layers"]:
                    maps.append(x)
            for blk in self.extras:
                x = blk(x)
                maps.append(x)
            cls, loc, anchors = [], [], []
            for fm, ch, lh, s, r in zip(maps, self.cls_heads, self.loc_heads,
                                        layout["sizes"], layout["ratios"]):
                c = F.transpose(ch(fm), axes=(0, 2, 3, 1))
                cls.append(c.reshape((c.shape[0], -1, nc)))
                b = F.transpose(lh(fm), axes=(0, 2, 3, 1))
                loc.append(b.reshape((b.shape[0], -1)))
                anchors.append(F.contrib.MultiBoxPrior(fm, sizes=s,
                                                       ratios=r))
            cls = F.transpose(F.concat(*cls, dim=1), axes=(0, 2, 1))
            return cls, F.concat(*loc, dim=1), F.concat(*anchors, dim=1)

    return SSD512()


def ssd_targets(nd, cls_prob, anchors, labels, mining_thresh=0.3,
                variances=(0.1, 0.1, 0.2, 0.2)):
    """MultiBoxTarget as ``examples/ssd/train_ssd.py:134`` calls it:
    overlap 0.5, hard negative mining at ratio 3 above
    ``mining_thresh``."""
    return nd.contrib.MultiBoxTarget(
        anchors, labels, cls_prob, overlap_threshold=0.5,
        negative_mining_ratio=3.0, negative_mining_thresh=mining_thresh,
        variances=variances)


def ssd_loss(nd, cls, loc, anchors, labels, mining_thresh=0.3,
             variances=(0.1, 0.1, 0.2, 0.2), target_scope=None,
             targets=None):
    """``examples/ssd/train_ssd.py:134``'s composition on ``nd`` (either
    package's): :func:`ssd_targets`, then the cross-entropy over the
    matched and mined anchors plus smooth-L1 over the matched boxes,
    each over its count.  ``target_scope()``, when given, is entered
    around MultiBoxTarget (a profiler's range); ``targets`` (its three
    outputs), when given, stand in for it."""
    cls_prob = nd.softmax(cls, axis=1)
    if targets is None:
        with (target_scope() if target_scope
              else contextlib.nullcontext()):
            targets = ssd_targets(nd, cls_prob, anchors, labels,
                                  mining_thresh, variances)
    loc_t, loc_m, cls_t = targets
    mask = (cls_t >= 0)
    picked = nd.pick(cls_prob, nd.maximum(cls_t, 0), axis=1)
    ce = -(nd.log(nd.maximum(picked, 1e-12)) * mask).sum() / \
        nd.maximum(mask.sum(), 1)
    sl1 = nd.smooth_l1(loc * loc_m - loc_t, scalar=1.0).sum() / \
        nd.maximum(loc_m.sum(), 1)
    return ce + sl1


def _iou_matrix(boxes, gts):
    """IoU between (n, 4) detections and (m, 4) ground truths."""
    if len(boxes) == 0 or len(gts) == 0:
        return np.zeros((len(boxes), len(gts)), np.float64)
    lt = np.maximum(boxes[:, None, :2], gts[None, :, :2])
    rb = np.minimum(boxes[:, None, 2:], gts[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    a = np.prod(np.clip(boxes[:, 2:] - boxes[:, :2], 0, None), axis=1)
    b = np.prod(np.clip(gts[:, 2:] - gts[:, :2], 0, None), axis=1)
    union = a[:, None] + b[None, :] - inter
    return np.where(union > 0, inter / union, 0.0)


def map_metrics():
    """``(MApMetric, VOC07MApMetric)``: the port's copy of
    ``examples/ssd/eval_metric.py`` on the port's ``metric.EvalMetric``
    (per class, score-ranked detections matched greedily at an IoU
    threshold; AP as the area under the monotonised precision-recall
    curve, or VOC07's 11-point interpolation)."""
    from mxnet_tpu_torch.metric import EvalMetric
    from mxnet_tpu_torch.ndarray import NDArray

    class MApMetric(EvalMetric):
        def __init__(self, iou_thresh=0.5, class_names=None,
                     ovp_thresh=None, use_voc07=False, name="mAP"):
            super().__init__(name)
            self.iou_thresh = float(ovp_thresh if ovp_thresh is not None
                                    else iou_thresh)
            self.class_names = class_names
            self.use_voc07 = use_voc07
            self.reset()

        def reset(self):
            self._records, self._gt_counts = {}, {}
            self.num_inst = 0
            self.sum_metric = 0.0

        def update(self, labels, preds):
            def np_of(x):
                return x.asnumpy() if isinstance(x, NDArray) \
                    else np.asarray(x)

            for label, det in zip(labels, preds):
                label, det = np_of(label), np_of(det)
                for b in range(label.shape[0]):
                    self._update_one(label[b], det[b])

        def _update_one(self, gts, dets):
            gts = gts[gts[:, 0] >= 0]
            dets = dets[dets[:, 0] >= 0]
            classes = set(gts[:, 0].astype(int)) | \
                set(dets[:, 0].astype(int))
            for c in classes:
                gt_c = gts[gts[:, 0].astype(int) == c][:, 1:5]
                dt_c = dets[dets[:, 0].astype(int) == c]
                self._gt_counts[c] = self._gt_counts.get(c, 0) + len(gt_c)
                if len(dt_c) == 0:
                    continue
                dt_c = dt_c[np.argsort(-dt_c[:, 1])]
                iou = _iou_matrix(dt_c[:, 2:6], gt_c)
                taken = np.zeros(len(gt_c), bool)
                rec = self._records.setdefault(c, [])
                for i in range(len(dt_c)):
                    tp = 0
                    if len(gt_c):
                        j = int(np.argmax(iou[i]))
                        if iou[i, j] >= self.iou_thresh and not taken[j]:
                            taken[j] = True
                            tp = 1
                    rec.append((float(dt_c[i, 1]), tp))

        def _ap(self, c):
            npos = self._gt_counts.get(c, 0)
            rec = self._records.get(c, [])
            if npos == 0:
                return None
            if not rec:
                return 0.0
            rec = sorted(rec, key=lambda r: -r[0])
            tps = np.array([r[1] for r in rec], np.float64)
            tp_cum = np.cumsum(tps)
            fp_cum = np.cumsum(1.0 - tps)
            recall = tp_cum / npos
            precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)
            if self.use_voc07:
                return sum((precision[recall >= t].max()
                            if (recall >= t).any() else 0.0) / 11.0
                           for t in np.linspace(0, 1, 11))
            for i in range(len(precision) - 2, -1, -1):
                precision[i] = max(precision[i], precision[i + 1])
            idx = np.concatenate(([0], np.where(recall[1:] != recall[:-1])[0]
                                  + 1))
            return float(np.sum((recall[idx] - np.concatenate(
                ([0.0], recall[idx][:-1]))) * precision[idx]))

        def get(self):
            aps = [self._ap(c) for c in sorted(self._gt_counts)]
            aps = [a for a in aps if a is not None]
            return self.name, float(np.mean(aps)) if aps else 0.0

    class VOC07MApMetric(MApMetric):
        def __init__(self, **kwargs):
            kwargs.setdefault("name", "VOC07mAP")
            super().__init__(use_voc07=True, **kwargs)

    return MApMetric, VOC07MApMetric


# -- the example's SSD (examples/ssd/train_ssd.py), for the learning check --
class ShapesDetDataset:
    """``examples/ssd/train_ssd.py``'s synthetic detection set: squares,
    disks and crosses on noise; items (1, H, W) float32 images and
    (max_objects, 5) rows [cls, x0, y0, x1, y1] (relative), -1 padded."""

    def __init__(self, n, size=64, seed=0):
        self.n, self.size, self.seed = n, size, seed

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.RandomState(self.seed * 100003 + i)
        size, max_obj = self.size, SSD_EXAMPLE["max_objects"]
        img = rng.uniform(0, 0.15, (1, size, size)).astype(np.float32)
        label = np.full((max_obj, 5), -1, np.float32)
        for k in range(rng.randint(1, max_obj + 1)):
            cls = rng.randint(0, len(SSD_EXAMPLE["classes"]))
            s = rng.randint(size // 6, size // 3)
            x0 = rng.randint(0, size - s)
            y0 = rng.randint(0, size - s)
            patch = img[0, y0:y0 + s, x0:x0 + s]
            yy, xx = np.mgrid[0:s, 0:s]
            if cls == 0:
                patch[:] = 1.0
            elif cls == 1:
                r = s / 2.0
                patch[(yy - r + .5) ** 2 + (xx - r + .5) ** 2 <= r * r] = 1.0
            else:
                w = max(1, s // 4)
                patch[:, s // 2 - w // 2: s // 2 + (w + 1) // 2] = 1.0
                patch[s // 2 - w // 2: s // 2 + (w + 1) // 2, :] = 1.0
            label[k] = [cls, x0 / size, y0 / size,
                        (x0 + s) / size, (y0 + s) / size]
        return img, label


def example_ssd_net(pkg, num_classes=3, num_anchors=2):
    """``examples/ssd/train_ssd.py:73``'s ``SSDNet`` on either package's
    gluon: four conv / BatchNorm / ReLU / max-pool stages, heads on the
    stride-8 and stride-16 maps."""
    gluon = pkg.gluon
    nn = gluon.nn

    class SSDNet(gluon.HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.num_classes = num_classes
            na, nc = num_anchors, num_classes + 1
            with self.name_scope():
                def stage(c):
                    s = nn.HybridSequential(prefix="")
                    s.add(nn.Conv2D(c, 3, padding=1), nn.BatchNorm(),
                          nn.Activation("relu"), nn.MaxPool2D(2))
                    return s

                self.s1, self.s2 = stage(16), stage(32)
                self.s3, self.s4 = stage(64), stage(64)
                self.cls_a = nn.Conv2D(na * nc, 3, padding=1)
                self.loc_a = nn.Conv2D(na * 4, 3, padding=1)
                self.cls_b = nn.Conv2D(na * nc, 3, padding=1)
                self.loc_b = nn.Conv2D(na * 4, 3, padding=1)

        def hybrid_forward(self, F, x):
            fa = self.s3(self.s2(self.s1(x)))
            fb = self.s4(fa)
            nc = self.num_classes + 1

            def head(fm, cls_conv, loc_conv):
                c = cls_conv(fm)
                lo = loc_conv(fm)
                B = c.shape[0]
                c = F.transpose(c, axes=(0, 2, 3, 1)).reshape((B, -1, nc))
                lo = F.transpose(lo, axes=(0, 2, 3, 1)).reshape((B, -1))
                return c, lo

            ca, la = head(fa, self.cls_a, self.loc_a)
            cb, lb = head(fb, self.cls_b, self.loc_b)
            cls = F.transpose(F.concat(ca, cb, dim=1), axes=(0, 2, 1))
            return cls, F.concat(la, lb, dim=1)

    return SSDNet()


def example_anchors(nd, net, image_size, ctx=None):
    """``build_anchors``: MultiBoxPrior over each head's map, in the
    heads' order (in the dtype of the net's parameters)."""
    dtype = next(iter(net.collect_params().values())).dtype
    x = nd.zeros((1, 1, image_size, image_size), ctx=ctx, dtype=dtype)
    fa = net.s3(net.s2(net.s1(x)))
    fb = net.s4(fa)
    aa = nd.contrib.MultiBoxPrior(fa, sizes=(0.2, 0.35), ratios=(1.0,))
    ab = nd.contrib.MultiBoxPrior(fb, sizes=(0.5, 0.7), ratios=(1.0,))
    return nd.concat(aa, ab, dim=1)


def example_train(mx, ctx, cfg=SSD_EXAMPLE):
    """``train_ssd.train`` at ``cfg`` on the port, batches moved to
    ``ctx``: SGD (momentum 0.9, wd 1e-4), MultiBoxDetection (threshold
    0.25, NMS 0.45) into the mAP each epoch.  Returns [(mean loss,
    mAP)] an epoch."""
    from mxnet_tpu_torch import autograd, gluon

    nd = mx.nd
    mx.random.seed(cfg["seed"])
    np.random.seed(cfg["seed"])
    net = example_ssd_net(mx, len(cfg["classes"]))
    net.initialize(mx.init.Xavier(), ctx=ctx)
    anchors = example_anchors(nd, net, cfg["image"], ctx=ctx)
    train_loader = gluon.data.DataLoader(
        ShapesDetDataset(cfg["train_n"], cfg["image"], seed=1),
        batch_size=cfg["batch"], shuffle=True, last_batch="discard")
    val_loader = gluon.data.DataLoader(
        ShapesDetDataset(cfg["val_n"], cfg["image"], seed=2),
        batch_size=cfg["batch"])
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": cfg["lr"], "momentum": 0.9,
                             "wd": 1e-4})
    MApMetric, _ = map_metrics()
    metric = MApMetric(iou_thresh=0.5, class_names=cfg["classes"])
    history = []
    for _ in range(cfg["epochs"]):
        total, nb = 0.0, 0
        for img, label in train_loader:
            img, label = img.as_in_context(ctx), label.as_in_context(ctx)
            with autograd.record():
                cls, loc = net(img)
                loss = ssd_loss(nd, cls, loc, anchors, label)
            loss.backward()
            trainer.step(1)
            total += float(loss.asnumpy())
            nb += 1
        metric.reset()
        for img, label in val_loader:
            cls, loc = net(img.as_in_context(ctx))
            dets = nd.contrib.MultiBoxDetection(
                nd.softmax(cls, axis=1), loc, anchors, threshold=0.25,
                nms_threshold=0.45)
            metric.update([label], [dets])
        history.append((total / max(nb, 1), metric.get()[1]))
    return history


def example_bars(history):
    """``tests/test_ssd_e2e.py``'s bars: the last loss under 0.6x the
    first, the last mAP above 0.05 and at least 0.8x the first."""
    losses = [h[0] for h in history]
    maps = [h[1] for h in history]
    return {"loss_falls": losses[-1] < 0.6 * losses[0],
            "map_above_0.05": maps[-1] > 0.05,
            "map_holds": maps[-1] >= 0.8 * maps[0]}


# -- SSD-512 records and batches --------------------------------------------
def write_ssd_records(path, n, seed, classes=SSD["classes"],
                      size=SSD["record_size"], max_objects=SSD["max_objects"]):
    """``n`` seeded detection records in ``tests/test_reference_scripts.py:
    251``'s format (JPEG through ``recordio.pack_img``, header label [2,
    6, then cls, x1, y1, x2, y2, difficult an object]): dark noise with
    1 to ``max_objects`` bright blocks, class k tinting channel k % 3."""
    from mxnet_tpu_torch import recordio

    rng = np.random.RandomState(seed)
    w = recordio.MXRecordIO(path, "w")
    try:
        for i in range(n):
            img = rng.randint(0, 60, (size, size, 3), dtype=np.uint8)
            lab = [2.0, 6.0]
            for _ in range(rng.randint(1, max_objects + 1)):
                cls = int(rng.randint(0, classes))
                x1, y1 = rng.uniform(0.0, 0.6, 2)
                bw, bh = rng.uniform(0.15, 0.4, 2)
                x2, y2 = min(0.98, x1 + bw), min(0.98, y1 + bh)
                px = (np.array([x1, y1, x2, y2]) * size).astype(int)
                img[px[1]:px[3], px[0]:px[2], cls % 3] = 120 + 6 * cls
                lab += [float(cls), x1, y1, x2, y2, 0.0]
            w.write(recordio.pack_img(
                recordio.IRHeader(0, np.array(lab, np.float32), i, 0),
                img, quality=95))
    finally:
        w.close()


def det_labels_from_batch(label, max_objects=SSD["max_objects"]):
    """``ImageDetRecordIter``'s label rows ([c, h, w, len, then the raw
    label: header width, object width, header..., objects]) as (B,
    max_objects, 5) [cls, x1, y1, x2, y2] rows, -1 padded."""
    label = np.asarray(label)
    out = np.full((label.shape[0], max_objects, 5), -1.0, np.float32)
    for b, row in enumerate(label):
        raw = row[4:4 + int(row[3])]
        hw, ow = int(raw[0]), int(raw[1])
        objs = raw[hw:].reshape(-1, ow)[:max_objects, :5]
        out[b, :len(objs)] = objs
    return out


def ssd_input(tmp, ctx):
    """The records of the train and held-out images through the port's
    ``ImageDetRecordIter`` (force-resized to 512², mean subtracted):
    device-resident (data, labels) batches and the iterator's rate."""
    import mxnet_tpu_torch as mx

    cfg = SSD
    n_train = cfg["train_batches"] * cfg["batch"]
    out = {}
    for name, n, seed in (("train", n_train, 11),
                          ("held_out", cfg["eval_images"], 12)):
        path = os.path.join(tmp, name + ".rec")
        write_ssd_records(path, n, seed)
        it = mx.io.ImageDetRecordIter(
            path_imgrec=path, batch_size=cfg["batch"],
            data_shape=(3, cfg["image"], cfg["image"]), resize_mode="force",
            mean_r=cfg["mean"][0], mean_g=cfg["mean"][1],
            mean_b=cfg["mean"][2], preprocess_threads=4)
        t0 = time.perf_counter()
        host = [(b.data[0].asnumpy(), b.label[0].asnumpy()) for b in it]
        out[name + "_iter_ips"] = n / (time.perf_counter() - t0)
        out[name] = [(mx.nd.array(d, ctx=ctx),
                      mx.nd.array(det_labels_from_batch(lab), ctx=ctx))
                     for d, lab in host]
    return out


def _ssd_profile(step, steps, scope_name):
    """torch.profiler over ``steps`` calls of ``step`` (after one
    untraced): device-busy ms, idle share and device launches a step,
    and the device ms a step of the kernels launched inside
    ``scope_name``'s ranges."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    events = prof.events()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    scoped = sum(e.device_time_total for e in events
                 if e.name == scope_name) / 1e3 / steps
    return {"steps": steps, "step_ms_traced": wall_ms,
            "device_busy_ms_per_step": busy, "idle_share": 1.0 - busy / wall_ms,
            "device_launches_per_step": len(kernels) / steps,
            "multibox_target_device_ms_per_step": scoped}


def nms_bound(class_counts, n_boxes, dtype_bytes, ids=True):
    """``(bound_ms, bound_by)`` of one ``nms_keep`` call on the card: the
    boxes, the ids (where there are, ``ids`` true) and the valid flags
    read once and the keep mask written once (``n_boxes`` rows an image)
    over 3.35 TB/s, against what greedy NMS needs over the type's vector
    peak: NMS_PAIR_OPS operations for each pair of valid boxes of one
    class (only they can suppress each other) and, with ids, one compare
    of ids for each pair of valid boxes.  ``class_counts`` holds one list
    an image: its valid boxes' count for each class (one class without
    ids, ``ids=None``)."""
    peak_flops = PEAK_VECTOR_FLOPS[dtype_bytes]
    per_row = (5 if ids is not None else 4) * dtype_bytes + 2
    byts = len(class_counts) * n_boxes * per_row
    ops = 0
    for counts in class_counts:
        v = sum(counts)
        ops += NMS_PAIR_OPS * sum(c * (c - 1) // 2 for c in counts)
        if ids is not None:
            ops += v * (v - 1) // 2
    t_bytes, t_ops = byts / PEAK_BYTES_S * 1e3, ops / peak_flops * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def nms_class_counts(valid, ids=None):
    """Per image, the valid boxes' count of each class present (all one
    class without ``ids``): :func:`nms_bound`'s input, read from this
    run's data."""
    valid = valid.cpu()
    if ids is None:
        return [[int(v)] if v else [] for v in valid.sum(dim=1).tolist()]
    ids = ids.cpu()
    return [torch.unique(ids[b][valid[b]], return_counts=True)[1].tolist()
            for b in range(valid.shape[0])]


#: the keys of an NMS row the kernels line carries for each shape
NMS_ROW_KEYS = ("shape", "dtype", "ids", "ms", "graph_ms", "plain_ms",
                "bound_ms", "bound_by", "mismatches")


def _nms_sorted(rows_dev, params):
    """``(boxes, valid, ids, thresh)`` that ``box_nms`` gives ``nms_keep``
    for detection rows [id, score, x1, y1, x2, y2] on the card: the rows
    in score order, the first ``topk``."""
    B, N = rows_dev.shape[:2]
    scores = rows_dev[..., 1]
    valid = scores > 0.0
    order = torch.sort(-torch.where(valid, scores, torch.full(
        (), -float("inf"), dtype=scores.dtype, device=scores.device)),
        dim=1, stable=True)[1]
    n = min(params["topk"], N) if params.get("topk", -1) > 0 else N
    order = order[:, :n]
    boxes = torch.gather(rows_dev[..., 2:6], 1,
                         order[:, :, None].expand(B, n, 4)).contiguous()
    svalid = torch.gather(valid, 1, order)
    ids = torch.gather(rows_dev[..., 0], 1, order)
    return boxes, svalid, ids, params["overlap_thresh"]


def _nms_row(boxes, svalid, ids, thresh):
    """The NMS kernel (``nms_keep`` on the card) against its plain
    version on the same card inputs: keep masks equal, the bound, and
    times: ``ms`` of a call with its host work (10 calls), ``graph_ms``
    of a call's device work alone (5 calls in a CUDA graph)."""
    from mxnet_tpu_torch.ops import contrib

    B, n = svalid.shape
    launches = contrib.nms_keep.launches
    keep = contrib.nms_keep(boxes, svalid, ids, thresh)
    # the plain version once (its N host steps make it seconds at full
    # size), timed with events around the call itself
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    plain = contrib.nms_keep_plain(boxes, svalid, ids, thresh)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    n_valid = svalid.sum(dim=1).tolist()
    per_class = nms_class_counts(svalid, ids)
    bound, by = nms_bound(per_class, n, boxes.element_size(), ids=ids)
    call = lambda: contrib.nms_keep(boxes, svalid, ids, thresh)  # noqa
    ms = time_ms(call, iters=10, warmup=2)
    dev_ms = graph_ms(call, inner=5)
    # the check's calls are no launches of the path
    contrib.nms_keep.launches = launches
    return {"shape": [B, n], "dtype": str(boxes.dtype).split(".")[-1],
            "ids": ids is not None,
            "valid_per_image": n_valid[:4],
            "largest_class_per_image": [max(c, default=0)
                                        for c in per_class[:4]],
            "kept": int(keep.sum()),
            "mismatches": int((keep != plain).sum()), "ms": ms,
            "graph_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": None}


# the RPN's NMS at the op's defaults: MultiProposal at batch 2 on the
# reference Faster R-CNN's 600 x 800 image (short side 600), stride 16,
# the 12 default anchors; rpn_pre_nms_top_n=6000, threshold 0.7
RPN = dict(batch=2, anchors=12, height=38, width=50, stride=16,
           im_info=(600.0, 800.0, 1.0))


def rpn_nms_inputs(seed=0, device="cuda"):
    """``(boxes, valid, ids, thresh)`` that ``MultiProposal`` at its
    defaults gives ``nms_keep`` (on the card by default), at RPN's
    shapes from seeded scores and deltas (float32): recorded from the
    op's own call."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import contrib

    rng = np.random.RandomState(seed)
    B, A, H, W = (RPN[k] for k in ("batch", "anchors", "height", "width"))
    fg = rng.uniform(0.0, 1.0, (B, A, H, W))
    prob = np.concatenate([1.0 - fg, fg], axis=1).astype(np.float32)
    delta = rng.normal(0.0, 0.2, (B, 4 * A, H, W)).astype(np.float32)
    info = np.tile(np.array(RPN["im_info"], np.float32), (B, 1))
    ctx = mx.gpu(0) if device == "cuda" else mx.cpu()
    real = contrib.nms_keep

    class Seen(Exception):
        pass

    def record(boxes, valid, ids=None, thresh=0.5):
        # the op stops here: its inputs are all this needs
        raise Seen(boxes, valid, ids, thresh)

    contrib.nms_keep = record
    try:
        mx.nd.contrib.MultiProposal(
            mx.nd.array(prob, ctx=ctx), mx.nd.array(delta, ctx=ctx),
            mx.nd.array(info, ctx=ctx), feature_stride=RPN["stride"])
    except Seen as seen:
        return seen.args
    finally:
        contrib.nms_keep = real
    raise RuntimeError("MultiProposal did not reach nms_keep")


def phase_ssd():
    """BASELINE config 4 at full width on the card: (a) SSD-512 on
    ResNet-50 trained at batch 32 from records, then detection and the
    VOC07 mAP on held-out images; (b) the example's SSDNet through
    its learning check."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.ops import contrib

    cfg = SSD
    ctx = mx.gpu(0)
    nd = mx.nd
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ssd_")
    try:
        feed = ssd_input(tmp, ctx)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # the main path's counts: from here to the end of (b)
    _reset_kernel_counts()
    contrib.nms_keep.calls.update(cuda=0, plain=0)
    contrib.nms_keep.calls_by_route.update(fused=0, tiled=0)

    np.random.seed(0)
    mx.random.seed(0)
    backbone = gluon.model_zoo.vision.resnet50_v1()
    net = ssd_net(mx, backbone)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": cfg["lr"],
                             "momentum": cfg["momentum"], "wd": cfg["wd"]})
    train = feed["train"]

    def step(batch, scope=None, targets=None):
        x, y = batch
        with autograd.record():
            cls, loc, anchors = net(x)
            loss = ssd_loss(nd, cls, loc, anchors, y,
                            mining_thresh=cfg["negative_mining_thresh"],
                            variances=cfg["variances"], target_scope=scope,
                            targets=targets)
        loss.backward()
        trainer.step(1)
        return loss

    # the loss on one fixed batch over the first steps from Xavier: its
    # targets (the matching and the mined negatives) taken once, at the
    # first step, so that every step's loss is of one objective; the
    # mined set otherwise moves from step to step with the predictions
    with autograd.pause(train_mode=True):
        cls, _, anchors = net(train[0][0])
        fixed_targets = ssd_targets(nd, nd.softmax(cls, axis=1), anchors,
                                    train[0][1],
                                    cfg["negative_mining_thresh"],
                                    cfg["variances"])
    if anchors.shape != (1, SSD_ANCHORS, 4):
        raise RuntimeError("ssd: %s anchors, want (1, %d, 4)"
                           % (anchors.shape, SSD_ANCHORS))
    fixed = [float(step(train[0], targets=fixed_targets).asnumpy())
             for _ in range(cfg["fixed_steps"])]
    for k in range(cfg["warmup"]):
        step(train[k % len(train)])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for batch in train:
        step(batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / len(train)
    peak = torch.cuda.max_memory_allocated()
    cycle = iter(range(10 ** 6))
    trace = _ssd_profile(
        lambda: step(train[next(cycle) % len(train)],
                     lambda: torch.profiler.record_function(
                         "MultiBoxTarget")),
        cfg["trace_steps"], "MultiBoxTarget")

    # detection on the held-out images
    x, y = feed["held_out"][0]
    with autograd.pause():
        cls, loc, anchors = net(x)
        prob = nd.softmax(cls, axis=1)
    det_kw = dict(cfg["detection"])
    launches0 = contrib.nms_keep.launches
    dets = nd.contrib.MultiBoxDetection(prob, loc, anchors, **det_kw)
    det_launches = contrib.nms_keep.launches - launches0
    _, VOC07MApMetric = map_metrics()
    metric = VOC07MApMetric(iou_thresh=0.5)
    metric.update([y], [dets])
    kept = int((dets.asnumpy()[..., 0] >= 0).sum())

    # (b) the example's SSDNet through its learning check
    t_b = time.perf_counter()
    history = example_train(mx, ctx)
    bars = example_bars(history)
    b_wall = time.perf_counter() - t_b
    counts = _kernel_counts()
    routes = dict(contrib.nms_keep.calls)
    kernel_routes = dict(contrib.nms_keep.calls_by_route)

    # timings and the kernel against its plain version, uncounted
    det_ms = time_ms(lambda: nd.contrib.MultiBoxDetection(
        prob, loc, anchors, **det_kw).wait_to_read(), iters=5, warmup=1)
    rows = contrib.detection_rows(prob._data, loc._data, anchors._data,
                                  threshold=det_kw["threshold"])
    kernel_row = _nms_row(*_nms_sorted(
        rows, dict(overlap_thresh=det_kw["nms_threshold"],
                   topk=det_kw["nms_topk"])))
    target_ms = time_ms(lambda: nd.contrib.MultiBoxTarget(
        anchors, y, prob, overlap_threshold=cfg["overlap_threshold"],
        negative_mining_ratio=cfg["negative_mining_ratio"],
        negative_mining_thresh=cfg["negative_mining_thresh"],
        variances=cfg["variances"])[2].wait_to_read(), iters=5, warmup=1)

    b = cfg["batch"]
    row = {"phase": "ssd", "config": dict(
               cfg, layout={k: [list(v) if isinstance(v, tuple) else v
                                for v in vals] if isinstance(vals, tuple)
                            else vals for k, vals in SSD_LAYOUT.items()},
               anchors=SSD_ANCHORS, backbone="resnet50_v1"),
           "a_ssd512": {
               "images_per_s": b / step_ms * 1e3, "step_ms": step_ms,
               "iter_ips": {"train": feed["train_iter_ips"],
                            "held_out": feed["held_out_iter_ips"]},
               "peak_mem_bytes": peak, "trace": trace,
               "fixed_batch_loss": fixed,
               "multibox_target_ms": target_ms,
               "detection": {"shape": [b, SSD_ANCHORS], "ms": det_ms,
                             "rows_kept": kept, "nms_launches": det_launches,
                             "voc07_map": metric.get()[1]},
               "nms_routes": routes, "nms_kernel_routes": kernel_routes},
           "b_example": {"history": history, "bars": bars,
                         "wall_s": b_wall},
           "kernel_launches": counts,
           "box_nms_kernel": kernel_row,
           "wall_s": time.perf_counter() - t_phase}
    emit(row)
    bad = []
    if not fixed[-1] < fixed[0]:
        bad.append("the fixed batch's loss did not fall: %r" % fixed)
    if not all(np.isfinite(fixed)):
        bad.append("a loss is not finite")
    if not all(bars.values()):
        bad.append("the example's bars: %r, history %r" % (bars, history))
    # every kernel route's launches add up to the count (the detection
    # and the example's evaluation run N <= 1024: the fused route)
    by_route = sum(contrib.NMS_ROUTE_LAUNCHES[r] * c
                   for r, c in kernel_routes.items())
    if counts["box_nms"] < 1 or det_launches < 1 or routes["plain"] or \
            by_route != counts["box_nms"]:
        bad.append("NMS routes %r / %r, kernel launches %d" % (
            routes, kernel_routes, counts["box_nms"]))
    if kernel_row["mismatches"]:
        bad.append("the NMS kernel's keep mask differs from the plain "
                   "version's in %d places" % kernel_row["mismatches"])
    if bad:
        raise RuntimeError("ssd: %s" % "; ".join(bad))
    return row


# -- ssd_numerics ------------------------------------------------------------
class DetCase(NamedTuple):
    """One case of the detection tier's checks: the op, its input makers
    (numpy RandomState -> array), params, the inputs whose gradient is
    compared, and the outputs (k) or their last-axis columns ((k, col))
    held equal."""
    op: str
    inputs: list
    params: dict = {}
    diff: tuple = ()
    exact: tuple = ()


def _u(*shape, lo=-2.0, hi=2.0):
    return lambda r: r.uniform(lo, hi, shape)


def det_boxes(*lead, lo=0.0, hi=1.0, min_wh=0.05, max_wh=0.5):
    """Corner boxes (..., 4) inside [lo, hi]."""
    def make(r):
        wh = r.uniform(min_wh, max_wh, lead + (2,)) * (hi - lo)
        tl = lo + r.uniform(0, 1, lead + (2,)) * (hi - lo - wh)
        return np.concatenate([tl, tl + wh], axis=-1)
    return make


def nms_rows(B, N, classes=3, ties=True):
    """(B, N, 6) rows [id, score, x1, y1, x2, y2] clustered so that
    boxes overlap, with repeated scores (ties) and some below 0."""
    def make(r):
        centres = r.uniform(0.2, 0.8, (B, 4, 2))
        pick = r.randint(0, 4, (B, N))
        c = np.take_along_axis(centres, pick[..., None], axis=1) + \
            r.normal(0, 0.04, (B, N, 2))
        wh = r.uniform(0.1, 0.3, (B, N, 2))
        score = r.uniform(-0.2, 1.0, (B, N))
        if ties:
            score[:, ::3] = score[:, :1]
            score[:, 1::5] = 0.5
        ids = r.randint(0, classes, (B, N)).astype(np.float64)
        return np.concatenate([ids[..., None], score[..., None],
                               c - wh / 2, c + wh / 2], axis=-1)
    return make


def softmax_probs(B, C, N, ties=True):
    """(B, C, N) class probabilities, every 4th anchor's the same."""
    def make(r):
        x = r.normal(0, 1.5, (B, C, N))
        if ties:
            x[:, :, ::4] = x[:, :, :1]
        e = np.exp(x - x.max(1, keepdims=True))
        return e / e.sum(1, keepdims=True)
    return make


def priors(h, w, sizes=(0.2, 0.35), ratios=(1.0, 2.0)):
    """The (1, h*w*A, 4) anchors of an (h, w) map (the port's
    MultiBoxPrior on the CPU, float64)."""
    def make(r):
        from mxnet_tpu_torch.ops import registry

        return registry.get("MultiBoxPrior").fn(
            torch.zeros((1, 1, h, w), dtype=torch.float64), sizes=sizes,
            ratios=ratios).numpy()
    return make


def det_labels(B, O, classes=3):
    """(B, O, 5) gt rows [cls, x1, y1, x2, y2], -1 padded, at least one
    object an image."""
    def make(r):
        lab = np.full((B, O, 5), -1.0)
        for b in range(B):
            for o in range(r.randint(1, O + 1)):
                lab[b, o, 0] = r.randint(0, classes)
                lab[b, o, 1:] = det_boxes(min_wh=0.15, max_wh=0.6)(r)
        return lab
    return make


def det_rois(R, B, size, scale=1.0):
    """(R, 5) rois [batch, x1, y1, x2, y2] in image coordinates, every
    other one's corners on halves (round half to even)."""
    def make(r):
        b = r.randint(0, B, (R, 1)).astype(np.float64)
        bx = det_boxes(R, lo=0.0, hi=size / scale - 1, min_wh=0.2,
                       max_wh=0.8)(r)
        bx[::2] = np.round(bx[::2] * 2) / 2
        return np.concatenate([b, bx], axis=1)
    return make


def _const(a):
    return lambda r: np.asarray(a, np.float64)


def ctc_labels(B, L, A, blank_last=False):
    def make(r):
        lab = np.full((B, L), -1.0 if blank_last else 0.0)
        lo, hi = (0, A - 1) if blank_last else (1, A)
        for b in range(B):
            n = r.randint(1, L + 1)
            lab[b, :n] = r.randint(lo, hi, n)
        return lab
    return make


C = DetCase
#: every op of the detection tier, each name at least once (the tests
#: hold the port to the JAX package on them; ``ssd_numerics`` holds the
#: card to the CPU)
DET_CASES = [
    # box ops
    C("_contrib_box_iou", [det_boxes(3, 2), det_boxes(4)]),
    C("box_iou", [det_boxes(2, 4), det_boxes(3)], dict(format="center")),
    C("_contrib_box_nms", [nms_rows(3, 40)],
      dict(overlap_thresh=0.45, id_index=0), exact=(0,)),
    C("box_nms", [nms_rows(2, 30)],
      dict(overlap_thresh=0.3, topk=12, valid_thresh=0.1), exact=(0,)),
    C("box_nms", [nms_rows(1, 25)],
      dict(overlap_thresh=0.5, id_index=0, force_suppress=True,
           in_format="center"), exact=(0,)),
    C("box_nms", [lambda r: nms_rows(1, 20)(r)[0]],
      dict(overlap_thresh=0.5), exact=(0,)),
    # SSD
    C("_contrib_MultiBoxPrior", [_u(1, 3, 4, 5)],
      dict(sizes=(0.3, 0.5), ratios=(1.0, 2.0, 0.5))),
    C("MultiBoxPrior", [_u(2, 1, 3, 3)],
      dict(sizes=(0.9,), ratios=(1.0, 3.0), clip=True, steps=(0.4, 0.3),
           offsets=(0.2, 0.7))),
    C("_contrib_MultiBoxTarget",
      [priors(4, 4), det_labels(3, 3), softmax_probs(3, 4, 48)],
      dict(overlap_threshold=0.5), exact=(1, 2)),
    C("MultiBoxTarget",
      [priors(4, 4), det_labels(4, 2), softmax_probs(4, 4, 48)],
      dict(overlap_threshold=0.4, negative_mining_ratio=3.0,
           negative_mining_thresh=0.3, minimum_negative_samples=2,
           variances=(0.1, 0.1, 0.2, 0.2)), exact=(1, 2)),
    C("MultiBoxTarget",
      [priors(3, 3), det_labels(2, 3), softmax_probs(2, 3, 27)],
      dict(negative_mining_ratio=1.0, negative_mining_thresh=0.2,
           ignore_label=-2.0, variances=(0.2, 0.1, 0.3, 0.25)),
      exact=(1, 2)),
    C("_contrib_MultiBoxDetection",
      [softmax_probs(2, 4, 48), _u(2, 192, lo=-0.5, hi=0.5), priors(4, 4)],
      dict(threshold=0.2, nms_threshold=0.45), exact=((0, 0),)),
    C("MultiBoxDetection",
      [softmax_probs(3, 3, 27), _u(3, 108, lo=-0.5, hi=0.5), priors(3, 3)],
      dict(threshold=0.01, nms_threshold=0.3, nms_topk=10, clip=False,
           force_suppress=True), exact=((0, 0),)),
    C("MultiBoxDetection",
      [softmax_probs(1, 4, 48), _u(1, 192, lo=-0.5, hi=0.5), priors(4, 4)],
      dict(background_id=1, variances=(0.2, 0.2, 0.1, 0.1)),
      exact=((0, 0),)),
    # the RPN
    C("_contrib_Proposal",
      [lambda r: r.rand(1, 24, 4, 4), _u(1, 48, 4, 4, lo=-0.1, hi=0.1),
       _const([[64, 64, 1.0]])],
      dict(rpn_pre_nms_top_n=50, rpn_post_nms_top_n=10, rpn_min_size=1),
      exact=((0, 0),)),
    C("Proposal",
      [lambda r: r.rand(1, 6, 5, 4), _u(1, 12, 5, 4, lo=-0.3, hi=0.3),
       _const([[40, 32, 1.5]])],
      dict(rpn_pre_nms_top_n=40, rpn_post_nms_top_n=30, threshold=0.5,
           rpn_min_size=4, scales=(2.0, 4.0, 8.0), ratios=(1.0,),
           feature_stride=8, output_score=True), exact=((0, 0),)),
    C("Proposal",
      [lambda r: r.rand(1, 6, 3, 3), _u(1, 12, 3, 3), _const([[48, 48, 1.0]])],
      dict(rpn_pre_nms_top_n=-1, rpn_post_nms_top_n=8, rpn_min_size=1,
           scales=(2.0, 4.0, 8.0), ratios=(1.0,), feature_stride=8,
           iou_loss=True), exact=((0, 0),)),
    C("_contrib_MultiProposal",
      [lambda r: r.rand(2, 24, 3, 3), _u(2, 48, 3, 3, lo=-0.1, hi=0.1),
       _const([[48, 48, 1.0], [40, 44, 1.0]])],
      dict(rpn_pre_nms_top_n=30, rpn_post_nms_top_n=5, rpn_min_size=1,
           output_score=True), exact=((0, 0),)),
    # R-FCN, DCN
    C("_contrib_PSROIPooling", [_u(2, 8, 9, 9), det_rois(5, 2, 9)],
      dict(spatial_scale=1.0, output_dim=2, pooled_size=2), (0,)),
    C("PSROIPooling", [_u(1, 18, 8, 10), det_rois(4, 1, 16, 0.5)],
      dict(spatial_scale=0.5, output_dim=2, pooled_size=3, group_size=3),
      (0,)),
    C("_contrib_DeformableConvolution",
      [_u(2, 4, 6, 6), _u(2, 18, 4, 4, lo=-1.3, hi=1.3), _u(6, 4, 3, 3),
       _u(6)], dict(kernel=(3, 3), num_filter=6), (0, 1, 2, 3)),
    C("DeformableConvolution",
      [_u(1, 4, 7, 6), _u(1, 36, 4, 3, lo=-2.5, hi=2.5), _u(4, 2, 3, 3)],
      dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), num_filter=4,
           num_group=2, num_deformable_group=2, no_bias=True), (0, 1, 2)),
    C("_contrib_DeformablePSROIPooling",
      [_u(2, 8, 8, 8), det_rois(3, 2, 8), _u(3, 2, 2, 2, lo=-1, hi=1)],
      dict(spatial_scale=1.0, output_dim=2, group_size=2, pooled_size=2,
           sample_per_part=2, trans_std=0.1), (0, 2)),
    C("DeformablePSROIPooling",
      [_u(1, 8, 7, 7), det_rois(2, 1, 7), _u(2, 4, 1, 1, lo=-1, hi=1)],
      dict(spatial_scale=1.0, output_dim=2, group_size=2, pooled_size=2,
           part_size=1, sample_per_part=1, trans_std=0.2), (0, 2)),
    C("DeformablePSROIPooling", [_u(1, 4, 6, 6), det_rois(2, 1, 6)],
      dict(spatial_scale=1.0, output_dim=1, group_size=2, pooled_size=2,
           sample_per_part=2, no_trans=True), (0,)),
    # CTC
    C("_contrib_CTCLoss", [_u(6, 3, 5), ctc_labels(3, 3, 5)], {}, (0,)),
    C("ctc_loss",
      [_u(7, 2, 4), ctc_labels(2, 3, 4), _const([7, 5]), _const([3, 1])],
      dict(use_data_lengths=True, use_label_lengths=True), (0,)),
    C("CTCLoss", [_u(5, 2, 4), ctc_labels(2, 2, 4, blank_last=True)],
      dict(blank_label="last"), (0,)),
    # FFT
    C("_contrib_fft", [_u(3, 8)], {}, (0,)),
    C("fft", [_u(2, 3, 6)], dict(compute_size=64), (0,)),
    C("_contrib_ifft", [_u(3, 16)], {}, (0,)),
    C("ifft", [_u(2, 10)], {}, (0,)),
    # quantisation, count sketch
    C("_contrib_quantize",
      [_u(3, 5, lo=-1, hi=3), _const([-1.0]), _const([3.0])], exact=(0,)),
    C("quantize", [_u(4, 4), _const([-2.0]), _const([2.0])],
      dict(out_type="int8"), exact=(0,)),
    C("_contrib_dequantize",
      [lambda r: r.randint(0, 256, (3, 4)).astype(np.uint8),
       _const([-1.0]), _const([3.0])]),
    C("dequantize",
      [lambda r: r.randint(-127, 128, (3, 4)).astype(np.int8),
       _const([-2.0]), _const([2.0])]),
    C("_contrib_count_sketch",
      [_u(4, 6), lambda r: r.randint(0, 3, 6).astype(np.float64),
       lambda r: r.choice([-1.0, 1.0], 6)], dict(out_dim=3)),
    C("count_sketch",
      [_u(2, 5), lambda r: r.randint(0, 4, (1, 7)).astype(np.float64),
       lambda r: r.choice([-1.0, 1.0], (1, 7))], dict(out_dim=4)),
    # the spatial tail of ops/nn.py
    C("UpSampling", [_u(2, 3, 3, 4)],
      dict(scale=2, sample_type="nearest", num_args=1), (0,)),
    C("UpSampling", [_u(1, 2, 4, 4), _u(1, 3, 2, 2)],
      dict(scale=2, sample_type="nearest", num_args=2,
           multi_input_mode="concat"), (0, 1)),
    C("UpSampling", [_u(2, 2, 3, 5)],
      dict(scale=2, sample_type="bilinear", num_args=1), (0,)),
    C("UpSampling", [_u(1, 2, 4, 3)],
      dict(scale=3, sample_type="bilinear", num_args=1), (0,)),
    C("BilinearSampler", [_u(2, 3, 5, 6), _u(2, 2, 4, 3, lo=-1.2, hi=1.2)],
      {}, (0, 1)),
    C("GridGenerator", [_u(2, 6)],
      dict(transform_type="affine", target_shape=(4, 5)), (0,)),
    C("GridGenerator", [_u(2, 2, 3, 4)],
      dict(transform_type="warp", target_shape=(3, 4)), (0,)),
    C("SpatialTransformer",
      [_u(2, 3, 6, 5), lambda r: np.tile([0.9, 0.1, 0.05, -0.1, 0.8, -0.05],
                                         (2, 1)) + r.uniform(-0.1, 0.1,
                                                             (2, 6))],
      dict(target_shape=(4, 4)), (0, 1)),
    C("ROIPooling", [_u(2, 3, 8, 9), det_rois(6, 2, 8)],
      dict(pooled_size=(2, 3), spatial_scale=1.0), (0,)),
    C("ROIPooling", [_u(1, 2, 10, 10), det_rois(4, 1, 20, 0.5)],
      dict(pooled_size=(3, 3), spatial_scale=0.5), (0,)),
    C("Crop", [_u(2, 3, 7, 8)], dict(offset=(1, 2), h_w=(4, 5)), (0,)),
    C("Crop", [_u(1, 2, 7, 8), _u(1, 1, 4, 4)],
      dict(num_args=2, center_crop=True), (0,)),
    C("CuDNNBatchNorm",
      [_u(4, 3, 2, 2), _u(3, lo=0.5, hi=2), _u(3), _u(3), _u(3, lo=0.5, hi=2)],
      dict(fix_gamma=False, eps=1e-3, _training=True), (0, 1, 2)),
    # bipartite matching: ties, thresholds, ascending, topk
    C("_contrib_bipartite_matching",
      [lambda r: np.round(r.uniform(0, 1, (2, 5, 4)), 1)],
      dict(threshold=0.2), exact=(0, 1)),
    C("bipartite_matching", [_u(6, 3, lo=0, hi=1)],
      dict(is_ascend=True, threshold=0.8, topk=1), exact=(0, 1)),
    C("bipartite_matching", [_u(3, 7, lo=0, hi=1)], {}, exact=(0, 1)),
]
del C


def det_case_id(case):
    return case.op + "-" + "-".join("%s=%s" % kv for kv in
                                    sorted(case.params.items()))[:70]


def det_case_inputs(case, dtype=np.float64, seed=0):
    """The case's inputs (float ones cast to ``dtype``) and the numpy
    RandomState that made them, for the cotangent next."""
    rng = np.random.RandomState(seed)
    ins = []
    for f in case.inputs:
        a = np.asarray(f(rng))
        ins.append(a.astype(dtype) if a.dtype.kind == "f" else a)
    return ins, rng


def det_case_err(got, want, case, k):
    """The error of output ``k`` against ``want`` as the case holds it:
    for an exact output (or column) the count of unequal entries,
    otherwise the largest difference over the largest magnitude (at
    least 1)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        return float("inf")
    if k in case.exact:
        return float((got != want).sum())
    cols = [e[1] for e in case.exact if isinstance(e, tuple) and e[0] == k]
    if cols and (got[..., cols] != want[..., cols]).any():
        return float("inf")
    if not want.size:
        return 0.0
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1.0)


def run_det_case(case, device, ins, cot_rng=None):
    """The port's op of ``case`` on ``device``: its outputs, and with
    ``cot_rng`` the gradients of output 0 under a seeded cotangent with
    respect to the case's ``diff`` inputs (as numpy)."""
    from mxnet_tpu_torch.ops import registry

    fn = registry.get(case.op).bound(**case.params)
    tins = [torch.tensor(a, device=device,
                         requires_grad=i in case.diff and cot_rng is not None)
            for i, a in enumerate(ins)]
    outs = fn(*tins)
    outs = outs if isinstance(outs, tuple) else (outs,)
    grads = []
    if cot_rng is not None and case.diff:
        cot = cot_rng.standard_normal(tuple(outs[0].shape))
        gs = torch.autograd.grad(outs[0], [tins[i] for i in case.diff],
                                 torch.tensor(cot, dtype=outs[0].dtype,
                                              device=device),
                                 allow_unused=True)
        grads = [np.zeros(ins[i].shape) if g is None else
                 g.detach().cpu().numpy() for i, g in zip(case.diff, gs)]
    return [o.detach().cpu().numpy() for o in outs], grads


def _det_card_vs_cpu():
    """Every detection case in float64 on the card against the CPU:
    the worst error a name, forward and gradient."""
    worst = {}
    for case in DET_CASES:
        ins, rng = det_case_inputs(case)
        state = rng.get_state()
        cpu, cpu_g = run_det_case(case, "cpu", ins, rng)
        rng.set_state(state)
        card, card_g = run_det_case(case, "cuda", ins, rng)
        tol = SSD_FFT_TOL if case.op.endswith("fft") else SSD_NUM_TOL
        errs = [det_case_err(c, w, case, k)
                for k, (c, w) in enumerate(zip(card, cpu))]
        errs += [det_case_err(c, w, DetCase(case.op, ()), -1)
                 for c, w in zip(card_g, cpu_g)]
        err = max(errs)
        prev = worst.get(case.op, (0.0, tol))
        worst[case.op] = (max(prev[0], err), tol)
    return worst


def ssd512_priors(device="cpu"):
    """The SSD-512 layout's (1, 6132, 4) float64 priors on ``device``."""
    from mxnet_tpu_torch.ops import registry

    fn = registry.get("MultiBoxPrior").fn
    return torch.cat([
        fn(torch.zeros((1, 1, m, m), dtype=torch.float64, device=device),
           sizes=s, ratios=r)
        for m, s, r in zip(SSD_MAPS, SSD_LAYOUT["sizes"],
                           SSD_LAYOUT["ratios"])], dim=1)


def _nms_full_rows(seed=21):
    """(32, 6132) float64 detection rows at the SSD-512 layout: its
    priors decoded from seeded offsets, 21-way softmax scores
    (MultiBoxDetection's rows before its NMS, on the CPU)."""
    from mxnet_tpu_torch.ops import contrib

    rng = np.random.RandomState(seed)
    anchors = ssd512_priors()
    B, N = SSD["batch"], anchors.shape[1]
    prob = torch.tensor(softmax_probs(B, SSD["classes"] + 1, N)(rng))
    loc = torch.tensor(rng.normal(0, 0.5, (B, N * 4)))
    return contrib.detection_rows(prob, loc, anchors,
                                  threshold=SSD["detection"]["threshold"])


def _mini_rcnn_step(mx, ctx, seed=0):
    """One float64 step of ``examples/rcnn/mini_rcnn.py``'s network
    (conv features, RPN, MultiProposal, ROIPooling, a head) on ``ctx``:
    the loss and every parameter's gradient."""
    from mxnet_tpu_torch import autograd, gluon

    nd = mx.nd
    np.random.seed(seed)
    mx.random.seed(seed)
    net = mini_rcnn_net(mx)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    with autograd.pause():
        net(nd.zeros((2, 3, MINI_RCNN["image"], MINI_RCNN["image"]), ctx=ctx))
    net.cast("float64")
    rng = np.random.RandomState(seed)
    imgs, boxes, cls = mini_rcnn_batch(rng, 4)
    x = nd.array(imgs, ctx=ctx, dtype="float64")
    y = nd.array(cls.astype(np.float64), ctx=ctx, dtype="float64")
    ce = gluon.loss.SoftmaxCrossEntropyLoss(axis=1)
    with autograd.record():
        score, delta, rois, logits = net(x)
        loss = (-(nd.log_softmax(score.reshape((4, 2, -1)), axis=1)[:, 1, :])
                .mean() + ce(logits, y).mean() + (delta ** 2).mean())
    loss.backward()
    grads = {i: p.grad().asnumpy() for i, p in
             enumerate(net.collect_params().values())}
    return float(loss.asnumpy()), grads, rois.asnumpy()


MINI_RCNN = dict(image=64, stride=8, scales=(2.0, 4.0, 8.0), ratios=(1.0,))


def mini_rcnn_batch(rng, n):
    """``mini_rcnn.make_batch``: one bright rectangle an image, its
    colour the class."""
    size = MINI_RCNN["image"]
    imgs = np.zeros((n, 3, size, size), np.float32)
    boxes = np.zeros((n, 4), np.float32)
    cls = rng.randint(0, 3, n)
    for i in range(n):
        w, h = rng.randint(16, 33, 2)
        x0 = rng.randint(0, size - w)
        y0 = rng.randint(0, size - h)
        imgs[i, cls[i], y0:y0 + h, x0:x0 + w] = 1.0
        boxes[i] = (x0, y0, x0 + w, y0 + h)
    return imgs, boxes, cls


def mini_rcnn_net(pkg):
    """``examples/rcnn/mini_rcnn.py``'s ``MiniRCNN`` on either package:
    three strided convs, the RPN's score and box convs, MultiProposal
    (8 rois an image), ROIPooling to 4x4, a Dense head averaged over
    each image's rois."""
    gluon, nd = pkg.gluon, pkg.nd
    cfg = MINI_RCNN
    n_anchor = len(cfg["scales"]) * len(cfg["ratios"])

    class MiniRCNN(gluon.Block):
        def __init__(self):
            super().__init__()
            self.backbone = gluon.nn.Sequential()
            for c in (16, 32, 64):
                self.backbone.add(gluon.nn.Conv2D(c, 3, strides=2, padding=1,
                                                  activation="relu"))
            self.rpn_cls = gluon.nn.Conv2D(2 * n_anchor, 1)
            self.rpn_reg = gluon.nn.Conv2D(4 * n_anchor, 1)
            self.head = gluon.nn.Sequential()
            self.head.add(gluon.nn.Flatten(),
                          gluon.nn.Dense(32, activation="relu"),
                          gluon.nn.Dense(3))

        def forward(self, x):
            feat = self.backbone(x)
            rpn_score = self.rpn_cls(feat)
            rpn_delta = self.rpn_reg(feat)
            n, _, fh, fw = rpn_score.shape
            probs = nd.softmax(rpn_score.reshape((n, 2, -1)), axis=1)
            probs = probs.reshape((n, 2 * n_anchor, fh, fw))
            info = nd.array([[cfg["image"], cfg["image"], 1.0]] * n,
                            ctx=x.context, dtype=x.dtype)
            rois = nd.contrib.MultiProposal(
                probs, rpn_delta, info, feature_stride=cfg["stride"],
                scales=cfg["scales"], ratios=cfg["ratios"],
                rpn_pre_nms_top_n=64, rpn_post_nms_top_n=8, threshold=0.7,
                rpn_min_size=4)
            pooled = nd.ROIPooling(feat, rois, pooled_size=(4, 4),
                                   spatial_scale=1.0 / cfg["stride"])
            logits = self.head(pooled).reshape((n, -1, 3)).mean(axis=1)
            return rpn_score, rpn_delta, rois, logits

    return MiniRCNN()


DET_FAULTS = ("prior_half_cell", "nms_ignore_ids",
              "encode_variances_swapped")


class _IdsDropped:
    """The NMS kernel's library with the class ids withheld from it."""

    def __init__(self, lib):
        self.lib = lib

    def __getattr__(self, name):
        return getattr(self.lib, name)

    def mxt_box_nms_keep(self, dtype, boxes, ids, *rest):
        return self.lib.mxt_box_nms_keep(dtype, boxes, None, *rest)


@contextlib.contextmanager
def planted_det_fault(*faults):
    """Plant faults of DET_FAULTS on the card path (CUDA tensors only)
    for the body of the ``with``: ``prior_half_cell`` moves
    MultiBoxPrior's centres half a cell, ``nms_ignore_ids`` lets the NMS
    kernel suppress across classes, ``encode_variances_swapped`` swaps
    MultiBoxTarget's x/y and w/h variances."""
    from mxnet_tpu_torch.ops import contrib, registry

    saved = []

    def patch(obj, attr, new):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, new)

    if "prior_half_cell" in faults:
        op = registry.get("MultiBoxPrior")
        prior = op.fn

        def shifted(data, *args, offsets=(0.5, 0.5), **kw):
            if data.is_cuda:
                offsets = (offsets[0] + 0.5, offsets[1] + 0.5)
            return prior(data, *args, offsets=offsets, **kw)
        patch(op, "fn", shifted)
    if "nms_ignore_ids" in faults:
        lib = contrib._nms_lib
        patch(contrib, "_nms_lib", lambda: _IdsDropped(lib()))
    if "encode_variances_swapped" in faults:
        encode = contrib._encode_box

        def swapped(gt, anchor, variances):
            if anchor.is_cuda:
                variances = tuple(variances[2:]) + tuple(variances[:2])
            return encode(gt, anchor, variances)
        patch(contrib, "_encode_box", swapped)
    try:
        yield
    finally:
        for obj, attr, old in reversed(saved):
            setattr(obj, attr, old)


def phase_ssd_numerics():
    """The detection tier in float64 on the card against the CPU: every
    op of DET_CASES forward and backward, box_nms at (32, 6132), the
    RPN's NMS at (2, 6000) (float32, no ids: ``box_nms_rpn``), one mini
    R-CNN step, and three planted faults the checks must read."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import registry

    t0 = time.perf_counter()
    _reset_kernel_counts()
    worst = _det_card_vs_cpu()
    bad = ["%s: %.3g > %g" % (n, e, tol) for n, (e, tol) in worst.items()
           if not e <= tol]

    # box_nms at the SSD-512 detection's full size, classes apart
    rows = _nms_full_rows()
    nms = registry.get("box_nms").fn
    kw = dict(overlap_thresh=SSD["detection"]["nms_threshold"], id_index=0)
    card_rows = nms(rows.cuda(), **kw).cpu()
    cpu_rows = nms(rows, **kw)
    nms_mismatch = int((card_rows[..., 0] != cpu_rows[..., 0]).sum())
    nms_err = float((card_rows - cpu_rows).abs().max())
    full_row = _nms_row(*_nms_sorted(rows.cuda(), dict(kw, topk=-1)))
    if nms_mismatch or nms_err or full_row["mismatches"]:
        bad.append("box_nms at %s: %d keep mismatches card vs CPU, %d "
                   "kernel vs plain, error %g" % (list(rows.shape[:2]),
                                                  nms_mismatch,
                                                  full_row["mismatches"],
                                                  nms_err))
    # the RPN's NMS at MultiProposal's defaults: one class, no ids
    rpn_row = _nms_row(*rpn_nms_inputs())
    if rpn_row["mismatches"] or rpn_row["shape"] != [RPN["batch"], 6000]:
        bad.append("box_nms_rpn at %s: %d keep mismatches kernel vs plain"
                   % (rpn_row["shape"], rpn_row["mismatches"]))

    # one mini R-CNN step (MultiProposal -> ROIPooling)
    c_loss, c_grads, c_rois = _mini_rcnn_step(mx, mx.cpu())
    g_loss, g_grads, g_rois = _mini_rcnn_step(mx, mx.gpu(0))
    rcnn_err = max([abs(g_loss - c_loss) / max(abs(c_loss), 1.0),
                    float(np.abs(g_rois - c_rois).max()) / 64.0]
                   + [float(np.abs(g_grads[k] - c_grads[k]).max())
                      / max(float(np.abs(c_grads[k]).max()), 1.0)
                      for k in c_grads])
    if not rcnn_err <= SSD_NUM_TOL:
        bad.append("mini R-CNN step: %.3g" % rcnn_err)

    # planted faults: each check must read its fault
    faults = {}
    for fault in DET_FAULTS:
        with planted_det_fault(fault):
            if fault == "prior_half_cell":
                faults[fault] = float((ssd512_priors("cuda").cpu()
                                       - ssd512_priors()).abs().max())
            elif fault == "nms_ignore_ids":
                faults[fault] = float((nms(rows.cuda(), **kw).cpu()[..., 0]
                                       != cpu_rows[..., 0]).sum())
            else:
                case = next(c for c in DET_CASES
                            if c.op == "_contrib_MultiBoxTarget")
                ins, _ = det_case_inputs(case)
                cpu, _ = run_det_case(case, "cpu", ins)
                card, _ = run_det_case(case, "cuda", ins)
                faults[fault] = det_case_err(card[0], cpu[0], case, 0)
    clean_prior = float((ssd512_priors("cuda").cpu()
                         - ssd512_priors()).abs().max())
    missed = [f for f, e in faults.items() if not e > SSD_NUM_TOL]
    if missed or clean_prior:
        bad.append("planted faults not read: %r (clean priors %g)"
                   % (missed, clean_prior))
    counts = _kernel_counts()
    row = {"phase": "ssd_numerics", "dtype": "float64",
           "ops": {k: v[0] for k, v in worst.items()},
           "cases": len(DET_CASES),
           "box_nms_full": {"shape": list(rows.shape[:2]),
                            "keep_mismatches_card_vs_cpu": nms_mismatch,
                            "err": nms_err, "kernel": full_row},
           "box_nms_rpn": rpn_row,
           "mini_rcnn_err": rcnn_err, "faults": faults,
           "kernel_launches": counts,
           "wall_s": time.perf_counter() - t0}
    emit(row)
    if bad:
        raise RuntimeError("ssd_numerics: %s" % "; ".join(bad))
    return row


#: wall seconds of each phase of this run, from its call to its return
PHASE_S = {}


def _timed(fn):
    @functools.wraps(fn)
    def run(*args, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            name = fn.__name__[len("phase_"):]
            PHASE_S[name] = round(time.perf_counter() - t0, 3)
            # as it ends, on stderr: a run cut short still shows them
            print("[phase_seconds] %s %.3f" % (name, PHASE_S[name]),
                  file=sys.stderr, flush=True)

    return run


for _name, _fn in list(globals().items()):
    if _name.startswith("phase_") and callable(_fn):
        globals()[_name] = _timed(_fn)
del _name, _fn


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    t_start = time.perf_counter()
    # without the rest of the repository beside this script the import
    # fails here, before anything is printed
    import mxnet_tpu_torch  # noqa: F401

    phase_device()
    phase_build()
    rows = phase_kernel()
    bwd_rows = phase_kernel_bwd()
    add_rows = phase_rtc_add()
    serve, served_rt, prompts = phase_serve()
    http, pred = phase_serve_http(served_rt, prompts, serve)
    load = phase_loadgen(served_rt)
    del served_rt
    phase_reload(pred)
    phase_serve_cli()
    phase_numerics()
    ndrow = phase_ndarray()
    train = phase_train()
    phase_train_numerics()
    inp = phase_input(train)
    lm = phase_train_lm()
    phase_train_lm_numerics()
    fit = phase_fit()
    phase_fit_numerics()
    phase_export()
    dp = phase_dp(train)
    phase_dp_numerics()
    remat_row, cell = phase_remat()
    memory = phase_memory_remat()
    large = phase_large_batch_remat(cell, train)
    del cell
    remat_num = phase_remat_numerics()
    lm_dp = phase_train_lm_dp(lm)
    lm_dp_num = phase_train_lm_dp_numerics()
    lm_sp = phase_train_lm_sp()
    # two numerics phases side by side: each spawns its own gloo ranks on
    # cuda:0, and neither is timed
    lm_sp_num, _ = side_by_side(lambda: phase_train_lm_sp_numerics(),
                                lambda: phase_module_dp_numerics())
    # both paths run in their ranks' and workers' processes, which count
    # their own launches
    tp_counts = phase_tp()["ranks"][0]["kernel_launches"]
    phase_tp_numerics()
    dist_counts = phase_dist()["runs"]["dense"]["kernel_launches"]
    phase_dist_numerics()
    sparse_counts = {"sparse": phase_sparse()["kernel_launches"],
                     "recommender": phase_recommender()["kernel_launches"],
                     "recommender_numerics":
                         phase_recommender_numerics()["kernel_launches"]}
    t_obs = time.perf_counter()
    prof = phase_profiler()
    tv = phase_traceview(lm)
    ckpt = phase_ckpt_async()
    obs_s = time.perf_counter() - t_obs
    tuning = phase_tuning()
    rnn = phase_rnn()
    rnn_num = phase_rnn_numerics()
    rnn_counts = {"rnn": rnn["kernel_launches"],
                  "rnn_numerics": rnn_num["kernel_launches"]}
    ssd = phase_ssd()
    ssd_num = phase_ssd_numerics()
    det_counts = {"ssd": ssd["kernel_launches"],
                  "ssd_numerics": ssd_num["kernel_launches"]}
    obs_counts = {"profiler": prof["kernel_launches"],
                  "traceview_train_lm": tv["train_lm"]["kernel_launches"],
                  "traceview_serve": tv["serve"]["kernel_launches"],
                  "ckpt_async": ckpt["kernel_launches"],
                  "tuning": tuning["kernel_launches"]}
    sp_counts = {
        "train_lm_sp_%s_per_step_rank%d" % (impl, r): c
        for impl, v in lm_sp["per_impl"].items()
        for r, c in enumerate(v["launches_per_step_per_rank"])}
    sp_num_counts = {
        "train_lm_sp_numerics_%s_%s_rank%d" % (mesh, impl, r):
            lm_sp_num[mesh]["launches"]["rank%d_%s" % (r, impl)]
        for mesh in ("sp2", "dp2_sp2") for impl in ("ring", "ulysses")
        for r in range(2 if mesh == "sp2" else 4)}
    dp_counts = dp["runs"][1]["kernel_launches"]
    lm_dp_counts = lm_dp["per_rank"][0]["kernel_launches"]
    memory_counts = {"remat": remat_row["kernel_launches"],
                     "memory_remat": memory["kernel_launches"],
                     "large_batch_remat": large["kernel_launches"],
                     "remat_numerics": remat_num["kernel_launches"]}
    inp_counts = inp["kernel_launches"]
    main_row, bwd_row = rows[0], bwd_rows[0]
    add_row = next(r for r in add_rows if "kernel_ms" in r)
    nms_row = ssd["box_nms_kernel"]
    kernels = [{
        "name": "flash_attention_fwd", "route": "cuda",
        "kernel_route": main_row["route"],
        "source": "mxnet_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "mxnet_tpu/parallel/attention.py:126",
        "launches": serve["flash_launches"],
        "launches_by_route": serve["flash_launches_by_route"],
        "launches_by_path": {"serve": serve["flash_launches"],
                             "serve_http": http["flash_launches"],
                             "loadgen": load["flash_launches"],
                             "train_lm": lm["kernel_launches"][
                                 "flash_attention_fwd"],
                             "fit": fit["kernel_launches"][
                                 "flash_attention_fwd"],
                             "dp": dp_counts["flash_attention_fwd"],
                             "train_lm_dp": lm_dp_counts[
                                 "flash_attention_fwd"],
                             "train_lm_dp_per_step_per_rank":
                                 lm_dp_counts["flash_attention_fwd"] /
                                 lm_dp["per_rank"][0]["steps_counted"],
                             "train_lm_dp_numerics": lm_dp_num[
                                 "kernel_launches"]["flash_attention_fwd"],
                             **{k: v["flash_attention_fwd"]
                                for k, v in sp_counts.items()},
                             **{k: v["flash_attention_fwd"]
                                for k, v in sp_num_counts.items()},
                             **{k: v["flash_attention_fwd"]
                                for k, v in memory_counts.items()},
                             "input": inp_counts["flash_attention_fwd"],
                             "tp": tp_counts["flash_attention_fwd"],
                             "dist": dist_counts["flash_attention_fwd"],
                             **{k: v["flash_attention_fwd"]
                                for k, v in sparse_counts.items()},
                             **{k: v["flash_attention_fwd"]
                                for k, v in obs_counts.items()},
                             **{k: v["flash_attention_fwd"]
                                for k, v in rnn_counts.items()},
                             **{k: v["flash_attention_fwd"]
                                for k, v in det_counts.items()}},
        "max_abs_err": max(r["max_err"] for r in rows),
        "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "single_call_ms": main_row["single_call_ms"],
        "graph_ms": main_row["graph_ms"],
        "library_graph_ms": main_row["library_graph_ms"],
        "shape": main_row["shape"], "dtype": main_row["dtype"],
        "train_shape": bwd_row["shape"],
        "train_ms_with_lse": bwd_row["fwd_lse_ms"],
        "train_ms_without_lse": bwd_row["fwd_ms"],
        # the forward's bound at the train shape (its lse's 4 bytes a
        # row are not counted: 0.8 % of the bytes)
        "train_bound_ms": attention_bound(*bwd_row["shape"], True,
                                          torch.bfloat16)[0],
    }, {
        "name": "flash_attention_bwd", "route": "cuda",
        "kernel_route": bwd_row["route"],
        "launches_by_route": lm["kernel_launches"][
            "flash_attention_bwd_by_route"],
        "source": "mxnet_tpu_torch/csrc/flash_attn_bwd.cu",
        # the VJP of the scan flash_attention, which the JAX package
        # trains through (the Pallas kernel at :126 is forward only)
        "replaces": "mxnet_tpu/parallel/attention.py:76",
        "launches": lm["kernel_launches"]["flash_attention_bwd"],
        "launches_by_path": {"train_lm": lm["kernel_launches"][
                                 "flash_attention_bwd"],
                             "fit": fit["kernel_launches"][
                                 "flash_attention_bwd"],
                             "dp": dp_counts["flash_attention_bwd"],
                             "train_lm_dp": lm_dp_counts[
                                 "flash_attention_bwd"],
                             "train_lm_dp_per_step_per_rank":
                                 lm_dp_counts["flash_attention_bwd"] /
                                 lm_dp["per_rank"][0]["steps_counted"],
                             "train_lm_dp_numerics": lm_dp_num[
                                 "kernel_launches"]["flash_attention_bwd"],
                             **{k: v["flash_attention_bwd"]
                                for k, v in sp_counts.items()},
                             **{k: v["flash_attention_bwd"]
                                for k, v in sp_num_counts.items()},
                             **{k: v["flash_attention_bwd"]
                                for k, v in memory_counts.items()},
                             "input": inp_counts["flash_attention_bwd"],
                             "tp": tp_counts["flash_attention_bwd"],
                             "dist": dist_counts["flash_attention_bwd"],
                             **{k: v["flash_attention_bwd"]
                                for k, v in sparse_counts.items()},
                             **{k: v["flash_attention_bwd"]
                                for k, v in obs_counts.items()},
                             **{k: v["flash_attention_bwd"]
                                for k, v in rnn_counts.items()},
                             **{k: v["flash_attention_bwd"]
                                for k, v in det_counts.items()}},
        "max_abs_err": max(r["max_err"] for r in bwd_rows),
        "ms": bwd_row["kernel_ms"], "plain_ms": bwd_row["plain_ms"],
        "bound_ms": bwd_row["bound_ms"], "bound_by": bwd_row["bound_by"],
        "library_ms": bwd_row["library_ms"],
        "graph_ms": bwd_row["graph_ms"],
        "device_ms": bwd_row["device_ms"],
        "library_graph_ms": bwd_row["library_graph_ms"],
        "library_kernels": [n for n, _ in bwd_row["library_kernels"]],
        "shape": bwd_row["shape"], "dtype": bwd_row["dtype"],
    }, {
        "name": "rtc_add", "route": "cuda", "kernel_route": "nvrtc",
        "source": "mxnet_tpu_torch/csrc/rtc/add.cu",
        "replaces": "tests/test_parity_tail.py:148",
        "launches": ndrow["rtc_launches"].get("add", 0),
        "launches_by_path": {"ndarray": ndrow["rtc_launches"].get("add", 0),
                             "fit": fit["kernel_launches"]["rtc_add"],
                             "dp": dp_counts["rtc_add"],
                             "train_lm_dp": lm_dp_counts["rtc_add"],
                             **{k: v["rtc_add"]
                                for k, v in memory_counts.items()},
                             "input": inp_counts["rtc_add"],
                             "tp": tp_counts["rtc_add"],
                             "dist": dist_counts["rtc_add"],
                             **{k: v["rtc_add"]
                                for k, v in sparse_counts.items()},
                             **{k: v["rtc_add"]
                                for k, v in obs_counts.items()},
                             **{k: v["rtc_add"]
                                for k, v in rnn_counts.items()},
                             **{k: v["rtc_add"]
                                for k, v in det_counts.items()}},
        "max_abs_err": max(r["max_err"] for r in add_rows),
        "ms": add_row["kernel_ms"], "plain_ms": add_row["plain_ms"],
        "bound_ms": add_row["bound_ms"], "bound_by": add_row["bound_by"],
        "library_ms": add_row["library_ms"],
        "single_call_ms": add_row["single_call_ms"],
        "shape": add_row["shape"], "dtype": add_row["dtype"],
    }, {
        "name": "box_nms", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/box_nms.cu",
        # not a Pallas kernel: the fori_loop of greedy NMS the JAX
        # package keeps on the chip (MultiBoxDetection, the RPN)
        "replaces": "mxnet_tpu/ops/contrib.py:41",
        "launches": ssd["kernel_launches"]["box_nms"],
        "launches_by_path": {"train_lm": lm["kernel_launches"]["box_nms"],
                             "fit": fit["kernel_launches"]["box_nms"],
                             "dp": dp_counts["box_nms"],
                             "train_lm_dp": lm_dp_counts["box_nms"],
                             "train_lm_dp_numerics": lm_dp_num[
                                 "kernel_launches"]["box_nms"],
                             # (train_lm_sp's per-step counts hold the
                             # flash kernels only)
                             **{k: v["box_nms"]
                                for k, v in sp_num_counts.items()},
                             **{k: v["box_nms"]
                                for k, v in memory_counts.items()},
                             "input": inp_counts["box_nms"],
                             "tp": tp_counts["box_nms"],
                             "dist": dist_counts["box_nms"],
                             **{k: v["box_nms"]
                                for k, v in sparse_counts.items()},
                             **{k: v["box_nms"]
                                for k, v in obs_counts.items()},
                             **{k: v["box_nms"]
                                for k, v in rnn_counts.items()},
                             **{k: v["box_nms"]
                                for k, v in det_counts.items()}},
        # keep-mask mismatches against the plain loop, every shape
        "max_abs_err": float(max(nms_row["mismatches"],
                                 ssd_num["box_nms_full"]["kernel"][
                                     "mismatches"],
                                 ssd_num["box_nms_rpn"]["mismatches"])),
        "ms": nms_row["ms"], "plain_ms": nms_row["plain_ms"],
        "bound_ms": nms_row["bound_ms"], "bound_by": nms_row["bound_by"],
        "library_ms": nms_row["library_ms"],
        "graph_ms": nms_row["graph_ms"],
        "shape": nms_row["shape"], "dtype": nms_row["dtype"],
        "calls_by_route": ssd["a_ssd512"]["nms_kernel_routes"],
        "full_size": {k: ssd_num["box_nms_full"]["kernel"][k]
                      for k in NMS_ROW_KEYS},
        "rpn": {k: ssd_num["box_nms_rpn"][k] for k in NMS_ROW_KEYS},
    }]
    wall = time.perf_counter() - t_start
    emit({"phase": "wall", "wall_s": wall,
          "observability_s": obs_s, "tuning_s": tuning["wall_s"]})
    rnn_s = PHASE_S["rnn"] + PHASE_S["rnn_numerics"]
    ssd_s = PHASE_S["ssd"] + PHASE_S["ssd_numerics"]
    emit({"phase": "phase_seconds", "seconds": PHASE_S, "wall_s": wall,
          "rnn_phases_s": rnn_s, "rnn_phases_within_90_s": rnn_s <= 90.0,
          "ssd_phases_s": ssd_s, "ssd_phases_within_60_s": ssd_s <= 60.0,
          "wall_within_850_s": wall <= 850.0})
    emit({"phase": "kernels",
          "kernels": {k["name"]: "checked" for k in kernels}})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--ps-worker":
        ps_worker_main(sys.argv[2], sys.argv[3])
        sys.exit(0)
    if len(sys.argv) == 3 and sys.argv[1] == "--ckpt-child":
        ckpt_child_main(sys.argv[2])
        sys.exit(0)
    sys.exit(main())
