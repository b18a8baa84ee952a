"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit code):

1. device  — print the card's name and power limit (nvidia-smi) and
   require CUDA;
2. build   — compile every CUDA source of the port with nvcc, all at
   once, into incubator_mxnet_tpu_torch/_build/, and print ptxas's
   registers and spills per kernel and, for the bf16 flash backward
   and forward kernels and the paged kernel, registers at launch, spill
   bytes, shared memory and resident blocks an SM;
3. kernels — hold each kernel against its plain PyTorch version on the
   card (f32 atol 2e-5, bf16 atol 2e-2), plus the paged kernel's
   masked-slot and lane bit-exactness (for the int8-page kernel on
   `quantize_kv` pools: masked slots filled with random int8 values and
   NaN / 1e30 scales give the bits of zeros there, one lane's pages
   changed leave every other lane's bits, two launches agree), also at
   shapes of the kernel's split of a lane's pages over 8 warps (a lane
   at pos 2047 with bs 16, lanes at pos -1 -- exactly 0 -- 0, bs - 1
   and bs, fewer pages than warps, bs 1 and 64), and the flash
   kernel's logsumexp (within 1e-4) and fully-masked rows, two launches
   bit-identical, a zeroed output and an lse shifted by 1e-3 shown to
   fail those bounds; then the flash backward kernels
   (dK/dV, dQ) against ``flash_bwd_plain`` over the same shapes, f32
   and bf16, directly and through the ``(out, lse)`` autograd Function
   with both cotangents: each gradient within rtol·|ref| +
   atol·max|ref| (f32 1e-4/1e-5, bf16 1e-2/2e-3), a bound that a
   zeroed output, a dS without its Δ term and a P taken with lse + 1
   are shown to fail on the same inputs; two launches bit-identical,
   rows that see no key with dq exactly 0;
4. main path — a 12-layer, 1024-wide, 16-head, V=32000 TransformerLM in
   bf16 with random weights from a seed: ``net.generate`` (B=8, P=128,
   N=32), then a paged ServingEngine over 8 requests of 32-300 prompt
   tokens with one prompt submitted again as a prefix-cache hit, and a
   solo run on a fresh engine; every kernel's launch count must grow
   during this phase;
5. parity  — the same width in f32 at 2 layers: engine tokens equal
   ``net.generate`` tokens, or first differ where the top-2 logit gap is
   below 1e-3;
6. timing  — the paged kernel and the flash forward at the inputs the
   main path gave them (recorded during phase 4), held to their plain
   versions there, and timed beside the plain version, the one-call
   PyTorch yardstick where there is one, and the bound (bytes over
   3.35 TB/s, operations over 989 TFLOP/s for bf16).

7. training kernels — the dropout keep-mask kernel bit-identical to its
   plain Philox version at (4096, 1024) bf16/f32, rates 0.1 and 0.5, and
   at odd sizes, with the keep fraction within 4 sigma of 1 - rate; the
   fused dropout forward (mask and ``[res +] where(keep, x * scale, 0)``)
   and backward (``where(mask, dy, 0) * scale``) bit-identical to the
   plain composition and its autograd gradients, with and without a
   residual, directly and through ``fused_dropout(_add)``'s autograd
   Function, f32 and bf16, at (4096, 1024) rates 0.1 and 0.5, at the odd
   sizes, on views one element into larger buffers (the kernel's scalar
   path) and with NaN / +-Inf in x and -0.0 in the residual on dropped
   elements (y there exactly +0.0); the device-seed entries
   (``mx_dropout_fwd_dev``, ``mx_dropout_mask_dev``: the seed read from
   an int64 in device memory) bit-identical to the by-value entries and
   to the plain version given the seed tensor, on the same cases;
   degenerate rates launch nothing; the
   cross-entropy forward (lse, row sum) and backward (dlogits) kernels
   against their plain versions at (4096, 30522) bf16, at small and odd
   vocabularies and at logits of +-1e4, eps 0 and 0.1 (lse within 1e-4
   relative, the row sum within 1e-6 of the row's sum of magnitudes,
   each dlogit within rtol·|ref| + atol·max|ref|, f32 1e-5/1e-6 and
   bf16 1e-2/1e-5, a bound that a zeroed or softmax-less dlogits is
   shown to fail on the same inputs);
8. training main path — BERTForPretraining at BERT-large width (V=30522,
   D=1024, Dff=4096, L=24, H=16) in bf16 over f32 master weights,
   initialized from seed 0, dropout 0.1, the MLM+NSP loss of bench.py's
   PretrainWithLoss, SGD momentum 0.9 through the Trainer
   (keep_grads=False), B=32 T=128 on a fixed batch from seed 0: 2
   warm-up and 5 timed steps, on CUDA graphs (the hybridized block's
   recorded forward and backward programs and the Trainer's update
   program: one capture each, then replays; the recorded forward's
   capturing call frees its warm-up's graph and replays the capture for
   its result, so step 1 launches the forward's kernels twice and peaks
   with one copy of the activations, below the 18.27 GiB of two; the
   update's capturing call timed, and its host snapshot beside one on
   the card); the loss
   is finite every step, every trainable parameter the forward reaches
   changes in step 1, and each step launches the device-seed fused
   dropout forward and
   the fused backward 49 times each (the by-value forward and the
   mask-only kernels never) and each cross-entropy
   kernel once while no flash kernel is launched, launches inside
   replays counted; step time, tokens/s, MFU
   (bench.py's FLOP count over 989 TFLOP/s bf16 on an H100 SXM), peak
   memory and the card's busy share, kernel count and the dropout
   kernels' device time over one profiled step;
9. training parity — the same width at 2 layers in f32, dropout 0.1, one
   step from one seed, once through the kernels and once with every
   kernel call swapped for its plain version: the same loss (rtol 1e-5),
   grads and updated weights (atol 1e-4 of each tensor's max);
10. training timing — each training kernel at the inputs the main path
   gave it, beside its plain version, its one-call PyTorch yardstick
   and its bound: bytes, or for the dropout mask the larger of its bytes
   and its integer multiplies (38 per 4 elements at 64 a clock an SM at
   nvidia-smi's clocks.max.sm); the fused dropout entries also beside
   the old site (the mask kernel, then the torch apply and add, and
   autograd's backward of them), with ``F.dropout(x, p) + res`` and
   ``native_dropout_backward`` as the yardsticks; and one one-element
   launch, the floor of every time here;
11. T=512 main path — phase 8 at BERT's phase-2 sequence length, B=8
   T=512 (the same 4,096 tokens a step): attention takes the flash
   kernels, and each step launches the flash forward, the dK/dV and
   the dQ kernel 24 times each, the fused dropout forward and backward
   49 times each and each
   cross-entropy kernel once; the profiled step prints the flash
   forward's and backward's shares of the card time;
12. T=512 parity — phase 9 at B=2, T=512, where the plain versions also
   stand in for the flash forward and backward;
13. T=512 timing — the flash forward, dK/dV and dQ kernels at the
   inputs the T=512 main path gave them (the last layer, step 1), held
   to the plain versions there, beside them, SDPA's forward or backward (timed
   alone, never a route of the port) and the bound (for the backward,
   8 (dK/dV) or 6 (dQ) x B·H·D flops per live (query, key) pair over
   989 TFLOP/s, against the bytes read and written over 3.35 TB/s);
   then the forward and both backward kernels at the long-context
   causal shape (1, 16, 2048, 64) bf16, held to the plain versions and
   timed beside SDPA ``is_causal=True``'s forward or backward and the
   causal bound (live pairs only); then the causal caller through the
   model: a trainable 2-layer
   TransformerLM at generate_bench width (units 1024, 16 heads) in bf16,
   one (1, 2048) sequence, ``loss.backward()`` through the kernels (2
   launches of each flash kernel), each layer's backward call held to
   the plain version at its inputs and every parameter gradient to the
   same step with the plain backward (5e-2 of each tensor's max).
14. quantized main path (runs right after phase 5) — phase 4's net with
   ``quantize_for_decode`` (int8 weights, the scale in the epilogue):
   the int8 matmuls checked on the card, ``generate`` (B=8, P=128,
   N=32), a ServingEngine with ``kv_dtype="int8"`` over phase 4's
   requests with one prefix-cache hit, and a profiled solo request;
   the int8-page kernel must launch exactly 12 x (steps + chunks) and
   the float paged kernel never; prints tok/s, TTFT and TPOT p50, the
   KV bytes per token and pool bytes beside the bf16 engine's, the
   decode weight bytes and the card's busy share;
15. quantized timing — the int8-page kernel at the kv8 engine's busiest
   recorded step and chunk, held to its plain version, timed beside it,
   the bound (int8 pages plus 4 B of scale a slot) and the float kernel
   on the same pages dequantized to bf16;
16. quantized parity — 2 layers, f32: the kv8 engine through the kernel
   against the same engine on the plain versions (tokens equal, or
   first different where the top-2 gap is below 1e-3), and greedy
   parity >= 95% of the kv8 against the float engine and of int8-weight
   against float ``generate``.
17. speculative path (runs right after phase 14) — phase 4's net with
   ``quantize_for_decode`` as its own int8 draft (``speculate_k=4``,
   float target weights): phase 4's traffic with its prefix-cache hit
   and a profiled solo request, the same over int8 KV pages, and a
   sampled run (temperature 1.0, top_k 50, at least one rejection);
   each in its own launch-count window, where the paged kernel must
   launch 12 x (4 x iterations + iterations + 2 x chunks) (over int8
   pages the verify and target chunks on the int8-page kernel) and
   flash never; greedy tokens held to the non-speculative engine's by
   the gap rule (f32: top-2 gap below 1e-3; bf16: below 4 bf16 ULPs of
   the top logit); one recorded verify launch of B·(k+1) rows bit-equal
   to k+1 launches of B rows; whether cuBLAS gives the decode products
   the same bits at 8 rows alone and inside 40; prints decoded tok/s
   beside the float engine's, the accept rate, tokens a lane a verify,
   TTFT and TPOT p50, rollback reasons, busy share and kernels a
   scheduler iteration;
18. beam search — ``beam_search`` on phase 4's net, B=2, P=128, N=32:
   beam_size=1 held to ``generate`` by the gap rule; beam_size=4 sorted,
   its best score within 2^-7 of the summed magnitudes of ``lm_score``
   over its tokens, one flash launch a layer a call;
19. speculative parity (runs after phase 16) — 2 layers, f32: the
   self-drafted speculative engine through the kernels against the
   same engine on the plain versions and against the non-speculative
   engine, by the gap rule.

Phases 4, 14, 17 and 18 run the serving programs' eager bodies
(`_graphs.eager()`: their launch counts and recorded kernel inputs are
per call); phases 5, 16 and 19 run on CUDA graphs, the port's default.
The compiled programs as CUDA graphs (run right after phase 18, on
phase 4's net):

20. graphed main path — the float, kv8 (int8 weights and pages) and
   self-drafted k=4 engines over phase 4's burst, and for the float one
   ``generate`` (B=8, P=128, N=32) and a profiled solo request, each
   first on the eager bodies and then on graphs: tokens equal lane for
   lane, exactly one capture per program per engine under
   ``RetraceGuard(budget=1)``, and each engine's serving-kernel
   launches counted from 0 as direct launches plus replays x launches a
   replay (the kernel must run inside replays); prints graphed against
   eager decoded tok/s, TTFT and TPOT p50, ``generate`` tok/s, the
   speculative engine against the float one, and the solo request's
   wall, scheduler iterations, wall a iteration, card busy share and
   kernels a iteration;
21. graphed programs — at full width every serving program (step and
   prefill chunk over float and int8 pages, greedy and sampled; draft
   step, draft chunk and verify over float and int8 pages, greedy and
   sampled) on random pool contents: its capture call and a replay
   give its eager body's logits (or hidden states), tokens and pool
   writes bit for bit; then a graphed float step's host time split
   (fingerprint and gather, slots, staging, launch, sync) and one
   replay's card time;
22. ``generate`` (greedy, sampled, eos, ``pad_to_bucket=True``) and
   ``beam_search`` on graphs equal to their eager bodies at capture and
   replay (beam scores bit for bit); the bucketed tokens' agreement
   with the unpadded call is printed, and the prefill op by op (layer
   0's ops, then each layer's output) for the padded and the unpadded
   prompt, with the first op whose real rows differ;
23. weight writes — ``set_data``, an in-place write through
   ``param.data``, a ``cast`` round trip, ``quantize_for_decode`` (and an
   in-place write re-quantized by a second call), ``dequantize_decode``:
   the next graphed ``generate`` equals the eager one on the new weights
   (captures per call printed); an engine after a ``set_data`` equals
   its eager bodies;
24. hybridize — a hybridized 2-layer TransformerLM (width 1024, bf16) at
   (2, 512) replays bit-identical to its eager forward with the flash
   kernel inside the replay; in train mode two replays draw two dropout
   masks from the staged seed table, and re-seeding the first again;
   and a captured program's owner dropped inside another
   program's capture while the collector runs: the capture holds (a
   graph freed during a capture invalidates it).

The captured training step (after phase 13):

25. captured training — phase 8's model and batch at B=32 T=128 and at
   B=8 T=512, ``random.seed(7)``: three steps on CUDA graphs, three on
   the programs' eager bodies (`_graphs.eager()`) and three with the
   block never hybridized (dropout seeds by value) give the same losses,
   f32 masters and momenta bit for bit; one capture of each program
   (``fwd_record``, ``bwd_record``, ``update``) and two replays; each
   step's launches as phase 8's; then the graphed and the eager step
   timed in the same run (mean of 5 after 3), tokens/s, MFU, peak
   memory, and one profiled step's wall, card time, busy share and
   kernel count each.  Then two patterns beside bench.py's on a
   2-layer block of width 1024: an input that requires a gradient
   (three steps, a fresh input each, on one capture of each program:
   the input's gradient and the weights equal the never-hybridized
   block's bit for bit), and a bf16 model without f32 masters (the
   captured update's staged f32 scalars equal to ``fuse_step=False``
   bit for bit over three steps; whether torch's own foreach product
   with a Python float on the card agrees with the rule's f32 product
   is printed); and two recorded calls of a hybridized block before
   one backward of their sum: a second set of programs captured, the
   gradients of the block never hybridized bit for bit.

The NMT family (after phase 13's long-context checks):

26. NMT training — `transformer_big` (V=32000 shared, D=1024, FFN 4096,
   H=16, 6+6 layers, dropout 0.1: 44 dropout sites a step) in bf16 over
   f32 masters from seed 0, `NMTWithLoss` (label smoothing 0.1), Adam
   (0.9, 0.98) under ``InvSqrtScheduler(4000)`` at d^-0.5, B=16 S=T=256,
   half the rows' sources padded (``src_valid_length``) and their
   targets ignored past it: three steps on CUDA graphs and three never
   hybridized from ``random.seed(7)`` give the same losses, f32 masters
   and Adam moments bit for bit; one capture of each program, then
   replays; each step launches the device-seed dropout forward (by value
   never hybridized) and the backward 44 times, the causal flash
   forward, dK/dV and dQ 6 times and the smoothed cross-entropy forward
   (with the row sum) and backward (eps 0.1) once; step time, target
   tokens/s, MFU (train_transformer.py's 6·(N - N_embed) + 12·T·D·3L a
   target token over 989 TFLOP/s), peak memory, one profiled step's
   busy share and kernel time by name; then the flash kernels at the
   decoder's causal (16, 16, 256, 64) and the smoothed cross-entropy at
   (4096, 32000) bf16, at the step's inputs, held to their plain
   versions and timed beside SDPA ``is_causal`` and
   ``F.cross_entropy(label_smoothing=0.1)`` (forward and autograd
   backward) and the bound.  The residual stream is f32, as in the JAX
   package (the f32 positional table): 30 of the 44 sites a step add a
   bf16 sublayer output to an f32 residual, and the fused forward at
   the first such input the step gave it, and at (4096, 1024) (also one
   element into its buffers), gives the plain version's y (f32), dx
   (bf16) and dres bits;
27. NMT parity — 2+2 layers at that width in f32, dropout 0, B=4
   S=T=256: the hybridized step through the kernels against the same
   step on the plain versions (loss within 1e-5 relative, every gradient
   within 1e-4·|ref| + 1e-5·max|ref|), and greedy ``translate`` on the
   programs equal to their eager bodies;
28. NMT translation — phase 26's trained net in bf16: greedy (B=8,
   S=128, max_len 128, no eos), beam (K=4 at B=2, alpha 0.6) and greedy
   on the int8 decoder (`quantize_for_decode`), each a capturing call, a
   second call of the same signature (replays, no capture) and the
   eager bodies, tokens (and beam scores) equal; tok/s, captures and
   replays of ``nmt_start`` and ``nmt_step``, the decode weight bytes
   float and int8.

ResNet-50 v1 (after phase 28):

29. ResNet parity — the small v1 bottleneck net
   ``ResNetV1(BottleneckV1, [1, 1, 1, 1], [8, 16, 32, 64, 128],
   classes=600)`` in f32 with TF32 off, B=2 at 64x64, three hybridized
   SGD steps (lr 0.005, momentum 0.9, wd 1e-4) on the card (the loss
   through the streamed cross-entropy kernels) against the port's CPU
   path from the same seed: logits and losses within 1e-5, every
   gradient of step 1 and every weight and running stat after step 3
   within 1e-4·|ref| + 1e-4·(the layer's max|ref|);
30. ResNet-50 v1 training — ``vision.get_model("resnet50_v1",
   classes=1000)``, ``initialize()``, ``cast("bfloat16")``, B=128
   224x224 normalized images and labels from a seed, ``loss_fn(net(x),
   y)`` under ``record()``, ``backward()``, SGD (lr 0.05, momentum 0.9,
   wd 1e-4, f32 masters, ``keep_grads=False``) ``step(128)``: on CUDA
   graphs (F, B, U: one capture each, then replays) and never
   hybridized, under deterministic cuDNN without autotuning, three
   steps bit-identical (losses, f32 masters, momenta, the running stats
   after every step, moved in step 1); each step launches each
   cross-entropy kernel once at (128, 1000) bf16; step time, img/s,
   MFU (3 x 2 x the multiply-adds of every convolution and Dense, from
   the model's shapes, over 989 TFLOP/s), card busy share, one
   profiled step's card time by kind of kernel, peak memory, for both
   paths and for the graphed step under cuDNN autotuning; then the
   cross-entropy kernels at the step's inputs, held to their plain
   versions and timed beside ``F.cross_entropy`` and the bound;
31. ResNet-50 inference — phase 30's net in predict mode, hybridized, at
   B = 1, 32 and 256: one capture a signature, a second call replays
   only, replay logits bit-identical to the eager body's, the running
   stats untouched; img/s graphed against the eager bodies.

int8 post-training quantization (after phase 31):

32. int8 convolution kernels — the quantize pass
   (``csrc/int8_quantize.cu``: x to a channels-last int8 buffer) and the
   s8 ``wgmma`` implicit GEMM (``csrc/int8_conv.cu``, split-K where the
   tiles are few) at each distinct convolution of ResNet-50 v1 at B =
   256 and B = 1, the Dense 2048 -> 1000 at both, and small grouped,
   dilated, strided 1-D and 3-D cases and the stem at C=3, bf16 (and
   f32) activations, over weights packed once: bit-identical to the
   plain version (quantize by true division, an f64 convolution of the
   integers, the same two-rounding epilogue), the quantize pass alone
   bit-identical to its plain version; ms of the call, of the quantize
   pass and of the GEMM, the split-K ways, against the bound (the
   larger of the bytes, x and the output in bf16 and the int8 weights,
   over 3.35 TB/s and 2 x the multiply-adds over the int8 dense peak of
   1,979 TOPS, with which of the two applies) and, as context, the time
   of the bf16 cuDNN ``F.conv2d`` (``F.linear``) of the same layer, a
   different function: torch has no int8 convolution on CUDA;
33. benchmark_score.py's int8 flow — ResNet-50 v1 from seed 0 at full
   width, ``cast("bfloat16")``, ``quantize_net`` calibrated (minmax) on
   two seeded batches of 8 normal bf16 images: 54 layers wrapped (53
   convolutions, the Dense); ``entropy`` on a second net, timed on the
   host; then hybridized, predict mode, at B = 1, 32 and 256: one
   capture a signature, a replay bit-identical to the eager body and to
   the eager body on the plain versions (`plain_kernels`), 54 quantize
   launches and 53 + 1 GEMM launches a forward inside the replay, img/s
   graphed against the eager bodies and beside phase 31's bf16 net, and
   the int8 logits' largest difference from the float net's relative to
   its largest |logit| (reported; random weights make top-1 agreement
   meaningless);
34. .params on the card — phase 30's trained net saved with
   ``save_parameters``, loaded into a fresh net (another seed) with
   ``load_parameters``: the logits bit-identical (deterministic cuDNN);
   phase 33's quantized net's file holds the float parameters, each
   wrapped layer's under ``<layer>.src.<name>``, bit-identical to the
   float net's.

Training state (after phase 34):

35. training state — BERT-large as phase 8 (24 x 1024, B=32, T=128,
   bf16 over f32 masters, dropout 0.1, keep_grads=False) under LAMB
   (lr 1e-3, wd 0.01, ``wd_mult`` 0 on every bias and LayerNorm
   parameter) on CUDA graphs.  Run A: ``random.seed(7)``, six steps,
   with an async ``CheckpointManager.save`` after step 3 that the loop
   does not wait for.  Run B: a fresh net, Trainer and set of programs
   from another seed, the random stream moved elsewhere, ``restore`` of
   step 3, three steps.  B's losses, f32 masters, m and v after steps
   4-6 are bit-identical to A's; each program (recorded forward and
   backward, the update) is captured once in each run, and each step
   launches the dropout and cross-entropy kernels as `_per_step` says.
   Printed: the checkpoint's bytes, the caller's stall in ``save``
   against a synchronous save of the same state (step 6's) in the same
   run, which it must stay under 10% of (the JAX package's gate), the
   async write's and the restore's seconds, and the step times;
36. the rules graphed — every ported update rule (`RULES`) with f32
   masters, wd 0.01 and phase 35's ``wd_mult`` groups, as the
   Trainer's captured update over BERT-large's parameter list with
   seeded bf16 gradients: two steps on a CUDA graph (the capture's
   warm-up, one replay) bit-identical, weights and every state tensor,
   to two runs of its eager body.

Long context (after phase 36; benchmark/longctx_bench.py):

37. long-context training — TransformerLM V=32000, D=1024, FFN 4096,
   L=12, H=16, dropout 0.1, bf16 over f32 masters from seed 0, its
   ``LMWithLoss`` hybridized under ``record()``, SGD momentum 0.9
   (keep_grads=False), at T=2048 B=8, T=8192 B=2 and T=32768 B=1, and
   at T=65536 B=1 with ``hybridize(remat_backward=True)`` (max_len T:
   above 8192 no positional table, the encoding computed in the
   program): 2 warm-up and 3 timed steps each, finite and
   falling-or-flat losses, one capture of each program then replays,
   each step's launches as `_lm_per_step` says (with remat the backward
   program runs the forward kernels again); step ms, tokens/s, MFU by
   longctx_bench.py's count (6·(N − V·D) + 12·L·T·D a token: attention's
   full T², not its causal half) over 989 TFLOP/s, peak memory, and one
   profiled step's busy share and card time by kind (flash, dropout,
   xent, GEMM, ``multi_tensor_apply``);
38. remat parity — T=8192 B=2 and T=65536 B=1, dropout 0.1, three
   steps with and without remat from one seed: the same losses, f32
   masters and momenta bit for bit; both peaks above what was allocated
   before the run, and step times (a run out of memory is reported);
39. long-T kernels — the cross-entropy kernels at phase 37's (B·T,
   32000) bf16, B·T = 16384, 32768, 65536, as phase 10 holds and times
   them; the flash forward, dK/dV and dQ kernels at (1, 16,
   T, 64) bf16 causal, T = 8192, 32768, 65536, against the chunked
   plain version (`attention_chunked`, `flash_bwd_chunked`: no (T, T)
   tensor): out element by element within `FWD_ROW_TOL` of its row's
   scale (an out with its later half of rows zeroed or halved, or its
   last eighth scaled by 0.9, shown to fail), lse within 1e-4,
   gradients by `BWD_TOL` (a zeroed output and the wrong terms shown
   to fail); timed with CUDA events beside the plain version, SDPA
   ``is_causal`` (forward; its backward alone) and the causal bound;
40. ``lm_score`` at (1, 32768) on phase 37's T=65536 net — one captured
   program, its replay and the first call bit-identical to the eager
   body; call ms, tokens/s and the perplexity;
41. telemetry — with telemetry enabled (and the flight recorder, its
   signal handlers left alone): phase 25's BERT-large step, three steps
   (``trainer_step_seconds`` p50, the programs' CUDA-event card ms, the
   ``trainer_step`` record's MFU beside phase 25's own), then one
   ``CheckpointManager.save`` and its six metrics; phase 20's graphed
   float engine over phase 4's 8 prompts with telemetry off, on, on, off
   (decoded tok/s both ways, the tokens equal), the first engine with
   telemetry on serving its ops endpoints on an ephemeral port, scraped
   over HTTP: ``serving_admitted_total`` 8, a TPOT count, ``/healthz``
   healthy, a valid ``/profilez`` trace, every program's MFU <= 1 and
   roofline fraction <= 1.05, the decode program's card ms within 15% of
   its graph replayed on an idle stream (phase 20's back-to-back replay
   printed beside), a request profiled on every thread showing the
   engine's spans as ``record_function`` ranges; ``generate`` B=8 P=128
   N=32 (its ``decode_float`` record); a flight-recorder bundle with the
   engine's section and the steps' spans;
42. fed training — train.py's loop on ResNet-50 v1 (bf16, f32 masters,
   B=128, 224x224, SGD momentum 0.9, wd 1e-4) fed from a .rec of 1,280
   JPEG class templates plus noise (1,000 classes, quality 90, packed
   under a temporary directory as train.py's `make_synthetic_rec`
   does): `ImageRecordIter(shuffle, rand_mirror, mean/std,
   device_normalize=True, preprocess_threads=4)` behind
   `PrefetchingIter(prefetch_to_device=True)`, `wrap_net(body,
   "bfloat16")`, hybridized, `Accuracy` and `Speedometer`, 70 steps over
   seven epochs with ``reset()`` between, under deterministic cuDNN.
   The decoder that ran is printed: libjpeg where the host builds it,
   else nvJPEG, whose pixels are held to PIL's (on 4:4:4 copies of the
   images and on the 4:2:0 records; only the IDCT's rounding differs,
   see below); a record that
   does not decode is counted (with nvJPEG its batch raises
   ``IOError``), and the fed run counts none.  The uint8 batch
   on the card equals the pipeline's host batch byte for byte for 6
   steps; the first 3 steps' batches, fed as card tensors to a net
   built afresh with no prefetcher, give bit-identical losses, f32
   masters, momenta and running stats; one capture each of
   ``fwd_record``, ``bwd_record`` and ``update``, one launch each of the
   cross-entropy kernels a step; the launches reported are the fed
   path's (its 70 steps, the step after ``reset()`` and the profiled
   step).  Printed: img/s over epochs 1-4 (40 steps, telemetry off) and
   each epoch's, the step ms, the share of their wall the loop waited
   for input, beside phase 30's synthetic-batch graphed step;
   ``data_wait_seconds`` over epoch 5 (telemetry on, untimed); the
   card's busy share over epoch 6 (the profiler on the card's kernels
   only) and in one profiled step; `Accuracy` at each epoch's end; the
   pipeline alone at 1, 2, 4, 8 threads and ``nproc``, and at 4 threads
   split by stage (``ImRecIterNext``, the host float32 → uint8 cast,
   pinning and the copy); a pinned `DataLoader` batch, a prefetched one
   on the card, and `PrefetchingIter(ImageRecordIter)` read on a side
   stream.  nvJPEG decodes to planar YCbCr and the host finishes the
   pixels with libjpeg's upsampling and conversion (`native/ycc_rgb.h`),
   so against PIL what is left is the IDCT's rounding, on the 4:2:0
   records as on 4:4:4 (`DECODE_TOL_420`);
43. chained steps — bench.py's flagship loop (`bench.py:130-200`) at
   BERT-large width, B=32, T=128, bf16 over f32 masters, momentum SGD,
   dropout 0.1, ``keep_grads=False``, 24 steps from one seed:
   ``chain_steps=4`` (the first call runs F, B and U and learns the
   output shapes; then four steps a captured program, a tail of three
   through the single-step program), the same Trainer flushed after
   every step (24 single one-program steps after the first) and
   ``chain_steps=1`` (phase 25's three programs), bit for bit: the 24
   losses, the bf16 weights, the f32 masters and the momenta.  Each
   full flush launches ``mx_dropout_fwd_dev`` and ``mx_dropout_bwd`` 4 x
   49 times and each cross-entropy kernel 4 times; those kernels are
   held to their plain versions at the chained path's inputs.  Printed:
   ms a step (12 steps between two CUDA events on the stream), host ms
   a step and peak memory of each loop.  Then train.py's loop
   (`examples/image_classification/train.py:120-150`) on ResNet-50 v1
   (bf16, B=128, synthetic batches, deterministic cuDNN) with the
   separate `SoftmaxCrossEntropyLoss` block spliced into the step and
   `Accuracy` updated at flush boundaries: ``chain_steps=4`` against
   ``chain_steps=1`` over 10 steps, bit for bit (losses, outputs, f32
   masters, momenta, running stats, accuracy).
44. word-level LSTM LM — the loop of `examples/gluon/word_language_model.py`
   on `models.WordLM` at the upstream examples' 650-wide configuration
   (2 layers, tied, dropout 0.5; V=33,278, WikiText-2's vocabulary;
   bptt 35, batch 20) in f32, hybridized (the model and the loss block
   as CUDA graphs), SGD momentum 0 at lr 1, ``clip_global_norm(grads,
   0.25 x 20)`` between ``backward()`` and ``step(1)`` (the norm kept on
   the card), the hidden state carried across windows and detached:
   30 windows, three passes over the example's synthetic Markov corpus
   cut to 10 windows (reset at each pass).  The first 4 windows are
   bit-identical to the same windows never hybridized from the same
   seed (losses, every weight, the states); each window after the
   first launches the device-seed dropout forward and the dropout
   backward 3 times each (the embedding's, the LSTM's inter-layer and
   the output's dropout) and each cross-entropy kernel once, counted
   inside replays; the mean loss of the last 10 windows is below the
   first window's and below ln 33,278.  The dropout kernels at the
   embedding site's (35, 20, 650) and the cross-entropy kernels at
   (700, 33,278) are held to their plain versions there and timed
   beside them, ``F.dropout`` / ``native_dropout_backward`` /
   ``F.cross_entropy`` and the bounds.  Printed: host ms a window,
   ms between CUDA events, tokens/s, the card's busy share over one
   profiled window, and the LSTM alone (forward and backward) on the
   port's graphs beside cuDNN's ``torch.nn.LSTM`` with the same weights
   (a yardstick the port never calls);
45. DCGAN — the loop of `examples/gluon/dc_gan.py` on `models.dcgan_nets`
   at the upstream example's widths (ngf = ndf = 64, latent 100, batch
   64, 32x32), weights ``Normal(0.02)``, two Trainers under Adam(2e-4,
   beta1 0.5) and `SigmoidBinaryCrossEntropyLoss`, images from the
   port's `SyntheticImageDataset` squashed to (-1, 1), under
   deterministic cuDNN: 20 iterations with both nets hybridized (G's
   inference program outside ``record()``, D recorded twice in one
   ``record()``); the first 3 bit-identical to the nets never
   hybridized (both losses, both nets' weights, every BatchNorm's
   running stats after each).  Printed: img/s, ms an iteration and the
   card's busy share over one profiled iteration.

The line before the last is a JSON object with every kernel's launches
(summed over the main paths that ran it, launches inside graph replays
included), error, time, plain-version
time, bound and library time (the flash kernels' at the T=512 inputs;
its time at the generate prefill is printed above; the paged kernels'
at their busiest decode step); the line
before it is the nvidia-smi name and power limit; the last line is
``{"ok": true, "device": {...}}``.  The script imports nothing of the
JAX package.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

from incubator_mxnet_tpu_torch import (MXNetError, _build, _graphs,
                                       autograd, nd, telemetry)
from incubator_mxnet_tpu_torch import callback as mx_callback
from incubator_mxnet_tpu_torch import engine
from incubator_mxnet_tpu_torch import io as mx_io
from incubator_mxnet_tpu_torch import metric as mx_metric
from incubator_mxnet_tpu_torch import native as mx_native
from incubator_mxnet_tpu_torch import recordio
from incubator_mxnet_tpu_torch.gluon import data as mx_data
from incubator_mxnet_tpu_torch import random as mx_random
from incubator_mxnet_tpu_torch.contrib.quantization import (
    _QuantizedWrapper, quantize_kv, quantize_net)
from incubator_mxnet_tpu_torch import initializer as mx_init
from incubator_mxnet_tpu_torch.gluon import HybridBlock, Trainer
from incubator_mxnet_tpu_torch.gluon import nn as gluon_nn
from incubator_mxnet_tpu_torch.gluon import rnn as gluon_rnn
from incubator_mxnet_tpu_torch.gluon import utils as gluon_utils
from incubator_mxnet_tpu_torch.gluon.trainer import _Update
from incubator_mxnet_tpu_torch.gluon.loss import (
    SigmoidBinaryCrossEntropyLoss, SoftmaxCrossEntropyLoss)
from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
from incubator_mxnet_tpu_torch.gluon.nn import Dense
from incubator_mxnet_tpu_torch.gluon.nn.conv_layers import _Conv
from incubator_mxnet_tpu_torch.optimizer import optimizer as opt_mod
from incubator_mxnet_tpu_torch.lr_scheduler import InvSqrtScheduler
from incubator_mxnet_tpu_torch.models import (BERTForPretraining,
                                              LabelSmoothedCELoss,
                                              Transformer, TransformerLM,
                                              WordLM, dcgan_nets)
from incubator_mxnet_tpu_torch.ndarray import rnn_impl as rnn_impl_mod
from incubator_mxnet_tpu_torch.models import generation as gen_mod
from incubator_mxnet_tpu_torch.ops import flash_attention as _fa_fn
from incubator_mxnet_tpu_torch.ops import paged_attention as _pa_fn
from incubator_mxnet_tpu_torch.ops.flash_attention import (
    _reference_attention_lse, flash_attention_with_lse, flash_bwd_dkdv,
    flash_bwd_dq, flash_bwd_plain)
from incubator_mxnet_tpu_torch.ops import dropout_kernel as dk_mod
from incubator_mxnet_tpu_torch.ops import xent_kernel as xk_mod
from incubator_mxnet_tpu_torch.ops.int8_conv import (
    int8_conv, int8_conv_reference, int8_dense, int8_quantize, pack_weight,
    quantize_channels_last_reference)
from incubator_mxnet_tpu_torch.ops.dropout_kernel import (
    dropout_bwd, dropout_bwd_reference, dropout_fwd, dropout_fwd_dev,
    dropout_fwd_reference, dropout_mask, dropout_mask_dev, mask_reference)
from incubator_mxnet_tpu_torch.ops.paged_attention import (
    paged_attention, paged_attention_dense, paged_attention_q8)
from incubator_mxnet_tpu_torch.ops.xent_kernel import (
    dlogits_reference, stats_reference, xent_backward, xent_forward)
from incubator_mxnet_tpu_torch.retrace_guard import (PROGRAM_NAMES,
                                                     RetraceGuard)
from incubator_mxnet_tpu_torch.serving import PagedPrograms, ServingEngine
from incubator_mxnet_tpu_torch.serving import programs as prog_mod
from incubator_mxnet_tpu_torch.utils.checkpoint import CheckpointManager

# the modules (ops.flash_attention and ops.paged_attention are the
# functions of those names)
fa_mod = importlib.import_module("incubator_mxnet_tpu_torch.ops."
                                 "flash_attention")
ic_mod = importlib.import_module("incubator_mxnet_tpu_torch.ops.int8_conv")
pa_mod = importlib.import_module("incubator_mxnet_tpu_torch.ops."
                                 "paged_attention")

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
PARITY_GAP = 1e-3                   # flash-vs-paged roundoff tie bound
HBM_BYTES_PER_S = 3.35e12           # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# 32-bit integer multiplies a clock an SM, compute capability 9.0 (the
# CUDA C++ programming guide's arithmetic-instruction throughput table)
INT_MULS_PER_CLOCK_SM = 64
# Philox4x32-10's multiplies for 4 mask bytes: 40, less the two of the
# first round, whose counter words are zero
PHILOX_MULS = 38
DEV = torch.device("cuda")
MODEL = dict(vocab=32000, units=1024, hidden_size=4096, num_layers=12,
             num_heads=16, max_len=512)
KERNELS = {
    "paged_attention": dict(
        fn=_pa_fn, source="incubator_mxnet_tpu_torch/csrc/paged_attention.cu",
        replaces="incubator_mxnet_tpu/ops/paged_attention.py:168"),
    "paged_attention_q8": dict(
        fn=paged_attention_q8,
        source="incubator_mxnet_tpu_torch/csrc/paged_attention.cu",
        replaces="incubator_mxnet_tpu/ops/paged_attention.py:201"),
    "flash_attention": dict(
        fn=_fa_fn, source="incubator_mxnet_tpu_torch/csrc/flash_attention.cu",
        replaces="incubator_mxnet_tpu/ops/flash_attention.py:211"),
    "flash_bwd_dkdv": dict(
        fn=flash_bwd_dkdv,
        source="incubator_mxnet_tpu_torch/csrc/flash_attention_bwd.cu",
        replaces="incubator_mxnet_tpu/ops/flash_attention.py:393"),
    "flash_bwd_dq": dict(
        fn=flash_bwd_dq,
        source="incubator_mxnet_tpu_torch/csrc/flash_attention_bwd.cu",
        replaces="incubator_mxnet_tpu/ops/flash_attention.py:417"),
    "dropout_mask": dict(
        fn=dropout_mask, source="incubator_mxnet_tpu_torch/csrc/dropout.cu",
        replaces="incubator_mxnet_tpu/ops/dropout_kernel.py:250"),
    # the mask kernel with the apply (and the residual add) fused in, and
    # the backward's apply of the saved mask: the port of the same TPU
    # kernel together with the XLA fusions around it
    "dropout_fwd": dict(
        fn=dropout_fwd, source="incubator_mxnet_tpu_torch/csrc/dropout.cu",
        replaces="incubator_mxnet_tpu/ops/dropout_kernel.py:250"),
    "dropout_bwd": dict(
        fn=dropout_bwd, source="incubator_mxnet_tpu_torch/csrc/dropout.cu",
        replaces="incubator_mxnet_tpu/ops/dropout_kernel.py:250"),
    # the mask and the fused forward with the seed read from device
    # memory: the entries a captured program's dropout launches
    "dropout_mask_dev": dict(
        fn=dropout_mask_dev,
        source="incubator_mxnet_tpu_torch/csrc/dropout.cu",
        replaces="incubator_mxnet_tpu/ops/dropout_kernel.py:250"),
    "dropout_fwd_dev": dict(
        fn=dropout_fwd_dev,
        source="incubator_mxnet_tpu_torch/csrc/dropout.cu",
        replaces="incubator_mxnet_tpu/ops/dropout_kernel.py:250"),
    "xent_forward": dict(
        fn=xent_forward, source="incubator_mxnet_tpu_torch/csrc/xent.cu",
        replaces="incubator_mxnet_tpu/ops/xent_kernel.py:157"),
    "xent_backward": dict(
        fn=xent_backward, source="incubator_mxnet_tpu_torch/csrc/xent.cu",
        replaces="incubator_mxnet_tpu/ops/xent_kernel.py:178"),
    # beyond the TPU set: the JAX package's int8 products are XLA's s8
    # convolution and dot, and torch has no int8 convolution on CUDA; the
    # quantize pass is the first line of both, which XLA fuses
    "int8_quantize": dict(
        fn=int8_quantize,
        source="incubator_mxnet_tpu_torch/csrc/int8_quantize.cu",
        replaces="incubator_mxnet_tpu/contrib/quantization.py:119"),
    "int8_conv": dict(
        fn=int8_conv, source="incubator_mxnet_tpu_torch/csrc/int8_conv.cu",
        replaces="incubator_mxnet_tpu/contrib/quantization.py:113"),
    "int8_dense": dict(
        fn=int8_dense, source="incubator_mxnet_tpu_torch/csrc/int8_conv.cu",
        replaces="incubator_mxnet_tpu/contrib/quantization.py:96"),
}
SERVING_KERNELS = ("paged_attention", "flash_attention", "paged_attention_q8")
# the kernels of the float serving path, and of the quantized one
# (int8 weights, int8 KV pages)
FLOAT_SERVING = ("paged_attention", "flash_attention")
QUANT_SERVING = ("paged_attention_q8", "flash_attention")
TRAINING_KERNELS = ("dropout_mask", "dropout_fwd", "dropout_bwd",
                    "dropout_mask_dev", "dropout_fwd_dev", "xent_forward",
                    "xent_backward")
FLASH_KERNELS = ("flash_attention", "flash_bwd_dkdv", "flash_bwd_dq")
INT8_KERNELS = ("int8_quantize", "int8_conv", "int8_dense")
# the flagship of bench.py: BERT-large, phase-1 shapes, dropout 0.1
BERT = dict(vocab_size=30522, units=1024, hidden_size=4096, num_layers=24,
            num_heads=16)
BERT_BATCH = (32, 128)
# phase-2 pretraining (BERT paper, A.2): T=512, the same 4,096 tokens a
# step; attention takes the flash kernels, forward and backward
BERT_BATCH_512 = (8, 512)
DROPOUT = 0.1
SGD = {"learning_rate": 1e-3, "momentum": 0.9, "multi_precision": True}
LSE_RTOL = 1e-4
SUM_RTOL = 1e-6                     # of the row's sum of magnitudes
# dlogits, elementwise: |dx - ref| <= rtol·|ref| + atol·max|ref|.  The
# rtol is about one rounding of the output dtype; the atol, relative to
# the largest dlogit, stays below the softmax term of the off-label
# entries, so an output without it fails
DX_TOL = {torch.float32: (1e-5, 1e-6), torch.bfloat16: (1e-2, 1e-5)}
# flash dq, dk, dv, elementwise: |g - ref| <= rtol·|ref| + atol·max|ref|.
# The rtol is about one rounding of the output dtype (f32: a few of
# its own; bf16: 2^-8 is 0.0039); the atol covers sums whose terms
# cancel.  Each check shows a zeroed output, a dS without its Δ term
# and a P taken with lse + 1 failing the same bound.
BWD_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (1e-2, 2e-3)}
# the bf16 flash forward's out at long causal T, elementwise:
# |out - ref| <= rtol·|ref| + atol·(the row's max|ref|).  A causal row t
# averages t values, so its scale falls as 1/sqrt(t): an absolute bound
# fit for row 0 would not see the late rows.  The rtol is about two
# roundings of bf16 (2^-8 is 0.0039); the atol, relative to the row,
# covers elements near 0.
FWD_ROW_TOL = (1e-2, 1e-2)


def log(*args):
    print(*args, flush=True)


# ---------------------------------------------------------------- phase 1
def phase_device() -> str:
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        smi = "nvidia-smi unavailable"
    log(f"card: {smi}")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    return smi


# ---------------------------------------------------------------- phase 2
def phase_build() -> float:
    t0 = time.perf_counter()
    logs = _build.build_all()
    dt = time.perf_counter() - t0
    log(f"build: {len(logs)} sources in {dt:.1f} s")
    for name, text in logs.items():
        usage = [ln.strip() for ln in text.splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"  {name}: " + " | ".join(usage))
    return dt


# ---------------------------------------------------------------- timing
_FLUSH = None


def _flush_l2():
    """Overwrite more than the 50 MB L2 so each timed launch starts cold,
    as a layer's kernel does after the other layers ran."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(96 << 20, dtype=torch.uint8, device=DEV)
    _FLUSH.fill_(1)


# ~5 ms of GPU clock: longer than the host takes to enqueue any timed call
_HOST_LEAD_CYCLES = 10_000_000


def time_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Median device time of one ``fn()`` call (CUDA events, cold L2).
    A sleep kernel queued before the start event keeps the card busy
    while the host enqueues the call, so the host's launch cost (the
    wrapper, ctypes, Python) stays out of the measured interval."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        _flush_l2()
        torch.cuda._sleep(_HOST_LEAD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# ---------------------------------------------------------------- phase 3
def paged_inputs(dtype, B=8, H=16, D=64, bs=16, nbps=32, seed=0,
                 pos=None):
    """Random pool, permuted tables, ragged positions (0, a full lane,
    the rest random; or the lanes' ``pos`` as given), all on the card."""
    g = torch.Generator().manual_seed(seed)
    if pos is not None:
        B = len(pos)
    nblocks = B * nbps + 1
    pool_k = torch.randn((nblocks, H, bs, D), generator=g)
    pool_v = torch.randn((nblocks, H, bs, D), generator=g)
    q = torch.randn((B, H, D), generator=g)
    tables = (torch.randperm(B * nbps, generator=g) + 1).reshape(B, nbps)
    if pos is None:
        pos = torch.randint(0, nbps * bs, (B,), generator=g)
        pos[0] = 0
        pos[1] = nbps * bs - 1
    else:
        pos = torch.tensor(pos)
    return (q.to(DEV, dtype), pool_k.to(DEV, dtype), pool_v.to(DEV, dtype),
            tables.to(DEV, torch.int32), pos.to(DEV, torch.int32))


def _lane_err(out, ref, pos, tag) -> float:
    """Max error over the lanes with a position; a lane at pos < 0 sees
    no slot and must give exactly 0 (the plain version, whose mask is
    finfo.min rather than -inf, averages every slot there)."""
    live = pos >= 0
    assert torch.all(out[~live] == 0), f"{tag}: a lane at pos < 0 is not 0"
    return (out.float() - ref.float())[live].abs().max().item()


def check_paged(dtype, **shape) -> float:
    q, pk, pv, tables, pos = paged_inputs(dtype, **shape)
    out = paged_attention(q, pk, pv, tables, pos)
    ref = paged_attention_dense(q, pk, pv, tables, pos)
    torch.cuda.synchronize()
    assert out.dtype == q.dtype and out.shape == q.shape
    err = _lane_err(out, ref, pos, f"paged {dtype} {shape}")
    assert err <= TOL[dtype], f"paged {dtype} {shape}: max err {err}"
    # masked-slot exactness: finite garbage in every slot past pos
    bs = pk.shape[2]
    slot = torch.arange(tables.shape[1] * bs, device=DEV)
    masked = slot[None, :] > pos[:, None].long()          # (B, W)
    blk = tables.long()[:, slot // bs][masked]
    off = (slot % bs)[None, :].expand_as(masked)[masked]
    pk2, pv2 = pk.clone(), pv.clone()
    pk2[blk, :, off] = 1e4
    pv2[blk, :, off] = -3e4
    out2 = paged_attention(q, pk2, pv2, tables, pos)
    assert torch.equal(out, out2), f"paged {dtype}: masked slots leak"
    # lane independence: each lane alone equals its co-batched row
    for b in range(q.shape[0]):
        solo = paged_attention(q[b:b + 1].contiguous(), pk, pv,
                               tables[b:b + 1].contiguous(),
                               pos[b:b + 1].contiguous())
        assert torch.equal(solo[0], out[b]), f"paged {dtype}: lane {b} mixes"
    return err


def paged_inputs_q8(dtype, **shape):
    """`paged_inputs` with the pools quantized by `quantize_kv`: q in
    ``dtype``, int8 pages and their f32 scales."""
    q, pk, pv, tables, pos = paged_inputs(torch.float32, **shape)
    pk8, sk = quantize_kv(pk)
    pv8, sv = quantize_kv(pv)
    return q.to(dtype), pk8, pv8, sk, sv, tables, pos


def check_paged_q8(dtype, **shape) -> float:
    """The int8-page kernel against its plain version; masked slots
    filled with random int8 values and NaN / 1e30 scales give the bits
    of zeros there; each lane alone gives its co-batched row; two
    launches give the same bits."""
    q, pk8, pv8, sk, sv, tables, pos = paged_inputs_q8(dtype, **shape)
    out = paged_attention_q8(q, pk8, pv8, sk, sv, tables, pos)
    ref = paged_attention_dense(q, pk8, pv8, tables, pos, sk, sv)
    torch.cuda.synchronize()
    tag = f"paged q8 {dtype} {shape}"
    assert out.dtype == q.dtype and out.shape == q.shape, tag
    err = _lane_err(out, ref, pos, tag)
    assert err <= TOL[dtype], f"{tag}: max err {err}"
    again = paged_attention_q8(q, pk8, pv8, sk, sv, tables, pos)
    assert torch.equal(out, again), f"{tag}: two launches differ"
    bs = pk8.shape[2]
    slot = torch.arange(tables.shape[1] * bs, device=DEV)
    masked = slot[None, :] > pos[:, None].long()          # (B, W)
    blk = tables.long()[:, slot // bs][masked]
    off = (slot % bs)[None, :].expand_as(masked)[masked]

    def filled(page, s_k, s_v):
        k8, v8, k_s, v_s = pk8.clone(), pv8.clone(), sk.clone(), sv.clone()
        k8[blk, :, off] = page
        v8[blk, :, off] = page
        k_s[blk, :, off] = s_k
        v_s[blk, :, off] = s_v
        return paged_attention_q8(q, k8, v8, k_s, v_s, tables, pos)

    noise = torch.randint(-127, 128, (int(masked.sum()), pk8.shape[1],
                                      pk8.shape[3]), dtype=torch.int8,
                          device=DEV)
    zero = filled(0, 0.0, 0.0)
    assert torch.equal(zero, out), f"{tag}: masked slots change the output"
    assert torch.equal(filled(noise, float("nan"), 1e30), zero), \
        f"{tag}: masked int8 slots or their scales leak"
    assert torch.equal(filled(noise, 1e30, float("nan")), zero), \
        f"{tag}: masked int8 slots or their scales leak"
    for b in range(q.shape[0]):
        solo = paged_attention_q8(q[b:b + 1].contiguous(), pk8, pv8, sk, sv,
                                  tables[b:b + 1].contiguous(),
                                  pos[b:b + 1].contiguous())
        assert torch.equal(solo[0], out[b]), f"{tag}: lane {b} mixes"
    # changing one lane's pages leaves every other lane's bits
    if q.shape[0] > 1:
        k8 = pk8.clone()
        k8[tables[0].long()] = torch.randint_like(k8[tables[0].long()],
                                                  -127, 128)
        other = paged_attention_q8(q, k8, pv8, sk, sv, tables, pos)
        assert torch.equal(other[1:], out[1:]), f"{tag}: lanes mix"
    return err


FLASH_CASES = (((8, 16, 128, 64), 128, True),
               ((2, 16, 1000, 64), 1000, True),
               ((2, 4, 37, 64), 300, True),
               ((2, 16, 256, 64), 256, False),
               ((2, 4, 300, 32), 37, True),          # 263 rows see no key
               ((1, 2, 70, 128), 70, True),
               ((1, 2, 33, 8), 90, False))


def check_flash(dtype, qshape, tk, causal) -> float:
    g = torch.Generator().manual_seed(1)
    B, H, Tq, D = qshape
    q = torch.randn(qshape, generator=g).to(DEV, dtype)
    k = torch.randn((B, H, tk, D), generator=g).to(DEV, dtype)
    v = torch.randn((B, H, tk, D), generator=g).to(DEV, dtype)
    scale = 1.0 / math.sqrt(D)
    out, lse = flash_attention_with_lse(q, k, v, causal, scale)
    ref, ref_lse = _reference_attention_lse(q, k, v, causal, scale)
    torch.cuda.synchronize()
    assert out.dtype == q.dtype and out.shape == q.shape
    assert lse.dtype == torch.float32 and lse.shape == (B, H, Tq)
    err = (out.float() - ref.float()).abs().max().item()
    tag = f"flash {dtype} q{qshape} tk={tk} causal={causal}"
    assert err <= TOL[dtype], f"{tag}: max err {err}"
    dead = torch.isinf(ref_lse)
    assert torch.equal(torch.isinf(lse), dead), f"{tag}: lse -inf rows"
    assert torch.all(lse[dead] < 0), f"{tag}: lse +inf"
    if dead.any():
        assert torch.all(out[dead] == 0), f"{tag}: masked rows not 0"
    lse_err = (lse[~dead] - ref_lse[~dead]).abs().max().item()
    assert lse_err <= 1e-4, f"{tag}: lse err {lse_err}"
    again = flash_attention_with_lse(q, k, v, causal, scale)
    assert torch.equal(again[0], out) and torch.equal(again[1], lse), \
        f"{tag}: two launches differ"
    # the bounds can tell a wrong kernel: a zeroed output and an lse
    # shifted by ten times its bound fail them on the same inputs
    zeroed = (torch.zeros_like(out).float() - ref.float()).abs().max().item()
    assert zeroed > TOL[dtype], f"{tag}: a zeroed output would pass the bound"
    shifted = (lse[~dead] + 1e-3 - ref_lse[~dead]).abs().max().item()
    assert shifted > 1e-4, f"{tag}: a shifted lse would pass the bound"
    return err


PAGED_SHAPES = ([dict()]
                + [dict(B=3, H=2, D=D, bs=8, nbps=4) for D in (16, 32, 128)]
                + [dict(B=3, H=2, D=64, bs=bs, nbps=5) for bs in (1, 2, 64)]
                # the kernel's split of a lane's pages over 8 warps: a lane
                # at pos 2047 with bs 16 (128 pages, 16 a warp) beside short
                # ones; lanes at pos -1, 0, bs - 1 and bs; a lane with fewer
                # pages than warps; bs 1 and 64
                + [dict(H=4, D=64, bs=16, nbps=128, pos=[2047, 5, 700]),
                   dict(H=4, D=64, bs=16, nbps=4, pos=[-1, 0, 15, 16]),
                   dict(H=4, D=128, bs=16, nbps=8, pos=[47, 100]),
                   dict(H=4, D=32, bs=1, nbps=40, pos=[-1, 0, 3, 39]),
                   dict(H=4, D=64, bs=64, nbps=4, pos=[0, 63, 64, 255])])


def phase_kernels() -> dict:
    errs = {"paged_attention": {}, "paged_attention_q8": {},
            "flash_attention": {}}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        errs["paged_attention"][name] = max(
            check_paged(dtype, **shape) for shape in PAGED_SHAPES)
        errs["paged_attention_q8"][name] = max(
            check_paged_q8(dtype, **shape) for shape in PAGED_SHAPES)
        errs["flash_attention"][name] = max(
            check_flash(dtype, *case) for case in FLASH_CASES)
    line = {"kernels": [
        {"name": k, "max_abs_err": v, "tol": {n: TOL[getattr(torch, n)]
                                              for n in v}}
        for k, v in errs.items()]}
    log(json.dumps(line))
    return errs


def _excess(got, ref, tol) -> float:
    """The largest ratio of |got - ref| to rtol·|ref| + atol·max|ref|;
    at most 1 passes."""
    rtol, atol = tol
    r = ref.float()
    allow = rtol * r.abs() + atol * r.abs().max()
    tiny = torch.finfo(torch.float32).tiny
    return ((got.float() - r).abs() / allow.clamp(min=tiny)).max().item()


def _row_excess(got, ref, tol) -> float:
    """`_excess` with the atol taken from each row's (last axis's)
    max|ref|."""
    rtol, atol = tol
    r = ref.float()
    allow = rtol * r.abs() + atol * r.abs().amax(-1, keepdim=True)
    tiny = torch.finfo(torch.float32).tiny
    return ((got.float() - r).abs() / allow.clamp(min=tiny)).max().item()


def check_bwd_grads(got, q, k, v, do, lse, delta, causal, scale, tag):
    """(dq, dk, dv) within `BWD_TOL` of `flash_bwd_plain` on the same
    inputs, each; a zeroed output, a dS without its Δ term (dq, dk) and
    a P taken with lse + 1 (dv) must fail that bound, so it can tell a
    wrong kernel.  Returns the max absolute error."""
    tol = BWD_TOL[q.dtype]
    ref = flash_bwd_plain(q, k, v, do, lse, delta, causal, scale)
    no_delta = flash_bwd_plain(q, k, v, do, lse, torch.zeros_like(delta),
                               causal, scale)
    lse_1 = flash_bwd_plain(q, k, v, do, lse + 1, delta, causal, scale)
    bad = {"dq": (no_delta[0],), "dk": (no_delta[1],), "dv": (lse_1[2],)}
    err = 0.0
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape, f"{tag}: {name}"
        ex = _excess(g, r, tol)
        assert ex <= 1.0, f"{tag}: {name} {ex:.3g}x its allowance"
        for b, what in zip((torch.zeros_like(r),) + bad[name],
                           ("zeroed", "wrong-term")):
            assert _excess(b, r, tol) > 1.0, \
                f"{tag}: a {what} {name} would pass the bound"
        err = max(err, (g.float() - r.float()).abs().max().item())
    return err


def check_flash_bwd(dtype, qshape, tk, causal, lse_variant) -> float:
    """The dK/dV and dQ kernels against flash_bwd_plain; with
    ``lse_variant`` through the autograd Function of
    flash_attention_with_lse with cotangents on out and lse (Δ − dlse).
    Two launches give the same bits; rows that see no key get dq 0."""
    g = torch.Generator().manual_seed(2)
    B, H, Tq, D = qshape
    q = torch.randn(qshape, generator=g).to(DEV, dtype)
    k = torch.randn((B, H, tk, D), generator=g).to(DEV, dtype)
    v = torch.randn((B, H, tk, D), generator=g).to(DEV, dtype)
    do = torch.randn(qshape, generator=g).to(DEV, dtype)
    dlse = torch.randn((B, H, Tq), generator=g).to(DEV)
    scale = 1.0 / math.sqrt(D)
    tag = (f"flash bwd {dtype} q{qshape} tk={tk} causal={causal} "
           f"lse={lse_variant}")
    if lse_variant:
        qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
        out, lse = flash_attention_with_lse(qr, kr, vr, causal, scale)
        dlse = torch.where(torch.isfinite(lse), dlse, torch.zeros_like(dlse))
        got = torch.autograd.grad((out, lse), (qr, kr, vr), (do, dlse))
        out, lse = out.detach(), lse.detach()
        delta = (do.float() * out.float()).sum(-1) - dlse
    else:
        out, lse = flash_attention_with_lse(q, k, v, causal, scale)
        delta = (do.float() * out.float()).sum(-1)
        args = (q, k, v, do, lse, delta, causal, scale)
        got = (flash_bwd_dq(*args),) + tuple(flash_bwd_dkdv(*args))
        again = (flash_bwd_dq(*args),) + tuple(flash_bwd_dkdv(*args))
        assert all(torch.equal(a, b) for a, b in zip(got, again)), \
            f"{tag}: two launches differ"
    torch.cuda.synchronize()
    dead = torch.isinf(lse)
    assert torch.all(got[0][dead] == 0), f"{tag}: dq of rows without keys"
    return check_bwd_grads(got, q, k, v, do, lse, delta, causal, scale, tag)


def phase_flash_bwd_kernels() -> dict:
    errs = {"flash_bwd_dkdv": {}, "flash_bwd_dq": {}}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        e = max(check_flash_bwd(dtype, *case, lse_variant=lv)
                for case in FLASH_CASES for lv in (False, True))
        errs["flash_bwd_dkdv"][name] = errs["flash_bwd_dq"][name] = e
    log(json.dumps({"flash_bwd_kernels": errs, "tol": {
        str(dt).replace("torch.", ""): f"rtol {r} of |ref| + atol {a} of "
                                       f"max|ref|"
        for dt, (r, a) in BWD_TOL.items()}}))
    return errs


# ---------------------------------------------------------------- phase 4
@contextlib.contextmanager
def recording(module, name, keep):
    """Route ``module.name`` through a wrapper that hands each call's
    arguments to ``keep`` and then calls the real function — the main
    path still launches the kernel through its own wrapper; this only
    remembers the inputs it gave it, for phase 6."""
    real = getattr(module, name)

    def wrapper(*args, **kw):
        keep(args, kw)
        return real(*args, **kw)

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, real)


def _kept(args) -> tuple:
    """A call's arguments as a recording keeps them: tensors copied, so
    that a kept activation neither keeps its autograd graph (a recorded
    forward's warm-up graph, which its capture frees) alive nor changes
    when later replays overwrite a captured graph's buffers."""
    return tuple(a.detach().clone() if isinstance(a, torch.Tensor) else a
                 for a in args)


def _live_pages(tables, pos, bs):
    """Distinct pool blocks the lanes' walks read (pages 0..pos//bs)."""
    t, p = tables.cpu().numpy(), pos.cpu().numpy()
    return {int(t[b, j]) for b in range(t.shape[0])
            for j in range(int(p[b]) // bs + 1)}


def _burst(eng, prompts, n_new=32):
    """Phase 4's traffic on ``eng``: a warm-up request, then one request
    a prompt and, once request 1 decodes, its prompt again (a
    prefix-cache hit).  Returns (tokens a prompt, the hit's tokens, the
    hit's request, seconds, every timed request)."""
    eng.submit(prompts[0][:40], 2).result(timeout=300)      # warm-up
    t0 = time.perf_counter()
    reqs = [eng.submit(p, n_new) for p in prompts]
    deadline = time.monotonic() + 300
    while reqs[1].status != "running" and not reqs[1].finished:
        assert time.monotonic() < deadline, "request 1 stalled"
        time.sleep(0.001)
    dup = eng.submit(prompts[1], n_new)
    toks = [r.result(timeout=600) for r in reqs]
    dup_toks = dup.result(timeout=600)
    return toks, dup_toks, dup, time.perf_counter() - t0, reqs + [dup]


def _p50(reqs, field):
    vals = [getattr(r, field) for r in reqs if getattr(r, field) is not None]
    return float(np.median(vals))


def _build_net(dtype, num_layers, seed):
    cfg = dict(MODEL, num_layers=num_layers)
    net = TransformerLM(**cfg, dropout=0.0, device=DEV, seed=seed)
    return net.cast(dtype) if dtype != torch.float32 else net


def phase_main_path(smi: str) -> dict:
    t0 = time.perf_counter()
    net = _build_net(torch.bfloat16, MODEL["num_layers"], seed=0)
    torch.cuda.synchronize()
    nbytes = sum(p.numel() * p.element_size() for p in net.parameters())
    log(f"main path: TransformerLM {MODEL} bf16, {nbytes / 1e9:.3f} GB of "
        f"weights, built in {time.perf_counter() - t0:.1f} s")
    rs = np.random.RandomState(0)
    V = MODEL["vocab"]
    rec = {"flash": None, "step": [], "chunk": []}
    pools0 = []

    def keep_flash(args, kw):
        # the longest prefill of the phase (the warm-up call is shorter)
        if rec["flash"] is None \
                or args[0].shape[2] > rec["flash"][0][0].shape[2]:
            rec["flash"] = ([a.clone() for a in args[:3]], dict(kw))

    def keep_paged(args, kw):
        q, pk, pv, tables, pos = args
        if pk is not pools0[0][0]:
            return                          # layer 0's calls only
        kind = "step" if q.shape[0] == eng_batch else "chunk"
        rec[kind].append((q.clone(), tables.clone(), pos.clone()))

    eng_batch = 8
    # the counts start from 0 here and are read right after the phase
    for name in SERVING_KERNELS:
        KERNELS[name]["fn"].launches = 0
    with recording(gen_mod, "flash_attention", keep_flash), \
            recording(prog_mod, "paged_attention", keep_paged):
        # -- net.generate: B=8, P=128, N=32 (flash prefill + decode) --
        prompt = torch.from_numpy(rs.randint(0, V, (8, 128))).to(DEV)
        net.generate(prompt[:, :8], 2)                  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = net.generate(prompt, 32)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        assert out.shape == (8, 160) and out.dtype == torch.int32
        assert torch.equal(out[:, :128].long(), prompt)
        assert int(out.min()) >= 0 and int(out.max()) < V
        logits = net(prompt[:1, :64])
        assert logits.shape == (1, 64, V)
        assert torch.isfinite(logits.float()).all(), "non-finite logits"

        # -- the paged engine: 8 requests of 32..300 prompt tokens ----
        lens = np.linspace(32, 300, 8).astype(int)
        prompts = [rs.randint(0, V, (n,)).astype(np.int32) for n in lens]
        eng = ServingEngine(net, max_batch=eng_batch, block_size=16,
                            prefill_chunk=32)
        pools0.append((eng._programs.pool_k[0], eng._programs.pool_v[0]))
        try:
            toks, dup_toks, dup, eng_s, reqs_all = _burst(eng, prompts)
            st = eng.stats()
            kv = {"kv_bytes_per_token": eng.kv_bytes_per_token,
                  "kv_pool_bytes": eng.kv_pool_bytes}
        finally:
            eng.close()
        assert st["kv_dtype"] == "model" and st["path"] == "float", st
        for t in toks + [dup_toks]:
            assert len(t) == 32 and all(0 <= x < V for x in t)
        assert dup.cached_tokens > 0, "the second submission missed"
        assert dup_toks == toks[1], "prefix-cache hit differs from cold"
        # a request alone on a fresh engine (cold cache) equals its
        # co-batched run; the profiler watches this run for the card's
        # busy share
        with ServingEngine(net, max_batch=eng_batch, block_size=16,
                           prefill_chunk=32) as solo_eng:
            solo_eng.submit(prompts[0][:40], 2).result(timeout=300)
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                solo = solo_eng.submit(prompts[5], 32).result(timeout=600)
                torch.cuda.synchronize()
                solo_s = time.perf_counter() - t0
        assert solo == toks[5], "solo run differs from co-batched run"
        busy = device_busy(prof, solo_s)
    torch.cuda.synchronize()
    launches = {name: KERNELS[name]["fn"].launches
                for name in SERVING_KERNELS}
    for name in FLOAT_SERVING:
        assert launches[name] > 0, \
            f"{name} was never launched on the main path"
    assert launches["paged_attention_q8"] == 0, launches

    n_tok = sum(len(r.tokens) for r in reqs_all)
    res = {
        "generate_tok_s": 8 * 32 / gen_s,
        "engine_tok_s": n_tok / eng_s,
        "ttft_p50_s": _p50(reqs_all, "ttft"),
        "tpot_p50_s": _p50(reqs_all, "tpot"),
        "engine_steps": st["steps"],
        "prefix_hits": st["prefix_cache"]["hits"],
        "launches": launches,
        "busy": busy,
        "rec": rec,
        "pools": pools0[0],                 # layer 0's, kept for phase 6
        "kv": kv,
        "prompts": prompts,
        "prompt": prompt,
        "generate_out": out,
        "net": net,                         # the quantized path reuses it
    }
    log(f"main path [{smi}]: generate B=8 P=128 N=32 {gen_s:.3f} s "
        f"({res['generate_tok_s']:.1f} tok/s); engine {n_tok} tokens over "
        f"{len(reqs_all)} requests in {eng_s:.3f} s "
        f"({res['engine_tok_s']:.1f} decoded tok/s, TTFT p50 "
        f"{res['ttft_p50_s'] * 1e3:.1f} ms, TPOT p50 "
        f"{res['tpot_p50_s'] * 1e3:.2f} ms, {st['steps']} steps, "
        f"{st['prefix_cache']['hits']} prefix hit(s)); launches {launches}")
    log(f"solo request ({len(prompts[5])}-token prompt, 32 tokens) under "
        f"the profiler [{smi}]: {solo_s:.3f} s wall, card busy "
        f"{busy['busy_s']:.4f} s = {busy['busy_share']:.3f} of the wall "
        f"(idle {1 - busy['busy_share']:.3f}), {busy['kernels']} kernels; "
        f"paged kernel {_paged_ms(busy):.3f} ms; "
        f"device ms by kernel: " + "; ".join(
            f"{n} {ms:.3f}" for n, ms in busy["top"]))
    return res


def _paged_ms(busy) -> float:
    """Device ms of the paged kernel (both page types) in a profile."""
    return sum(ms for n, ms in busy["by_name"].items()
               if "paged_attention_kernel" in n)


def device_busy(prof, wall_s: float) -> dict:
    """The card's busy time in a profiled window: the union of its
    kernel intervals, over the window's host wall time, and the kernels
    that took most of it."""
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    assert kern, "the profiler saw no kernel on the card"
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    by_name = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"busy_s": busy_us * 1e-6, "busy_share": busy_us * 1e-6 / wall_s,
            "kernels": len(kern),
            "top": [(n[:60], us * 1e-3) for n, us in top],
            "by_name": {n: us * 1e-3 for n, us in by_name.items()}}


# ---------------------------------------------------------------- phase 5
def phase_parity() -> None:
    net = _build_net(torch.float32, 2, seed=1)
    rs = np.random.RandomState(1)
    prompts = [rs.randint(0, MODEL["vocab"], (n,)).astype(np.int32)
               for n in (40, 77, 130, 200)]
    N = 16
    want = [net.generate(p[None, :], N)[0, len(p):].tolist()
            for p in prompts]
    with ServingEngine(net, max_batch=4, block_size=16,
                       prefill_chunk=32) as eng:
        reqs = [eng.submit(p, N) for p in prompts]
        got = [r.result(timeout=600) for r in reqs]
    n_equal = 0
    for p, w, g in zip(prompts, want, got):
        if w == g:
            n_equal += 1
            continue
        i = next(j for j in range(N) if w[j] != g[j])
        seq = torch.from_numpy(np.concatenate([p, w[:i]])).to(DEV)
        top2 = net(seq[None, :].long())[0, -1].topk(2).values
        gap = float(top2[0] - top2[1])
        assert gap < PARITY_GAP, (
            f"engine and generate differ at token {i} of a {len(p)}-token "
            f"prompt where the top-2 gap is {gap}")
        log(f"parity: prompt {len(p)} first differs at token {i}, top-2 "
            f"gap {gap:.2e} < {PARITY_GAP}")
    log(f"parity (f32, 2 layers): {n_equal}/{len(prompts)} prompts "
        f"token-equal over {N} tokens")


# ---------------------------------------------------------------- phase 6
def _busiest(calls, bs):
    return max(calls, key=lambda c: len(_live_pages(c[1], c[2], bs)))


def time_paged(res) -> dict:
    pk, pv = res["pools"]
    bs = pk.shape[2]
    out = {}
    for kind in ("step", "chunk"):
        q, tables, pos = _busiest(res["rec"][kind], bs)
        args = (q, pk, pv, tables, pos)
        err = (paged_attention(*args).float()
               - paged_attention_dense(*args).float()).abs().max().item()
        assert err <= TOL[q.dtype], f"paged at main-path inputs: err {err}"
        live = _live_pages(tables, pos, bs)
        H, D = pk.shape[1], pk.shape[3]
        page_bytes = H * bs * D * pk.element_size()
        nbytes = (2 * len(live) * page_bytes
                  + 2 * q.numel() * q.element_size()
                  + tables.numel() * 4 + pos.numel() * 4)
        slots = int((pos.long() + 1).sum())
        flops = 4 * slots * H * D
        bound = max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[q.dtype])
        out[kind] = {
            "shape": f"q {tuple(q.shape)} pool {tuple(pk.shape)} "
                     f"pos {pos.tolist()}",
            "max_abs_err": err,
            "ms": time_ms(lambda: paged_attention(*args)),
            "plain_ms": time_ms(lambda: paged_attention_dense(*args)),
            "bound_ms": bound * 1e3,
            "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                         >= flops / PEAK_FLOPS[q.dtype] else "operations"),
            "live_pages": len(live), "bytes": nbytes,
        }
    return out


def time_flash_fwd(q, k, v, causal, scale, tag) -> dict:
    """The flash forward at one call's inputs: held to the plain version
    there, timed beside it, SDPA and the bound (read q, k, v; write out
    and lse)."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    out, _ = flash_attention_with_lse(q, k, v, causal, scale)
    ref, _ = _reference_attention_lse(q, k, v, causal, scale)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[q.dtype], f"flash at {tag} inputs: err {err}"
    flops = 4 * B * H * D * _live_pairs(Tq, Tk, causal)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() \
        + B * H * Tq * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[q.dtype]
    assert Tq == Tk or not causal     # SDPA's causal mask is top-left
    return {
        "shape": f"q {tuple(q.shape)} k {tuple(k.shape)} causal={causal}",
        "max_abs_err": err,
        "ms": time_ms(lambda: flash_attention_with_lse(q, k, v, causal,
                                                       scale)),
        "plain_ms": time_ms(lambda: _reference_attention_lse(q, k, v,
                                                             causal, scale)),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, scale=scale)),
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "flops": flops, "bytes": nbytes,
    }


def time_flash(res) -> dict:
    (q, k, v), kw = res["rec"]["flash"]
    return time_flash_fwd(q, k, v, kw.get("causal", False),
                          1.0 / math.sqrt(q.shape[-1]), "generate prefill")


# ---------------------------------------------------------------- phase 14
def _dense_targets(net):
    """The Dense layers `quantize_for_decode` quantizes by default."""
    return [d for lyr in net._layers
            for d in (lyr.attn.qkv, lyr.attn.proj, lyr.ffn.ffn_dense1,
                      lyr.ffn.ffn_dense2)]


def check_int8_dense(net) -> dict:
    """The int8 decode matmuls on the card at the main path's widths
    (layer 0's ffn_dense1, 1024 -> 4096, bf16 activations; 8 rows as a
    decode step, 32 as a prefill chunk): the weight-only form against
    f32 operands (the f32 accumulator JAX keeps) and, for scale, a bf16
    ``F.linear`` against the same; the dynamic form's product, exact by
    ``_int_mm`` (32 rows) or by f64 (8 rows), against int64 sums on the
    host."""
    w8 = net._decode_quant.packed(net._layers[0].ffn.ffn_dense1)["w8"]
    g = torch.Generator().manual_seed(5)
    out = {}
    for rows in (8, 32):
        x = torch.randn((rows, w8.shape[1]), generator=g).to(DEV,
                                                             torch.bfloat16)
        f32 = x.float() @ w8.float().t()
        mag = f32.abs().max().item()
        got = (gen_mod._f32_product(x, w8) - f32).abs().max().item()
        bf16 = (F.linear(x, w8.to(torch.bfloat16)).float()
                - f32).abs().max().item()
        assert got <= 1e-5 * mag, f"weight-only int8 product: {got} of {mag}"
        xq = torch.randint(-127, 128, (rows, w8.shape[1]), generator=g,
                           dtype=torch.int8)
        exact = (xq.long() @ w8.cpu().long().t()).float()
        assert torch.equal(gen_mod._int_product(xq.to(DEV), w8).cpu(),
                           exact), f"int8 x int8 product at {rows} rows"
        out[rows] = {"max_abs_f32": mag, "out_dtype_vs_f32": got,
                     "bf16_linear_vs_f32": bf16,
                     "shape": f"({rows}, {w8.shape[1]}) x {tuple(w8.shape)}"}
    return out


def phase_quant_path(smi: str, res) -> dict:
    """The quantized serving path at full width: the phase-4 net with
    `quantize_for_decode` (int8 weights, ``act_quant`` auto = "none" on
    CUDA), ``generate`` (B=8, P=128, N=32), then a ServingEngine with
    int8 KV pages over phase 4's requests (one prefix-cache hit) and a
    profiled solo request on a fresh one.  Every step and chunk of the
    kv8 engines launches the int8-page kernel once a layer; the float
    paged kernel never runs."""
    net, prompt, prompts = res["net"], res["prompt"], res["prompts"]
    V, L = MODEL["vocab"], MODEL["num_layers"]
    float_bytes = sum(d.weight.numel() * d.weight.element_size()
                      for d in _dense_targets(net))
    t0 = time.perf_counter()
    net.quantize_for_decode()
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    qc = net._decode_quant
    assert qc.act_quant == "none", qc.act_quant      # "auto" on CUDA
    dense = check_int8_dense(net)
    eng_batch = 8
    rec = {"step": [], "chunk": []}
    pools = []          # each kv8 engine's layer-0 pools and scales
    n_chunks = [0]

    def keep(args, kw):
        q, pk = args[0], args[1]
        for i, pl in enumerate(pools):
            if pk is pl[0]:
                kind = "step" if q.shape[0] == eng_batch else "chunk"
                n_chunks[0] += kind == "chunk"
                if i == 0:
                    rec[kind].append((q.clone(), args[3].clone(),
                                      args[4].clone()))

    def layer0(eng):
        pg = eng._programs
        return (pg.pool_k[0], pg.pool_v[0], pg.scale_k[0], pg.scale_v[0])

    def kv8_engine():
        return ServingEngine(net, max_batch=eng_batch, block_size=16,
                             prefill_chunk=32, kv_dtype="int8")

    # the counts start from 0 here and are read right after the phase
    for name in SERVING_KERNELS:
        KERNELS[name]["fn"].launches = 0
    with recording(prog_mod, "paged_attention", keep):
        net.generate(prompt[:, :8], 2)                  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = net.generate(prompt, 32)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        assert out.shape == (8, 160) and out.dtype == torch.int32
        assert torch.equal(out[:, :128].long(), prompt)
        assert int(out.min()) >= 0 and int(out.max()) < V
        agree = (out[:, 128:] == res["generate_out"][:, 128:]).float().mean()

        eng = kv8_engine()
        pools.append(layer0(eng))
        try:
            assert eng.path == "int8" and eng.kv_dtype == "int8"
            toks, dup_toks, dup, eng_s, reqs_all = _burst(eng, prompts)
            kv = {"kv_bytes_per_token": eng.kv_bytes_per_token,
                  "kv_pool_bytes": eng.kv_pool_bytes}
        finally:
            eng.close()
        st = eng.stats()                    # final: the thread is joined
        assert st["kv_dtype"] == "int8" and st["path"] == "int8", st
        for t in toks + [dup_toks]:
            assert len(t) == 32 and all(0 <= x < V for x in t)
        assert dup.cached_tokens > 0, "the second submission missed"
        assert dup_toks == toks[1], "kv8 prefix-cache hit differs from cold"
        solo_eng = kv8_engine()
        pools.append(layer0(solo_eng))
        try:
            solo_eng.submit(prompts[0][:40], 2).result(timeout=300)
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                solo = solo_eng.submit(prompts[5], 32).result(timeout=600)
                torch.cuda.synchronize()
                solo_s = time.perf_counter() - t0
        finally:
            solo_eng.close()
        steps = st["steps"] + solo_eng.stats()["steps"]
        assert solo == toks[5], "kv8 solo run differs from co-batched run"
        busy = device_busy(prof, solo_s)
    torch.cuda.synchronize()
    launches = {name: KERNELS[name]["fn"].launches
                for name in SERVING_KERNELS}
    assert launches["paged_attention"] == 0, \
        f"the float paged kernel ran on the kv8 path: {launches}"
    assert launches["flash_attention"] > 0, launches
    want = L * (steps + n_chunks[0])
    assert launches["paged_attention_q8"] == want > 0, \
        (f"paged_attention_q8 launched {launches['paged_attention_q8']} "
         f"times over {steps} steps and {n_chunks[0]} chunks of {L} layers")

    n_tok = sum(len(r.tokens) for r in reqs_all)
    out = {
        "generate_tok_s": 8 * 32 / gen_s,
        "generate_agree": float(agree),
        "engine_tok_s": n_tok / eng_s,
        "ttft_p50_s": _p50(reqs_all, "ttft"),
        "tpot_p50_s": _p50(reqs_all, "tpot"),
        "steps": steps, "chunks": n_chunks[0],
        "launches": launches, "busy": busy, "kv": kv,
        "weight_bytes": {"int8": qc.weight_bytes(), "float": float_bytes},
        "dense": dense, "rec": rec, "pools": pools[0],
    }
    fkv = res["kv"]
    log(f"quantized path [{smi}]: quantize_for_decode {quant_s:.2f} s "
        f"(act_quant {qc.act_quant}); generate B=8 P=128 N=32 on int8 "
        f"weights {gen_s:.3f} s ({out['generate_tok_s']:.1f} tok/s, "
        f"{out['generate_agree']:.3f} of tokens equal to bf16 weights'); "
        f"kv8 engine {n_tok} tokens over {len(reqs_all)} requests in "
        f"{eng_s:.3f} s ({out['engine_tok_s']:.1f} decoded tok/s, TTFT p50 "
        f"{out['ttft_p50_s'] * 1e3:.1f} ms, TPOT p50 "
        f"{out['tpot_p50_s'] * 1e3:.2f} ms, {st['steps']} steps, "
        f"{st['prefix_cache']['hits']} prefix hit(s)); launches {launches} "
        f"= {L} x ({steps} steps + {n_chunks[0]} chunks) for the q8 kernel")
    log(f"kv pool [{smi}]: int8 {kv['kv_bytes_per_token']} B/token, "
        f"{kv['kv_pool_bytes']} B; bf16 {fkv['kv_bytes_per_token']} "
        f"B/token, {fkv['kv_pool_bytes']} B; "
        f"{fkv['kv_bytes_per_token'] / kv['kv_bytes_per_token']:.3f}x the "
        f"resident sequences at equal bytes; decode weight bytes int8 "
        f"{out['weight_bytes']['int8']} against bf16 "
        f"{out['weight_bytes']['float']}")
    log(f"int8 decode matmuls, bf16 activations [{smi}]: " +
        "; ".join(f"{d['shape']}: |f32 sum| <= {d['max_abs_f32']:.3f}, "
                  f"mm(out_dtype=f32) within {d['out_dtype_vs_f32']:.3g} "
                  f"of f32 operands, a bf16 F.linear within "
                  f"{d['bf16_linear_vs_f32']:.3g}, int8 x int8 exact"
                  for r, d in dense.items()))
    log(f"kv8 solo request ({len(prompts[5])}-token prompt, 32 tokens) "
        f"under the profiler [{smi}]: {solo_s:.3f} s wall, card busy "
        f"{busy['busy_s']:.4f} s = {busy['busy_share']:.3f} of the wall "
        f"(idle {1 - busy['busy_share']:.3f}), {busy['kernels']} kernels; "
        f"paged kernel {_paged_ms(busy):.3f} ms; "
        f"device ms by kernel: " + "; ".join(
            f"{n} {ms:.3f}" for n, ms in busy["top"]))
    net.dequantize_decode()
    return out


# ---------------------------------------------------------------- phase 15
def _chunk_logits(net, seq, kv_dtype=None):
    """The engine's f32 logits after ``seq``: its token forward over a
    fresh pool (int8 with ``kv_dtype="int8"``), the whole sequence as
    one chunk, through the plain versions (no launch is counted)."""
    T, bs = len(seq), 16
    nbps = -(-T // bs)
    progs = PagedPrograms(net, max_batch=1, block_size=bs,
                          blocks_per_seq=nbps, num_blocks=nbps + 1,
                          temperature=0.0, top_k=0, prefill_chunk=T,
                          quantized=False, kv_dtype=kv_dtype)
    row = torch.arange(1, nbps + 1, dtype=torch.int32, device=DEV)
    pos = torch.arange(T, dtype=torch.int32, device=DEV)
    params = gen_mod._gather_params(net, progs._qc)
    with plain_kernels():
        h = prog_mod._token_forward(
            params, progs._acts, progs._H, progs.pool_k, progs.pool_v,
            progs.scale_k, progs.scale_v,
            row[None, :].expand(T, nbps).contiguous(),
            torch.as_tensor(np.asarray(seq), device=DEV), pos,
            row.long()[pos.long() // bs], pos.long() % bs)
    return gen_mod._logits_of(params, h[-1:])[0]


def _kv8_gap(net, seq) -> float:
    """Top-2 gap of the kv8 engine's logits after ``seq``."""
    top2 = _chunk_logits(net, seq, "int8").topk(2).values
    return float(top2[0] - top2[1])


def _parity(a, b) -> float:
    """Fraction of greedy tokens two runs share, position by position."""
    tot = sum(len(t) for t in a)
    return sum(x == y for ta, tb in zip(a, b) for x, y in zip(ta, tb)) / tot


def phase_quant_parity() -> dict:
    """At full width, 2 layers, f32: the kv8 engine through the int8
    kernel against the same engine on the plain versions (tokens equal,
    or first different where the top-2 gap is below PARITY_GAP); the
    kv8 engine against the float engine and quantized ``generate``
    against float ``generate``, greedy parity >= 95% each (the JAX
    package's quality contract)."""
    net = _build_net(torch.float32, 2, seed=1)
    rs = np.random.RandomState(2)
    prompts = [rs.randint(0, MODEL["vocab"], (n,)).astype(np.int32)
               for n in (40, 77, 130, 200)]
    N = 16

    def engine_run(**kw):
        with ServingEngine(net, max_batch=4, block_size=16,
                           prefill_chunk=32, **kw) as eng:
            reqs = [eng.submit(p, N) for p in prompts]
            return [r.result(timeout=600) for r in reqs]

    n0 = paged_attention_q8.launches
    got_k = engine_run(kv_dtype="int8")
    n1 = paged_attention_q8.launches
    with plain_kernels():
        got_p = engine_run(kv_dtype="int8")
    assert n1 > n0 and paged_attention_q8.launches == n1, (n0, n1)
    n_equal = 0
    for p, k, q in zip(prompts, got_k, got_p):
        if k == q:
            n_equal += 1
            continue
        i = next(j for j in range(N) if k[j] != q[j])
        gap = _kv8_gap(net, np.concatenate([p, k[:i]]))
        assert gap < PARITY_GAP, (
            f"kv8 kernel and plain engines differ at token {i} of a "
            f"{len(p)}-token prompt where the top-2 gap is {gap}")
        log(f"quantized parity: prompt {len(p)} first differs at token {i},"
            f" top-2 gap {gap:.2e} < {PARITY_GAP}")
    got_f = engine_run()
    kv8_vs_float = _parity(got_k, got_f)
    assert kv8_vs_float >= 0.95, f"kv8 vs float engine: {kv8_vs_float}"
    gen_f = [net.generate(p[None, :], N)[0, len(p):].tolist()
             for p in prompts]
    net.quantize_for_decode()
    gen_q = [net.generate(p[None, :], N)[0, len(p):].tolist()
             for p in prompts]
    net.dequantize_decode()
    int8_vs_float = _parity(gen_q, gen_f)
    assert int8_vs_float >= 0.95, f"int8 vs float generate: {int8_vs_float}"
    log(f"quantized parity (f32, 2 layers, width {MODEL['units']}): kv8 "
        f"engine kernel vs plain {n_equal}/{len(prompts)} prompts "
        f"token-equal over {N} tokens; greedy parity kv8 vs float engine "
        f"{kv8_vs_float:.3f}, int8-weight vs float generate "
        f"{int8_vs_float:.3f} (>= 0.95 each)")
    return {"kernel_vs_plain": n_equal, "kv8_vs_float": kv8_vs_float,
            "int8_vs_float": int8_vs_float}


# ---------------------------------------------------------------- phase 16
def time_paged_q8(qres) -> dict:
    """The int8-page kernel at the kv8 engine's busiest recorded step and
    chunk: held to its plain version there, timed beside it, beside the
    float kernel on the same pages dequantized to q's dtype, and beside
    the bound (the live int8 pages and 4 bytes of scale a slot, q read,
    out written, over 3.35 TB/s)."""
    pk8, pv8, sk, sv = qres["pools"]
    bs, H, D = pk8.shape[2], pk8.shape[1], pk8.shape[3]
    out = {}
    for kind in ("step", "chunk"):
        q, tables, pos = _busiest(qres["rec"][kind], bs)
        args = (q, pk8, pv8, sk, sv, tables, pos)
        ref = paged_attention_dense(q, pk8, pv8, tables, pos, sk, sv)
        err = (paged_attention_q8(*args).float()
               - ref.float()).abs().max().item()
        assert err <= TOL[q.dtype], f"paged q8 at main-path inputs: err {err}"
        pk_f = (pk8.float() * sk[..., None]).to(q.dtype)
        pv_f = (pv8.float() * sv[..., None]).to(q.dtype)
        f_err = (paged_attention(q, pk_f, pv_f, tables, pos).float()
                 - ref.float()).abs().max().item()
        live = _live_pages(tables, pos, bs)
        page_bytes = H * bs * (D + 4)                 # int8 + f32 scale
        nbytes = (2 * len(live) * page_bytes + 2 * q.numel() * q.element_size()
                  + tables.numel() * 4 + pos.numel() * 4)
        flops = 4 * int((pos.long() + 1).sum()) * H * D
        bound, by = _bound(nbytes, flops, PEAK_FLOPS[q.dtype])
        out[kind] = {
            "shape": f"q {tuple(q.shape)} {q.dtype} pool {tuple(pk8.shape)} "
                     f"int8 pos {pos.tolist()}",
            "max_abs_err": err,
            "ms": time_ms(lambda: paged_attention_q8(*args)),
            "plain_ms": time_ms(lambda: paged_attention_dense(
                q, pk8, pv8, tables, pos, sk, sv)),
            "float_kernel_ms": time_ms(lambda: paged_attention(
                q, pk_f, pv_f, tables, pos)),
            "float_kernel_err": f_err,
            "bound_ms": bound, "bound_by": by,
            "live_pages": len(live), "bytes": nbytes,
        }
    return out


# ---------------------------------------------------------------- phase 17
SPEC_K = 4
# the bf16 gap rule: two runs of one greedy decode in bf16 may first
# differ where the reference run's top-2 gap is below this many bf16
# ULPs of its top logit.  The logits are bf16 values (the head's product
# is rounded to bf16 before the f32 cast), so each logit carries half a
# ULP of rounding, and the hidden state entering the head carries the
# bf16 roundoff of 12 layers' products and residual sums taken in
# another order (cuBLAS picks its kernel by the row count: 8 rows a
# step, 40 a verify): a flip inside a few ULPs is that roundoff, a wrong
# token anywhere else is not.
GAP_ULPS_BF16 = 4


def _gap_bound(logits, dtype) -> float:
    """The largest top-2 gap at which two greedy runs of a net in
    ``dtype`` may order its top two logits differently: PARITY_GAP in
    f32, else GAP_ULPS_BF16 ULPs of bf16 at the top logit."""
    if dtype == torch.float32:
        return PARITY_GAP
    top = max(abs(float(logits.max())), 1e-30)
    return GAP_ULPS_BF16 * 2.0 ** (math.floor(math.log2(top)) - 7)


def check_gap_rule(net, prompts, want, got, tag, kv_dtype=None) -> int:
    """``got`` against the reference run ``want``, prompt by prompt:
    token-equal, or first different at a token where the reference's
    top-2 gap (the engine's chunk logits after the common prefix) is
    below `_gap_bound`.  Returns the number of token-equal prompts."""
    dtype = net.embed.weight.dtype
    n_equal = 0
    for p, w, g in zip(prompts, want, got):
        assert len(w) == len(g), (tag, len(w), len(g))
        if w == g:
            n_equal += 1
            continue
        i = next(j for j in range(len(w)) if w[j] != g[j])
        logits = _chunk_logits(net, np.concatenate([p, w[:i]]), kv_dtype)
        top2 = logits.topk(2).values
        gap, bound = float(top2[0] - top2[1]), _gap_bound(logits, dtype)
        assert gap < bound, (
            f"{tag}: runs differ at token {i} of a {len(p)}-token prompt "
            f"where the reference's top-2 gap is {gap} (bound {bound})")
        log(f"{tag}: prompt {len(p)} first differs at token {i}, top-2 gap "
            f"{gap:.3e} < {bound:.3e}")
    return n_equal


class _SpecCalls:
    """Counts the paged-attention calls of speculative engines on their
    layer-0 pools (target: verify windows of B·(k+1) rows and chunks;
    draft: steps of B rows and chunks) and keeps the inputs of the
    verify call with the most active lanes, the pools as they stood
    then (the callback runs on the scheduler thread, so the engine's
    host lane state is that of the call)."""

    def __init__(self, B, k):
        self.rows = (B * (k + 1), B)
        self.engines = []
        self.n = dict(verify=0, chunk=0, draft=0, draft_chunk=0)
        self.kept, self.kept_active = None, 0

    def watch(self, eng):
        pg = eng._programs
        self.engines.append((eng, pg.pool_k[0], pg.dpool_k[0]))
        return eng

    def __call__(self, args, kw):
        q, pk = args[0], args[1]
        for eng, target, draft in self.engines:
            if pk is target:
                kind = "verify" if q.shape[0] == self.rows[0] else "chunk"
            elif pk is draft:
                kind = "draft" if q.shape[0] == self.rows[1] else \
                    "draft_chunk"
            else:
                continue
            self.n[kind] += 1
            active = int(eng._active.sum())
            if kind == "verify" and active > self.kept_active:
                self.kept = ([a.clone() for a in args[:5]], dict(kw))
                self.kept_active = active


def _spec_window(calls, run):
    """Drive ``run()`` with every serving kernel's count set to 0 just
    before and read just after; returns (run's result, launches)."""
    for name in SERVING_KERNELS:
        KERNELS[name]["fn"].launches = 0
    with recording(prog_mod, "paged_attention", calls):
        out = run()
    torch.cuda.synchronize()
    return out, {name: KERNELS[name]["fn"].launches
                 for name in SERVING_KERNELS}


def _assert_spec_launches(launches, calls, iters, L, k, kv8, tag):
    """Each iteration runs k draft steps and one verify, each chunk a
    target and a draft chunk, each one launch a layer; the verify and
    the target chunks take the int8-page kernel over an int8 pool, the
    draft always the float one; no flash launch."""
    n = calls.n
    assert n["verify"] == iters and n["draft"] == k * iters \
        and n["draft_chunk"] == n["chunk"] > 0, (tag, n, iters)
    target = L * (iters + n["chunk"])
    draft = L * (k * iters + n["draft_chunk"])
    want = {"paged_attention": draft + (0 if kv8 else target),
            "paged_attention_q8": target if kv8 else 0,
            "flash_attention": 0}
    assert launches == want, (tag, launches, want, n, iters)
    if not kv8:
        assert launches["paged_attention"] == \
            L * (k * iters + iters + 2 * n["chunk"])


def check_verify_rows(kept, k) -> dict:
    """A recorded layer-0 verify call: one launch over B·(k+1) rows
    against k+1 launches of the B rows at pos+j (the JAX package's
    verify shape) on the pools as they stood, bit for bit, and against
    the plain version."""
    (q, pk, pv, tables, pos), _ = kept
    T = k + 1
    full = paged_attention(q, pk, pv, tables, pos)
    equal = all(torch.equal(
        full[j::T],
        paged_attention(q[j::T].contiguous(), pk, pv,
                        tables[j::T].contiguous(), pos[j::T].contiguous()))
        for j in range(T))
    err = (full.float() - paged_attention_dense(q, pk, pv, tables, pos)
           .float()).abs().max().item()
    assert equal, "verify rows differ from k+1 launches of B rows"
    assert err <= TOL[q.dtype], f"paged at the verify's inputs: err {err}"
    return {"rows": q.shape[0], "pos": pos[::T].tolist(), "bit_equal": equal,
            "max_abs_err": err}


def probe_dense_rows(net, rows=(8, 40)) -> dict:
    """The decode products at the main path's row counts: 8 rows alone
    (a step) and the same 8 rows inside 40 (a verify window), through
    `_dense`, bf16: whether cuBLAS gives them the same bits."""
    lyr = net._layers[0]
    g = torch.Generator().manual_seed(9)
    out = {}
    for name, d in (("qkv", lyr.attn.qkv), ("proj", lyr.attn.proj),
                    ("ffn1", lyr.ffn.ffn_dense1), ("ffn2", lyr.ffn.ffn_dense2),
                    ("head", net.head)):
        x = torch.randn((rows[1], d.weight.shape[1]), generator=g).to(
            DEV, d.weight.dtype)
        small = gen_mod._dense(x[:rows[0]], d.weight, d.bias)
        big = gen_mod._dense(x, d.weight, d.bias)[:rows[0]]
        out[name] = {"bit_equal": bool(torch.equal(small, big)),
                     "max_abs_diff": (small.float() - big.float()).abs()
                     .max().item()}
    return out


def phase_spec_path(smi: str, res) -> dict:
    """Speculative decoding at full width: phase 4's bf16 net with
    `quantize_for_decode` as its own int8 draft (k = 4), float target
    weights; phase 4's traffic on a speculative engine, a profiled solo
    request, the same over the int8 KV pool, and a sampled run
    (temperature 1.0, top_k 50); each held to its non-speculative
    engine by the gap rule and its launches counted in its own
    window."""
    net, prompts = res["net"], res["prompts"]
    V, L, k, B = MODEL["vocab"], MODEL["num_layers"], SPEC_K, 8
    net.quantize_for_decode()
    assert net._decode_quant.act_quant == "none"

    def engine(**kw):
        return ServingEngine(net, max_batch=B, block_size=16,
                             prefill_chunk=32, quantized=False, **kw)

    def spec_stats(eng):
        return eng.stats()["speculate"]

    # -- greedy over float pages: the burst and a profiled solo --------
    calls = _SpecCalls(B, k)

    def greedy_run():
        with calls.watch(engine(speculate_k=k)) as eng:
            assert eng.path == "float"
            burst = _burst(eng, prompts)
            st = eng.stats()
        with calls.watch(engine(speculate_k=k)) as solo_eng:
            solo_eng.submit(prompts[0][:40], 2).result(timeout=300)
            s0 = spec_stats(solo_eng)["steps"]
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                solo = solo_eng.submit(prompts[5], 32).result(timeout=600)
                torch.cuda.synchronize()
                solo_s = time.perf_counter() - t0
            solo_iters = spec_stats(solo_eng)["steps"] - s0
            iters = st["speculate"]["steps"] + spec_stats(solo_eng)["steps"]
        return burst, st, solo, solo_s, solo_iters, prof, iters

    (burst, st, solo, solo_s, solo_iters, prof, iters), launches = \
        _spec_window(calls, greedy_run)
    toks, dup_toks, dup, spec_s, reqs = burst
    _assert_spec_launches(launches, calls, iters, L, k, False, "spec")
    for t in toks + [dup_toks]:
        assert len(t) == 32 and all(0 <= x < V for x in t)
    assert dup.cached_tokens > 0, "the second submission missed"
    assert dup_toks == toks[1], "speculative prefix-cache hit differs"
    assert solo == toks[5], "speculative solo run differs from co-batched"
    sp = st["speculate"]
    assert sp["draft"] == "self-int8" and sp["greedy"], sp
    busy = device_busy(prof, solo_s)
    solo_chunks = -(-len(prompts[5]) // 32)
    verify_rows = check_verify_rows(calls.kept, k)
    dense_rows = probe_dense_rows(net)

    # the non-speculative float engine on the same net and traffic
    with engine() as eng:
        ftoks, _, _, float_s, freqs = _burst(eng, prompts)
    eq_float = check_gap_rule(net, prompts, ftoks, toks,
                              "speculative vs non-speculative (bf16)")

    # -- greedy over int8 pages --------------------------------------
    calls8 = _SpecCalls(B, k)

    def kv8_run():
        with calls8.watch(engine(speculate_k=k, kv_dtype="int8")) as eng:
            out = _burst(eng, prompts)
            return out, eng.stats()

    (burst8, st8), launches8 = _spec_window(calls8, kv8_run)
    toks8, dup8, dupreq8, _, _ = burst8
    _assert_spec_launches(launches8, calls8, st8["speculate"]["steps"], L, k,
                          True, "kv8 spec")
    assert dupreq8.cached_tokens > 0 and dup8 == toks8[1]
    with engine(kv_dtype="int8") as eng:
        want8 = _burst(eng, prompts)[0]
    eq_kv8 = check_gap_rule(net, prompts, want8, toks8,
                            "kv8 speculative vs kv8 non-speculative (bf16)",
                            kv_dtype="int8")

    # -- sampled: temperature 1.0, top_k 50 ---------------------------
    callss = _SpecCalls(B, k)

    def sampled_run():
        with callss.watch(engine(speculate_k=k, temperature=1.0,
                                 top_k=50)) as eng:
            reqs_s = [eng.submit(p, 32, seed=i)
                      for i, p in enumerate(prompts)]
            return [r.result(timeout=600) for r in reqs_s], eng.stats()

    (stoks, sst), launchess = _spec_window(callss, sampled_run)
    _assert_spec_launches(launchess, callss, sst["speculate"]["steps"], L, k,
                          False, "sampled spec")
    for t in stoks:
        assert len(t) == 32 and all(0 <= x < V for x in t)
    ssp = sst["speculate"]
    assert not ssp["greedy"] and ssp["rollback"].get("rejected", 0) >= 1, ssp
    net.dequantize_decode()

    n_tok = sum(len(r.tokens) for r in reqs)
    out = {
        "spec_tok_s": n_tok / spec_s,
        "float_tok_s": sum(len(r.tokens) for r in freqs) / float_s,
        "accept_rate": sp["accept_rate"], "steps": sp["steps"],
        # tokens a lane emits a verify: the verifies' tokens (all but
        # each request's first) over the lane-iterations (proposed / k)
        "tokens_per_verify": (n_tok - len(reqs)) * k / sp["proposed"],
        "ttft_p50_s": _p50(reqs, "ttft"), "tpot_p50_s": _p50(reqs, "tpot"),
        "rollback": sp["rollback"], "busy": busy,
        "kernels_per_iteration": busy["kernels"] / (solo_iters
                                                    + solo_chunks),
        "verify_rows": verify_rows, "dense_rows": dense_rows,
        "launches": {n: launches[n] + launches8[n] + launchess[n]
                     for n in SERVING_KERNELS},
        "kv8_accept_rate": st8["speculate"]["accept_rate"],
        "sampled_accept_rate": ssp["accept_rate"],
        "equal": {"float": eq_float, "kv8": eq_kv8},
    }
    log(f"speculative path [{smi}]: self-int8 draft k={k}; {n_tok} tokens "
        f"over {len(reqs)} requests in {spec_s:.3f} s "
        f"({out['spec_tok_s']:.1f} decoded tok/s) against the float "
        f"engine's {out['float_tok_s']:.1f} in {float_s:.3f} s "
        f"({out['spec_tok_s'] / out['float_tok_s']:.3f}x); accept rate "
        f"{sp['accept_rate']:.4f} over {sp['proposed']} proposals, "
        f"{out['tokens_per_verify']:.3f} tokens a lane a verify, "
        f"{sp['steps']} verifies; TTFT p50 {out['ttft_p50_s'] * 1e3:.1f} "
        f"ms, TPOT p50 {out['tpot_p50_s'] * 1e3:.2f} ms; rollback "
        f"{sp['rollback']}; token-equal to the non-speculative engine "
        f"{eq_float}/{len(prompts)}; launches {launches} = {L} x ({k} x "
        f"{iters} + {iters} + 2 x {calls.n['chunk']})")
    log(f"speculative solo request ({len(prompts[5])}-token prompt, 32 "
        f"tokens: {solo_chunks} chunks, {solo_iters} iterations) under the "
        f"profiler [{smi}]: {solo_s:.3f} s wall, card busy "
        f"{busy['busy_s']:.4f} s = {busy['busy_share']:.3f} of the wall "
        f"(idle {1 - busy['busy_share']:.3f}), {busy['kernels']} kernels "
        f"({out['kernels_per_iteration']:.0f} a scheduler iteration); paged "
        f"kernel {_paged_ms(busy):.3f} ms; device ms by kernel: "
        + "; ".join(f"{n} {ms:.3f}" for n, ms in busy["top"]))
    log(f"speculative kv8 [{smi}]: accept rate "
        f"{out['kv8_accept_rate']:.4f}, token-equal to the kv8 engine "
        f"{eq_kv8}/{len(prompts)}, launches {launches8}; sampled (T=1.0, "
        f"top_k 50): accept rate {ssp['accept_rate']:.4f}, rollback "
        f"{ssp['rollback']}, launches {launchess}")
    log(f"verify rows [{smi}]: {json.dumps(verify_rows)}; decode products "
        f"at 8 rows alone and inside 40 (bf16): {json.dumps(dense_rows)}")
    return out


# ---------------------------------------------------------------- phase 18
BEAM = dict(B=2, P=128, N=32, K=4)
# the beam's score against lm_score: each of the N terms is a bf16
# pipeline's log-probability, the two taken through different attention
# (flash prefill against cached decode), so their sum may differ by a
# bf16 rounding (2^-7 relative) of the sum of the terms' magnitudes
BEAM_SCORE_RTOL = 2.0 ** -7


def phase_beam(smi: str, res) -> dict:
    """`lm_beam_search` at full width in bf16 on phase 4's net: B=2,
    P=128, N=32, K=4, and K=1 held to `generate` by the gap rule; the
    scores sorted, the best beam's score equal to the sum of `lm_score`
    over its tokens within BEAM_SCORE_RTOL, one flash launch a layer a
    call and no paged launch."""
    net = res["net"]
    B, P, N, K = BEAM["B"], BEAM["P"], BEAM["N"], BEAM["K"]
    L, V = MODEL["num_layers"], MODEL["vocab"]
    prompt = res["prompt"][:B, :P]
    net.beam_search(prompt[:, :8], 2, beam_size=K)          # warm-up
    for name in SERVING_KERNELS:
        KERNELS[name]["fn"].launches = 0
    seqs1, _ = net.beam_search(prompt, N, beam_size=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seqs, scores = net.beam_search(prompt, N, beam_size=K)
    torch.cuda.synchronize()
    beam_s = time.perf_counter() - t0
    launches = {name: KERNELS[name]["fn"].launches
                for name in SERVING_KERNELS}
    assert launches == {"flash_attention": 2 * L, "paged_attention": 0,
                        "paged_attention_q8": 0}, launches
    assert seqs.shape == (B, K, P + N) and seqs.dtype == torch.int32
    assert scores.shape == (B, K) and torch.isfinite(scores).all()
    assert torch.equal(seqs[:, :, :P].long(), prompt[:, None].expand(B, K, P))
    assert int(seqs.min()) >= 0 and int(seqs.max()) < V
    assert (scores[:, :-1] >= scores[:, 1:]).all(), "beams not sorted"
    gen = net.generate(prompt, N)
    prompts = [p.cpu().numpy().astype(np.int32) for p in prompt]
    eq = check_gap_rule(net, prompts, [g[P:].tolist() for g in gen],
                        [s[0, P:].tolist() for s in seqs1],
                        "beam_size=1 vs generate (bf16)")
    logp = net.score(seqs[:, 0])[:, P - 1:].float()          # (B, N)
    oracle = logp.sum(dim=1)
    err = (oracle - scores[:, 0].float()).abs()
    bound = BEAM_SCORE_RTOL * logp.abs().sum(dim=1)
    assert (err <= bound).all(), (err.tolist(), bound.tolist())
    log(f"beam search [{smi}]: B={B} P={P} N={N} K={K} bf16 in "
        f"{beam_s:.3f} s ({B * K * N / beam_s:.1f} beam tokens/s); best "
        f"scores {scores[:, 0].tolist()} against lm_score sums "
        f"{oracle.tolist()} (|err| {err.tolist()} <= {bound.tolist()}); "
        f"beam_size=1 token-equal to generate {eq}/{B}; launches {launches}")
    return {"beam_s": beam_s, "launches": launches, "score_err": err.tolist()}


# ---------------------------------------------------------------- phase 19
def phase_spec_parity() -> dict:
    """At full width, 2 layers, f32: the self-drafted speculative engine
    through the kernels against the same engine on the plain versions,
    and against the non-speculative engine, each by the gap rule."""
    net = _build_net(torch.float32, 2, seed=1)
    rs = np.random.RandomState(3)
    prompts = [rs.randint(0, MODEL["vocab"], (n,)).astype(np.int32)
               for n in (40, 77, 130, 200)]
    net.quantize_for_decode()

    def run(**kw):
        with ServingEngine(net, max_batch=4, block_size=16, prefill_chunk=32,
                           quantized=False, **kw) as eng:
            reqs = [eng.submit(p, 16) for p in prompts]
            return [r.result(timeout=600) for r in reqs], eng.stats()

    n0 = paged_attention.launches
    got_k, st = run(speculate_k=SPEC_K)
    n1 = paged_attention.launches
    with plain_kernels():
        got_p, _ = run(speculate_k=SPEC_K)
    assert n1 > n0 and paged_attention.launches == n1, (n0, n1)
    eq_plain = check_gap_rule(net, prompts, got_p, got_k,
                              "speculative kernels vs plain (f32)")
    got_n, _ = run()
    eq_nonspec = check_gap_rule(net, prompts, got_n, got_k,
                                "speculative vs non-speculative (f32)")
    net.dequantize_decode()
    log(f"speculative parity (f32, 2 layers, width {MODEL['units']}): "
        f"kernels vs plain {eq_plain}/{len(prompts)} prompts token-equal, "
        f"vs non-speculative {eq_nonspec}/{len(prompts)} over 16 tokens; "
        f"accept rate {st['speculate']['accept_rate']:.4f}")
    return {"kernel_vs_plain": eq_plain, "vs_nonspec": eq_nonspec}


# ---------------------------------------------------------------- phase 20
def _same(a, b) -> bool:
    """Bit equality of two program results (tensors, arrays, ints,
    None, and tuples of them)."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.shape == b.shape \
            and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and np.array_equal(a, b)
    if isinstance(a, (tuple, list)):
        return isinstance(b, (tuple, list)) and len(a) == len(b) \
            and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def _pool_tensors(progs):
    return [*progs.pool_k, *progs.pool_v, *progs.scale_k, *progs.scale_v,
            *progs.dpool_k, *progs.dpool_v]


def check_program_bits(progs, kind, call) -> int:
    """Program ``kind`` of ``progs`` through ``call()`` on one pool
    content three times: on its eager body (`_graphs.eager`), at its
    capture (the warm-up's result) and at a replay.  The replay's
    outputs (the logits, or a chunk's hidden states), its result
    (tokens) and the pools it leaves must equal the eager body's bit for
    bit.  Returns the number of output tensors compared."""
    pools = _pool_tensors(progs)
    snap = [p.clone() for p in pools]
    prog = progs.programs[kind]

    def restore():
        for p, s in zip(pools, snap):
            p.copy_(s)

    with _graphs.eager():
        want = call()
    want_out = [t.clone() for t in prog.last]
    want_pools = [p.clone() for p in pools]
    restore()
    first = call()                          # capture; its warm-up's result
    restore()
    n = _graphs.replays[prog.name]
    got = call()
    torch.cuda.synchronize()
    assert prog.captured and _graphs.replays[prog.name] > n, kind
    assert _same(first, want), f"{prog.name}: the capture call differs"
    assert _same(got, want), f"{prog.name}: replayed result differs"
    assert _same(list(prog.last), want_out), \
        f"{prog.name}: replayed outputs differ from the eager body's"
    assert all(torch.equal(p, q) for p, q in zip(pools, want_pools)), \
        f"{prog.name}: replayed pool writes differ"
    return len(want_out)


def _program_inputs(B, nbps, bs, V, seed):
    """Lane inputs at full width: distinct block tables, positions from
    5 to 500, lane 4 idle (scratch tables)."""
    rs = np.random.RandomState(seed)
    tables = (1 + np.arange(B * nbps, dtype=np.int32)).reshape(B, nbps)
    pos = np.array([37, 100, 255, 300, 5, 64, 128, 500][:B], np.int32)
    active = np.ones(B, bool)
    active[4] = False
    tables[4] = 0
    toks = rs.randint(0, V, (B,)).astype(np.int32)
    return tables, toks, pos, active, np.arange(B, dtype=np.int64) + seed


def _fill_pools(progs, seed):
    """Random pool contents: bf16 pages of K/V-like values, int8 pages
    with scales of 0.01-0.05."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    for p in (*progs.pool_k, *progs.pool_v, *progs.dpool_k, *progs.dpool_v):
        if p.dtype == torch.int8:
            p.copy_(torch.randint(-127, 128, p.shape, generator=g,
                                  device=DEV, dtype=torch.int8))
        else:
            p.copy_(torch.randn(p.shape, generator=g, device=DEV))
    for s in (*progs.scale_k, *progs.scale_v):
        s.copy_(0.01 + 0.04 * torch.rand(s.shape, generator=g, device=DEV))


GRAPH_GEN = dict(B=8, P=128, N=32)
GRAPH_PROGRAM_CASES = (
    ("float greedy", dict()),
    ("float sampled", dict(temperature=1.0, top_k=50)),
    ("kv8 greedy", dict(kv_dtype="int8")),
    ("kv8 sampled", dict(kv_dtype="int8", temperature=1.0, top_k=50)),
    ("spec greedy", dict(speculate_k=SPEC_K)),
    ("spec sampled", dict(speculate_k=SPEC_K, temperature=1.0, top_k=50)),
    ("spec kv8 greedy", dict(speculate_k=SPEC_K, kv_dtype="int8")),
)


def time_step_host(progs, tables, toks, pos, active, n=50) -> dict:
    """Host ms of the parts of a greedy ``PagedPrograms.step`` call on
    its captured graph, mean of ``n``: the weight fingerprint and gather,
    the slots, the staging, the replay's launch, and the sync that waits
    out the card; and the card ms of one replay by CUDA events."""
    prog = progs.programs["step"]
    parts = np.zeros(5)
    for _ in range(n):
        t0 = time.perf_counter()
        progs.gather_params()
        t1 = time.perf_counter()
        slots = progs._slots(tables, pos, active)
        t2 = time.perf_counter()
        prog._stage(dict(toks=toks, **slots))
        t3 = time.perf_counter()
        prog._graph.replay()
        t4 = time.perf_counter()
        prog._out[1].cpu()
        parts += np.diff([t0, t1, t2, t3, t4, time.perf_counter()])
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(n):
        prog._graph.replay()
    e1.record()
    torch.cuda.synchronize()
    out = dict(zip(("gather", "slots", "stage", "launch", "sync"),
                   (parts * 1e3 / n).tolist()))
    out["replay_card"] = e0.elapsed_time(e1) / n
    return out


def phase_graph_programs(res) -> dict:
    """Every serving program at full width (phase 4's 12-layer bf16
    net, 8 lanes, block 16, 32 blocks a lane), captured and replayed
    against its eager body on the same inputs and pool contents:
    step and prefill chunk over float and int8 pages, greedy and
    sampled; the speculative draft step, draft chunk and verify over
    float and int8 pages, greedy and sampled (self-int8 draft)."""
    net = res["net"]
    V, bs, msl, B = MODEL["vocab"], 16, MODEL["max_len"], 8
    nbps = msl // bs
    net.quantize_for_decode()
    out = {}
    for ci, (tag, kw) in enumerate(GRAPH_PROGRAM_CASES):
        progs = PagedPrograms(net, max_batch=B, block_size=bs,
                              blocks_per_seq=nbps, num_blocks=B * nbps + 1,
                              prefill_chunk=32, quantized=False,
                              **dict(dict(temperature=0.0, top_k=0), **kw))
        _fill_pools(progs, seed=ci)
        tables, toks, pos, active, seeds = _program_inputs(B, nbps, bs, V,
                                                           seed=ci)
        ctoks = np.random.RandomState(ci).randint(0, V, (32,)).astype(
            np.int32)
        n = {}
        if not progs.speculate_k:
            n["step"] = check_program_bits(
                progs, "step",
                lambda: progs.step(tables, toks, pos, active, seeds))
            n["prefill_chunk"] = check_program_bits(
                progs, "prefill_chunk",
                lambda: progs.prefill_chunk(tables[0], ctoks, 32, 50, 3,
                                            True))
        else:
            n["draft_prefill_chunk"] = check_program_bits(
                progs, "draft_prefill_chunk",
                lambda: progs.draft_prefill_chunk(tables[0], ctoks, 32, 50))
            n["draft_step"] = check_program_bits(
                progs, "draft_step",
                lambda: progs.draft_step(tables, toks, pos, active, seeds))
            with _graphs.eager():
                d_toks, q = progs.draft_step(tables, toks, pos, active,
                                             seeds)
            n["spec_verify"] = check_program_bits(
                progs, "spec_verify",
                lambda: progs.spec_verify(tables, toks, pos, active, seeds,
                                          d_toks, q))
        if tag == "float greedy":
            host = time_step_host(progs, tables, toks, pos, active)
        out[tag] = n
        del progs
    net.dequantize_decode()
    log("graphed programs at full width (12 layers, bf16, 8 lanes): "
        "replays bit-identical to the eager bodies (outputs, results, "
        "pools): " + json.dumps(out))
    log("a graphed float step's host ms, mean of 50 calls: " + "; ".join(
        f"{k} {v:.3f}" for k, v in host.items() if k != "replay_card")
        + f"; one replay on the card {host['replay_card']:.3f} ms")
    return {"bits": out, "host": host}


def _timed_burst(eng, prompts):
    toks, dup_toks, dup, s, reqs = _burst(eng, prompts)
    n_tok = sum(len(r.tokens) for r in reqs)
    return {"toks": toks + [dup_toks], "tok_s": n_tok / s, "s": s,
            "ttft_p50_s": _p50(reqs, "ttft"),
            "tpot_p50_s": _p50(reqs, "tpot"), "hit": dup.cached_tokens > 0}


def _profiled_solo(eng, prompt, warm):
    """A solo request on ``eng`` under the profiler, after a warm-up
    request ``warm`` of another prompt (no prefix hit): wall, replays,
    card busy share, kernels and wall and card idle time a scheduler
    iteration (chunks plus decode iterations)."""
    eng.submit(warm, 2).result(timeout=300)
    s0 = eng.stats()["steps"]
    r0 = sum(_graphs.replays.values())
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        toks = eng.submit(prompt, 32).result(timeout=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    iters = eng.stats()["steps"] - s0 + -(-len(prompt) // 32)
    replays = sum(_graphs.replays.values()) - r0
    # the same work without the profiler's host cost: a prompt of the
    # same length that shares no block with the first
    other = ((prompt.astype(np.int64) + 1) % MODEL["vocab"]).astype(np.int32)
    t0 = time.perf_counter()
    eng.submit(other, 32).result(timeout=600)
    quiet = time.perf_counter() - t0
    events = prof.events()
    kern = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = device_busy(prof, wall) if kern else None
    return {"toks": toks, "wall_s": wall, "iterations": iters,
            "replays": replays,
            "graph_launches": sum("GraphLaunch" in e.name for e in events),
            "wall_ms_per_iteration": wall * 1e3 / iters,
            "unprofiled_ms_per_iteration": quiet * 1e3 / iters,
            # the card waits on the host between a step's sync and the
            # next launch: its idle time a iteration is the host's share
            "idle_ms_per_iteration": busy and (wall - busy["busy_s"])
            * 1e3 / iters,
            "busy_s": busy and busy["busy_s"],
            "busy_share": busy and busy["busy_share"],
            "kernels": busy and busy["kernels"],
            "kernels_per_iteration": busy and busy["kernels"] / iters,
            "top": busy and busy["top"][:4]}


ENGINE_CASES = (
    ("float", dict(), ("serving_step", "serving_prefill_chunk")),
    ("kv8", dict(kv_dtype="int8"),
     ("serving_step_kv8", "serving_prefill_chunk_kv8")),
    ("spec", dict(speculate_k=SPEC_K, quantized=False),
     ("serving_draft_step", "serving_draft_prefill_chunk",
      "serving_spec_verify", "serving_prefill_chunk")),
)


def _quantize_for(net, tag):
    """Phase 14's int8 weights for the kv8 engine, the self-int8 draft
    for the speculative one, float weights otherwise."""
    if tag in ("kv8", "spec"):
        net.quantize_for_decode()
    else:
        net.dequantize_decode()


def phase_graph_path(smi: str, res) -> dict:
    """The serving main path on graphs at full width (phase 4's net):
    the float, kv8 and self-drafted k=4 engines, each over phase 4's
    burst (the float one also ``generate`` B=8 P=128 N=32 and a
    profiled solo request), first on the eager bodies and then on
    graphs: every lane's tokens equal, exactly one capture per program
    per engine under a RetraceGuard, and each engine's serving kernels'
    launches counted from 0 (direct launches plus replays x launches a
    replay); timings graphed against eager in this run."""
    net, prompt, prompts = res["net"], res["prompt"], res["prompts"]
    B, P, N = GRAPH_GEN["B"], GRAPH_GEN["P"], GRAPH_GEN["N"]
    prompt = prompt[:B, :P]

    def engine(**kw):
        return ServingEngine(net, max_batch=8, block_size=16,
                             prefill_chunk=32, **kw)

    def timed_generate():
        net.generate(prompt, N)             # capture (eager: warm-up)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = net.generate(prompt, N)
        torch.cuda.synchronize()
        return out, B * N / (time.perf_counter() - t0)

    eager = {}
    with _graphs.eager():
        want_gen, eager["generate_tok_s"] = timed_generate()
        for tag, kw, _ in ENGINE_CASES:
            _quantize_for(net, tag)
            with engine(**kw) as eng:
                eager[tag] = _timed_burst(eng, prompts)
            if tag == "float":
                with engine(**kw) as eng:
                    eager["solo"] = _profiled_solo(eng, prompts[5],
                                                   prompts[0][:40])
    graphed, captures = {}, {}
    launches = {n: 0 for n in SERVING_KERNELS}
    replayed = dict(launches)
    for tag, kw, names in ENGINE_CASES:
        _quantize_for(net, tag)
        # the counts start from 0 here and are read right after
        for name in SERVING_KERNELS:
            KERNELS[name]["fn"].launches = 0
        _graphs.reset_counts()
        runs = [("burst", lambda eng: _timed_burst(eng, prompts))]
        if tag == "float":
            got_gen, graphed["generate_tok_s"] = timed_generate()
            assert torch.equal(got_gen, want_gen), "generate: graphed"
            runs.append(("solo", lambda eng: _profiled_solo(
                eng, prompts[5], prompts[0][:40])))
        for what, run in runs:
            with RetraceGuard(budget=1, watch=PROGRAM_NAMES) as guard:
                with engine(**kw) as eng:
                    graphed[tag if what == "burst" else what] = run(eng)
                    progs = eng._programs.programs
            per = sorted(p.name for p in progs.values() if p.captured)
            assert per == sorted(names), (tag, what, per)
            assert dict(guard.counts) == {n: 1 for n in names}, \
                (tag, what, dict(guard.counts))
            captures[f"{tag} {what}"] = dict(guard.counts)
        torch.cuda.synchronize()
        window = {n: _graphs.launches(KERNELS[n]["fn"])
                  for n in SERVING_KERNELS}
        for n in SERVING_KERNELS:
            launches[n] += window[n]
            replayed[n] += _graphs.replayed_launches[KERNELS[n]["fn"]]
        paged = "paged_attention_q8" if tag == "kv8" else "paged_attention"
        assert window[paged] > 0 and \
            _graphs.replayed_launches[KERNELS[paged]["fn"]] > 0, \
            (tag, window)
        if tag == "float":
            assert _graphs.replayed_launches[_fa_fn] > 0, "flash replays"
        assert graphed[tag]["toks"] == eager[tag]["toks"], \
            f"{tag} engine: graphed tokens differ from the eager bodies'"
        assert graphed[tag]["hit"], f"{tag}: the prefix-cache hit missed"
    net.dequantize_decode()
    assert graphed["solo"]["toks"] == eager["solo"]["toks"]
    for d in (eager, graphed):
        for tag in ("float", "kv8", "spec", "solo"):
            d[tag].pop("toks")
    out = {"eager": eager, "graphed": graphed, "launches": launches,
           "replayed_launches": replayed, "captures": captures}
    log(f"graphed main path [{smi}]: launches {launches}, of them inside "
        f"replays {replayed}; captures per engine under "
        f"RetraceGuard(budget=1): {json.dumps(captures)}")
    log(f"generate B={B} P={P} N={N} [{smi}]: graphed "
        f"{graphed['generate_tok_s']:.1f} tok/s, eager "
        f"{eager['generate_tok_s']:.1f} tok/s "
        f"({graphed['generate_tok_s'] / eager['generate_tok_s']:.2f}x); "
        f"tokens equal")
    for tag, _, _ in ENGINE_CASES:
        g, e = graphed[tag], eager[tag]
        log(f"{tag} engine, phase 4's burst [{smi}]: graphed "
            f"{g['tok_s']:.1f} decoded tok/s, TTFT p50 "
            f"{g['ttft_p50_s'] * 1e3:.1f} ms, TPOT p50 "
            f"{g['tpot_p50_s'] * 1e3:.2f} ms; eager {e['tok_s']:.1f} tok/s, "
            f"TTFT p50 {e['ttft_p50_s'] * 1e3:.1f} ms, TPOT p50 "
            f"{e['tpot_p50_s'] * 1e3:.2f} ms ({g['tok_s'] / e['tok_s']:.2f}x);"
            f" tokens equal")
    log(f"self-drafted k={SPEC_K} engine against the float engine [{smi}]: "
        f"graphed {graphed['spec']['tok_s'] / graphed['float']['tok_s']:.3f}x"
        f", eager {eager['spec']['tok_s'] / eager['float']['tok_s']:.3f}x")
    for tag, d in (("graphed", graphed["solo"]), ("eager", eager["solo"])):
        log(f"float solo request ({len(prompts[5])}-token prompt, 32 "
            f"tokens) under the profiler, {tag} [{smi}]: {d['wall_s']:.4f} s "
            f"wall, {d['iterations']} scheduler iterations, "
            f"{d['wall_ms_per_iteration']:.3f} ms of wall a iteration "
            f"({d['unprofiled_ms_per_iteration']:.3f} without the "
            f"profiler), "
            f"{d['replays']} replays ({d['graph_launches']} graph launches "
            f"seen by the profiler); card "
            + ("not measured (the profiler saw no kernel)"
               if d["busy_s"] is None else
               f"busy {d['busy_s']:.4f} s = {d['busy_share']:.3f} of the "
               f"wall, idle {d['idle_ms_per_iteration']:.3f} ms a "
               f"iteration, {d['kernels']} kernels "
               f"({d['kernels_per_iteration']:.0f} a iteration); top "
               f"{d['top']}"))
    return out


def check_decode_graphs(smi: str, res) -> dict:
    """``generate`` (greedy, sampled, eos, ``pad_to_bucket=True``) and
    ``beam_search`` at full width on graphs against their eager bodies:
    the capture call and a replay give the eager tokens (beam scores
    bit for bit); the bucketed call is also compared with the unpadded
    one."""
    net = res["net"]
    prompt = res["prompt"][:, :128]
    N = 32
    greedy = net.generate(prompt, N)
    eos = int(greedy[0, 128 + 3])
    cases = (("greedy", prompt, {}),
             ("sampled", prompt, dict(temperature=0.8, top_k=40, seed=7)),
             ("eos", prompt, dict(eos_id=eos)),
             ("bucket", prompt[:, :100], dict(pad_to_bucket=True)))
    out = {}
    for tag, p, kw in cases:
        with _graphs.eager():
            want = net.generate(p, N, **kw)
        for _ in range(2):                      # capture, then replay
            assert torch.equal(net.generate(p, N, **kw), want), tag
        out[tag] = True
    with _graphs.eager():
        unpadded = net.generate(prompt[:, :100], N)
    out["bucket_vs_unpadded"] = float((want == unpadded).float().mean())
    out["bucket_first_token"] = bool(torch.equal(want[:, 100],
                                                 unpadded[:, 100]))
    out["bucket_ops"] = probe_bucket_ops(net, prompt[:, :100], 128, N)
    bp = prompt[:BEAM["B"]]
    with _graphs.eager():
        ws, wsc = net.beam_search(bp, N, beam_size=BEAM["K"])
    for _ in range(2):
        gs, gsc = net.beam_search(bp, N, beam_size=BEAM["K"])
        assert torch.equal(gs, ws) and torch.equal(gsc, wsc), "beam"
    out["beam"] = True
    log(f"generate and beam_search on graphs [{smi}]: greedy, sampled "
        f"(T=0.8, top_k 40), eos (id {eos}), pad_to_bucket (P=100 in the "
        f"128 bucket) and beam (B={BEAM['B']} K={BEAM['K']}) equal to their "
        f"eager bodies at capture and replay; the bucketed tokens equal "
        f"the unpadded ones on {out['bucket_vs_unpadded']:.4f} of "
        f"positions (the first generated token in every row: "
        f"{out['bucket_first_token']})")
    return out


def probe_bucket_ops(net, prompt, Pp, N) -> list:
    """Where a right-padded ``generate`` first departs from the unpadded
    one in bf16: its prefill (`generation._prefill`) op by op for
    ``prompt`` (B, P) and for it padded with zeros to ``Pp``, each op's
    largest difference over the P real positions (layer 0's ops, then
    every layer's output); then the first decode step at position P
    over the caches each prefill leaves (P + N slots against Pp + N),
    layer 0's cached attention op by op over the real slots, and the
    step's logits.  Returns (op, max abs difference) in order."""
    params, _ = gen_mod._gathered(net, None)
    H = net._layers[0].attn._num_heads
    acts = tuple(lyr.ffn._act for lyr in net._layers)
    B, P = prompt.shape
    padded = torch.cat([prompt, prompt.new_zeros((B, Pp - P))], dim=1)
    ops = []

    def note(name, a, b):
        ops.append((name, float((a[:, :P].float()
                                 - b[:, :P].float()).abs().max())))

    with torch.no_grad():
        hs = [gen_mod._embed(params, t, torch.arange(
            t.shape[1], device=DEV)) for t in (prompt, padded)]
        note("embed", *hs)
        for li, (lp, act) in enumerate(zip(params["layers"], acts)):
            steps = []
            for h in hs:
                x = gen_mod._ln(h, *lp["ln1"])
                qkv = gen_mod._dense(x, *lp["qkv"])
                q, k, v = gen_mod._qkv_heads(qkv, H)
                a = fa_mod.flash_attention(
                    q.transpose(1, 2).contiguous(),
                    k.transpose(1, 2).contiguous(),
                    v.transpose(1, 2).contiguous(),
                    causal=True).transpose(1, 2)
                Tn = h.shape[1]
                proj = gen_mod._dense(a.reshape(B, Tn, -1), *lp["proj"])
                h1 = h + proj
                y = gen_mod._ln(h1, *lp["ln2"])
                f1 = gen_mod._dense(y, *lp["ffn1"])
                f2 = gen_mod._dense(gen_mod._activation(f1, act),
                                    *lp["ffn2"])
                steps.append((x, qkv, a, proj, h1, y, f1, f2, h1 + f2))
            if li == 0:
                for name, a, b in zip(("ln1", "qkv", "attention", "proj",
                                       "residual1", "ln2", "ffn1", "ffn2",
                                       "residual2"), *steps):
                    note(f"layer0.{name}", a, b)
            hs = [st[-1] for st in steps]
            note(f"layer{li}.out", *hs)
        # the first decode step over each prefill's caches
        vl = torch.tensor([P], dtype=torch.int64, device=DEV)
        runs = [gen_mod._prefill(params, prompt, acts, H, P + N),
                gen_mod._prefill(params, padded, acts, H, Pp + N,
                                 valid_len=vl)]
        toks = [gen_mod._logits_of(params, h).argmax(-1) for h, _, _ in runs]
        ops.append(("first token", float((toks[0] != toks[1]).sum())))
        lp = params["layers"][0]
        steps = []
        for (_, kcs, vcs), tok in zip(runs, toks):
            h = gen_mod._embed(params, tok, vl)
            x = gen_mod._ln(h, *lp["ln1"])
            q, k, v = gen_mod._qkv_heads(gen_mod._dense(x, *lp["qkv"]), H)
            kc, vc = kcs[0].clone(), vcs[0].clone()
            kc.index_copy_(2, vl, k[:, :, None])
            vc.index_copy_(2, vl, v[:, :, None])
            sc = torch.einsum("bhd,bhkd->bhk", q.float(), kc.float()) \
                / math.sqrt(q.shape[-1])
            pos = torch.arange(sc.shape[-1], device=DEV)
            pr = torch.softmax(torch.where(pos <= vl, sc, gen_mod._F32_MIN),
                               dim=-1)
            a = torch.einsum("bhk,bhkd->bhd", pr, vc.float())
            steps.append((sc[..., :P + 1], pr[..., :P + 1], a))
        for name, a, b in zip(("scores", "softmax", "pv"), *steps):
            ops.append((f"decode.layer0.{name}",
                        float((a.float() - b.float()).abs().max())))
        logits = [gen_mod._decode_token(params, acts, kcs, vcs, tok, vl, H)
                  for (_, kcs, vcs), tok in zip(runs, toks)]
        ops.append(("decode.logits",
                    float((logits[0] - logits[1]).abs().max())))
    first = next((n for n, d in ops if d > 0.0), None)
    log(f"pad_to_bucket in bf16, P={P} padded to {Pp}, N={N}: first op "
        f"whose real rows differ: {first}; max |padded - unpadded| by op: "
        + ", ".join(f"{n} {d:.3g}" for n, d in ops))
    return ops


def check_weight_writes(smi: str, res) -> dict:
    """After each kind of weight write the next graphed call re-gathers
    or recaptures and gives the eager tokens on the new weights:
    ``set_data`` (same storage, a new version: a re-gather, no
    recapture), an in-place write through ``param.data`` (the graph
    reads it in place), a ``cast`` round trip (new storage: a
    recapture), ``quantize_for_decode`` (the int8 copies: a new
    program), an in-place write then ``quantize_for_decode`` again (new
    int8 copies), ``dequantize_decode``; and an engine's step after a
    ``set_data``."""
    net, prompts = res["net"], res["prompts"]
    p = res["prompt"][:2, :32]
    w = net.head.weight
    w1 = net._layers[0].ffn.ffn_dense1.weight
    caps = []

    def both(tag):
        with _graphs.eager():
            want = net.generate(p, 8)
        c = sum(_graphs.captures.values())
        got = net.generate(p, 8)
        caps.append((tag, sum(_graphs.captures.values()) - c))
        assert torch.equal(got, want), f"{tag}: graphed != eager"
        return got

    base = both("first")
    w.set_data(-w.detach())
    flipped = both("set_data")
    assert not torch.equal(flipped, base), "set_data changed nothing"
    w.data.mul_(-1)
    assert torch.equal(both("param.data"), base)
    net.cast("float32")
    net.cast("bfloat16")
    assert torch.equal(both("cast round trip"), base)
    net.quantize_for_decode()
    both("quantize_for_decode")
    w8 = net._decode_quant.packed(net._layers[0].ffn.ffn_dense1)["w8"]
    w1.data.mul_(-1)
    net.quantize_for_decode()
    both("param.data + quantize_for_decode")
    w8_new = net._decode_quant.packed(net._layers[0].ffn.ffn_dense1)["w8"]
    assert torch.equal(w8_new, -w8), "the int8 copies were not re-made"
    w1.data.mul_(-1)
    net.dequantize_decode()
    assert torch.equal(both("dequantize_decode"), base)
    # an engine: its step after a set_data
    toks = []
    for mode in (_graphs.eager, contextlib.nullcontext):
        with mode():
            with ServingEngine(net, max_batch=8, block_size=16,
                               prefill_chunk=32) as eng:
                a = eng.submit(prompts[0], 8).result(timeout=300)
                w.set_data(-w.detach())
                b = eng.submit(prompts[1], 8).result(timeout=300)
                w.set_data(-w.detach())
        toks.append((a, b))
    assert toks[0] == toks[1], "engine after set_data: graphed != eager"
    log(f"weight writes [{smi}]: graphed generate equal to eager after "
        f"each, captures a call {caps}; an in-place write then "
        f"quantize_for_decode re-made the int8 copies; an engine after "
        f"set_data equal to its eager bodies")
    return {"captures": caps}


class _Owner:
    """Holds a program in a reference cycle, as an engine or a
    ``generate`` program does."""


def check_capture_during_collection(smi: str) -> dict:
    """A graph whose owner becomes garbage while another program is
    being captured is not freed during that capture (destroying a graph
    there invalidates the capture): the second program's body, at its
    capture, drops the last reference to a captured program's reference
    cycle and allocates enough to run the collector at a threshold of
    (100, 1, 1); the capture succeeds and its replay is right."""
    pool = _graphs.Pool(DEV)
    x = torch.arange(1024, dtype=torch.float32, device=DEV)
    owner = _Owner()
    owner.prog = _graphs.Program("raw_fn", lambda x: (x * 2,), pool)
    owner.prog.owner = owner
    for _ in range(2):
        owner.prog.run(0, x=x)
    assert owner.prog.captured
    keep = [owner]
    del owner
    calls = []

    def body(x):
        calls.append(len(calls))
        if len(calls) == 2:                 # the capture, not the warm-up
            keep.clear()
            [[] for _ in range(20000)]
        return (x + 1,)

    thresholds = gc.get_threshold()
    gc.set_threshold(100, 1, 1)
    try:
        prog = _graphs.Program("raw_fn", body, pool)
        prog.run(0, x=x)
        (out,) = prog.run(0, x=x)
    finally:
        gc.set_threshold(*thresholds)
    torch.cuda.synchronize()
    assert prog.captured and len(calls) == 2
    assert torch.equal(out, x + 1)
    log(f"capture during collection [{smi}]: a captured program's owner "
        f"dropped inside another capture under gc threshold (100, 1, 1); "
        f"the capture held and its replay is right")
    return {"calls": len(calls)}


def check_hybridize(smi: str) -> dict:
    """A hybridized TransformerLM (2 layers, width 1024, bf16) at T=512
    (attention through the flash kernel): the capture call and a replay
    bit-identical to the eager forward, the flash kernel launched inside
    the replay; in train mode outside ``record()`` a net with dropout
    runs on a graph whose dropout reads the staged seed table: two
    calls draw two masks, and re-seeding gives the first again."""
    net = _build_net(torch.bfloat16, 2, seed=3)
    x = torch.from_numpy(np.random.RandomState(3).randint(
        0, MODEL["vocab"], (2, 512))).to(DEV)
    want = net(x)
    net.hybridize()
    n0 = _graphs.replayed_launches[_fa_fn]
    first, again = net(x), net(x)
    torch.cuda.synchronize()
    assert torch.equal(first, want) and torch.equal(again, want)
    flash = _graphs.replayed_launches[_fa_fn] - n0
    assert flash == 2, flash
    drop = TransformerLM(**dict(MODEL, num_layers=1), dropout=0.1,
                         device=DEV, seed=3)
    drop.hybridize()
    n0 = _graphs.launches(dropout_fwd_dev)
    with autograd.train_mode():
        mx_random.seed(5, device=DEV)
        first, second = drop(x[:, :16]), drop(x[:, :16])
        mx_random.seed(5, device=DEV)
        again = drop(x[:, :16])
    torch.cuda.synchronize()
    assert not torch.equal(first, second), "a replay drew the same mask"
    assert torch.equal(first, again), "re-seeding drew another mask"
    masks = _graphs.launches(dropout_fwd_dev) - n0
    log(f"hybridize [{smi}]: TransformerLM 2x1024 bf16 at (2, 512) "
        f"captured and replayed bit-identical to eager, {flash} flash "
        f"launches inside the replay; in train mode two replays drew two "
        f"masks and re-seeding the first again ({masks} device-seed "
        f"dropout launches)")
    return {"flash_in_replay": flash}

# ---------------------------------------------------------------- phase 7
def check_dropout(dtype, shape, rate, seed) -> int:
    """The kernel's mask equals the plain Philox mask bit for bit; the
    keep fraction is within 4 sigma of 1 - rate; the same seed gives the
    same mask and another seed another.  Returns the element count."""
    x = torch.randn(shape, device=DEV).to(dtype)
    n = x.numel()
    m = dropout_mask(x, seed, rate)
    ref = mask_reference(n, seed, rate, device=DEV).view(shape)
    torch.cuda.synchronize()
    tag = f"dropout {dtype} {shape} rate={rate}"
    assert m.dtype == torch.uint8 and m.shape == x.shape, tag
    assert torch.equal(m, ref), f"{tag}: mask differs from the plain version"
    assert torch.equal(dropout_mask(x, seed, rate), m), f"{tag}: same seed"
    slot = torch.tensor([seed], dtype=torch.int64, device=DEV)
    assert torch.equal(dropout_mask_dev(x, slot, rate), m), \
        f"{tag}: the device-seed mask differs from the by-value one"
    if n >= 4096:
        keep = m.float().mean().item()
        sigma = math.sqrt(rate * (1 - rate) / n)
        assert abs(keep - (1 - rate)) <= 4 * sigma, f"{tag}: keep {keep}"
        assert not torch.equal(dropout_mask(x, seed + 1, rate), m), \
            f"{tag}: another seed gives the same mask"
    return n


def _bits(t):
    """The tensor's bit patterns: equal bits tell -0.0 from +0.0."""
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _composition(x, res, dy, mask, rate):
    """The plain site, ``[res +] where(mask, x * scale, 0)``, and its
    autograd gradients (dx, dres) for the cotangent dy."""
    xr = x.detach().clone().requires_grad_()
    rr = None if res is None else res.detach().clone().requires_grad_()
    y = dk_mod._apply_mask(xr, mask, rate)
    if rr is not None:
        y = rr + y
    grads = torch.autograd.grad(y, [t for t in (xr, rr) if t is not None],
                                dy)
    return y.detach(), grads[0], grads[1] if rr is not None else None


def check_dropout_fused(dtype, shape, rate, seed, offset=0,
                        special=False, res_dtype=None) -> int:
    """The fused forward's mask and y, and the fused backward's dx, equal
    the plain composition's bit for bit, with and without a residual,
    called directly and through ``fused_dropout(_add)``'s autograd
    Function (y, dx, dres); the device-seed forward and mask
    (``mx_dropout_fwd_dev``, ``mx_dropout_mask_dev``) give the by-value
    entries' bits, and so does the plain version given the seed tensor.
    ``offset``: x, res and dy are views that
    start that many elements into larger buffers (the kernel's scalar
    path when they leave the 16-byte grid).  ``special``: x holds NaN
    and +-Inf on dropped elements, res -0.0 on dropped and on some kept
    ones, dy NaN on dropped ones.  ``res_dtype``: res and dy in that
    dtype (f32 beside a bf16 x: the bf16 Transformer's residual stream),
    the residual form only, the direct backward given dy in x's dtype as
    autograd gives it.  Returns the number of checks."""
    n = math.prod(shape)
    g = torch.Generator().manual_seed(n + offset)
    bufs = [torch.randn(n + offset, generator=g).to(DEV, dt)
            for dt in (dtype, res_dtype or dtype, res_dtype or dtype)]
    x, res, dy = (b[offset:].view(shape) for b in bufs)
    ref_mask = mask_reference(n, seed, rate, device=DEV).view(shape)
    keep = ref_mask.bool()
    slot = torch.tensor([seed], dtype=torch.int64, device=DEV)
    if special:                     # in place: the views keep their offset
        drop = (~keep).view(-1).nonzero()[:, 0]
        kept = keep.view(-1).nonzero()[:9, 0]
        xf, rf, gf = x.view(-1), res.view(-1), dy.view(-1)
        xf[drop[0::3]] = float("nan")
        xf[drop[1::3]] = float("inf")
        xf[drop[2::3]] = -float("inf")
        rf[drop] = -0.0
        rf[kept] = -0.0
        gf[drop] = float("nan")
    tag = f"dropout fused {dtype} {shape} rate={rate} offset={offset}" \
        + (" special" if special else "")
    checks = 0
    for r in (res,) if res_dtype else (None, res):
        want_y, want_dx, want_dres = _composition(x, r, dy, ref_mask, rate)
        y, mask = dropout_fwd(x, r, seed, rate)
        dx = dropout_bwd(dy.to(dtype), mask, rate)
        torch.cuda.synchronize()
        assert mask.dtype == torch.uint8 and mask.shape == x.shape, tag
        assert torch.equal(mask, ref_mask), f"{tag}: forward's mask"
        assert torch.equal(_bits(y), _bits(want_y)), f"{tag}: y"
        assert torch.equal(_bits(dx), _bits(want_dx)), f"{tag}: dx"
        if special:
            assert not _bits(y)[~keep].any(), f"{tag}: dropped y not +0.0"
        dev_y, dev_mask = dropout_fwd_dev(x, r, slot, rate)
        plain_y, plain_mask = dropout_fwd_reference(x, r, slot, rate)
        torch.cuda.synchronize()
        assert torch.equal(dev_mask, mask) and torch.equal(plain_mask, mask), \
            f"{tag}: device-seed forward's mask"
        assert torch.equal(_bits(dev_y), _bits(y)) \
            and torch.equal(_bits(plain_y), _bits(y)), \
            f"{tag}: device-seed forward's y"
        assert torch.equal(dropout_mask_dev(x, slot, rate), ref_mask), \
            f"{tag}: device-seed mask"
        xr = x.detach().clone().requires_grad_()
        rr = None if r is None else r.detach().clone().requires_grad_()
        fy = dk_mod.fused_dropout(xr, seed, rate) if rr is None \
            else dk_mod.fused_dropout_add(xr, rr, seed, rate)
        fy.backward(dy)
        torch.cuda.synchronize()
        assert torch.equal(_bits(fy.detach()), _bits(want_y)), \
            f"{tag}: Function's y"
        assert torch.equal(_bits(xr.grad), _bits(want_dx)), \
            f"{tag}: Function's dx"
        if rr is not None:
            assert torch.equal(_bits(rr.grad), _bits(want_dres)), \
                f"{tag}: Function's dres"
        checks += 10
    return checks


def check_xent(N, V, dtype, eps, scale=1.0, seed=0) -> dict:
    """Forward (lse, row sum) and backward (dlogits) kernels against
    their plain versions on the same inputs; returns the max errors."""
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn((N, V), generator=g) * scale).to(DEV, dtype)
    labels = torch.randint(0, V, (N,), generator=g).to(DEV)
    gr = torch.rand((N,), generator=g).to(DEV)
    want_sum = eps != 0.0
    lse, xsum = xent_forward(x, want_sum)
    ref_lse, ref_sum = stats_reference(x, want_sum)
    dx = xent_backward(x, labels, ref_lse, gr, eps)
    ref_dx = dlogits_reference(x, labels, ref_lse, gr, eps)
    torch.cuda.synchronize()
    tag = f"xent ({N}, {V}) {dtype} eps={eps} scale={scale}"
    assert lse.dtype == torch.float32 and lse.shape == (N,), tag
    assert dx.dtype == dtype and dx.shape == x.shape, tag
    assert torch.isfinite(lse).all(), f"{tag}: non-finite lse"
    lse_err = ((lse - ref_lse).abs() / ref_lse.abs().clamp(min=1)).max().item()
    assert lse_err <= LSE_RTOL, f"{tag}: lse err {lse_err}"
    if want_sum:
        # a sum's rounding scales with the sum of magnitudes, not with
        # the (possibly cancelled) result
        l1 = x.float().abs().sum(-1).clamp(min=1)
        sum_err = ((xsum - ref_sum).abs() / l1).max().item()
        assert sum_err <= SUM_RTOL, f"{tag}: row-sum err {sum_err}"
    dx_err = check_dlogits(dx, ref_dx, x, labels, gr, eps, tag)
    return {"lse": lse_err, "dlogits": dx_err}


def check_dlogits(dx, ref, x, labels, g, eps, tag) -> float:
    """dlogits within `DX_TOL` of the plain version's, elementwise; a
    zeroed output and one without the softmax term (``-target·g``) must
    fail that bound on the same inputs, so the bound can tell a wrong
    kernel.  Returns the max absolute error."""
    excess = _excess(dx, ref, DX_TOL[ref.dtype])
    assert excess <= 1.0, f"{tag}: dlogits {excess:.3g}x their allowance"
    V = x.shape[-1]
    tgt = F.one_hot(labels.long(), V).float()
    if eps != 0.0:
        tgt = (1.0 - eps) * tgt + eps / V
    no_softmax = (-tgt * g.float()[:, None]).to(ref.dtype)
    for bad, what in ((torch.zeros_like(ref), "zeroed"),
                      (no_softmax, "softmax-less")):
        assert _excess(bad, ref, DX_TOL[ref.dtype]) > 1.0, \
            f"{tag}: a {what} dlogits would pass the bound"
    return (dx.float() - ref.float()).abs().max().item()


XENT_CASES = ((4096, 30522, torch.bfloat16, 0.0, 1.0),
              (4096, 30522, torch.bfloat16, 0.1, 1.0),
              (512, 30522, torch.float32, 0.0, 1.0),
              (256, 30522, torch.bfloat16, 0.0, 1e4),
              (256, 30522, torch.float32, 0.1, 1e4),
              (64, 1000, torch.float32, 0.0, 1.0),
              (64, 1000, torch.bfloat16, 0.1, 1.0),
              (33, 1001, torch.bfloat16, 0.0, 1.0),
              (9, 7, torch.float32, 0.1, 1.0))


# (shape, rate, seed, offset, special): the main path's shape at both
# rates, ragged sizes, views one element into a larger buffer, and the
# values a select must drop (NaN, Inf) or keep the sign rule of (-0.0)
DROPOUT_FUSED_CASES = (
    ((4096, 1024), 0.1, 1234567891234, 0, False),
    ((4096, 1024), 0.5, 1234567891234, 0, False),
    ((1001, 3), 0.3, 99, 0, False), ((7,), 0.3, 99, 0, False),
    ((5,), 0.3, 99, 0, False), ((1,), 0.3, 99, 0, False),
    ((4096, 1024), 0.1, 7, 1, False), ((1001, 3), 0.3, 99, 1, False),
    ((4096, 1024), 0.5, 5, 0, True), ((1001, 3), 0.5, 5, 1, True))


def phase_training_kernels() -> dict:
    errs = {"dropout_mask": {}, "dropout_fwd": {}, "dropout_bwd": {},
            "dropout_mask_dev": {}, "dropout_fwd_dev": {},
            "xent_forward": {}, "xent_backward": {}}
    checks = 0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        for rate in (0.1, 0.5):
            check_dropout(dtype, (4096, 1024), rate, seed=1234567891234)
        for shape in ((1001, 3), (7,), (5,), (1,)):
            check_dropout(dtype, shape, 0.3, seed=99)
        for shape, rate, seed, offset, special in DROPOUT_FUSED_CASES:
            checks += check_dropout_fused(dtype, shape, rate, seed, offset,
                                          special)
        for k in ("dropout_mask", "dropout_fwd", "dropout_bwd",
                  "dropout_mask_dev", "dropout_fwd_dev"):
            errs[k][name] = 0.0                   # bit-identical above
    log(f"dropout fused forward and backward: {checks} checks bit-identical "
        f"to the plain composition over {len(DROPOUT_FUSED_CASES)} cases "
        f"a dtype, the device-seed entries to the by-value ones and to "
        f"the plain version on the seed tensor")
    # degenerate rates draw no mask: no launch of any dropout kernel
    x = torch.ones((64, 64), device=DEV)
    n0 = [KERNELS[k]["fn"].launches
          for k in ("dropout_mask", "dropout_fwd", "dropout_bwd",
                    "dropout_mask_dev", "dropout_fwd_dev")]
    assert torch.equal(dk_mod.fused_dropout(x, 1, 0.0), x)
    assert torch.count_nonzero(dk_mod.fused_dropout(x, 1, 1.0)) == 0
    assert torch.equal(dk_mod.fused_dropout_add(x, x, 1, 0.0), 2 * x)
    assert torch.equal(dk_mod.fused_dropout_add(x, x, 1, 1.0), x)
    assert n0 == [KERNELS[k]["fn"].launches for k in
                  ("dropout_mask", "dropout_fwd", "dropout_bwd",
                   "dropout_mask_dev", "dropout_fwd_dev")], \
        "a degenerate rate launched"
    for N, V, dtype, eps, scale in XENT_CASES:
        e = check_xent(N, V, dtype, eps, scale)
        name = str(dtype).replace("torch.", "")
        errs["xent_forward"][name] = max(errs["xent_forward"].get(name, 0.0),
                                         e["lse"])
        errs["xent_backward"][name] = max(
            errs["xent_backward"].get(name, 0.0), e["dlogits"])
    log(json.dumps({"training_kernels": [
        {"name": k, "max_err": v} for k, v in errs.items()],
        "tol": {"dropout_mask": "bit-identical", "dropout_fwd":
                "bit-identical", "dropout_bwd": "bit-identical",
                "dropout_mask_dev": "bit-identical",
                "dropout_fwd_dev": "bit-identical",
                "xent_forward":
                f"lse rel {LSE_RTOL}", "xent_backward": {
                    str(dt).replace("torch.", ""):
                        f"rtol {r} of |ref| + atol {a} of max|ref|"
                    for dt, (r, a) in DX_TOL.items()}}}))
    return errs


# ---------------------------------------------------------------- phase 8
class PretrainWithLoss(HybridBlock):
    """bench.py's PretrainWithLoss: the net plus the MLM cross-entropy
    through the public gluon loss (the streamed cross-entropy kernels)
    and the NSP term through log_softmax."""

    def __init__(self, net):
        super().__init__()
        self.net = net
        self.mlm_loss = SoftmaxCrossEntropyLoss()

    def forward(self, tokens, labels):
        mlm_logits, nsp_logits = self.net(tokens)
        mlm = self.mlm_loss(mlm_logits, labels).mean()
        nsp_logp = nd.log_softmax(nsp_logits.float())
        return mlm - nsp_logp[:, 0].mean()


class NMTWithLoss(HybridBlock):
    """examples/nlp/train_transformer.py's step: the Transformer's logits
    for the shifted target, then the label-smoothed cross-entropy over
    the rows whose label is not ``ignore_index`` (the streamed smoothed
    cross-entropy kernels at a wide vocabulary)."""

    def __init__(self, net, smoothing=0.1):
        super().__init__()
        self.net = net
        self.loss = LabelSmoothedCELoss(smoothing)

    def forward(self, src, tgt_in, tgt_out, src_valid_length):
        return self.loss(self.net(src, tgt_in, src_valid_length), tgt_out)


class LMWithLoss(HybridBlock):
    """benchmark/longctx_bench.py's LMWithLoss: the TransformerLM's
    logits, then the cross-entropy over every position through the
    public gluon loss (the streamed cross-entropy kernels), averaged."""

    def __init__(self, net):
        super().__init__()
        self.net = net
        self.loss = SoftmaxCrossEntropyLoss()

    def forward(self, tokens, labels):
        return self.loss(self.net(tokens), labels).mean()


def _bert_batch(V, B, T, seed=0):
    g = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, V, (B, T), generator=g)
    labels = torch.randint(0, V, (B, T), generator=g)
    return tokens.to(DEV), labels.to(DEV)


def _bert_model(cfg, dtype, seed, opt=("sgd", SGD)):
    mx_random.seed(seed, device=DEV)
    net = BERTForPretraining(**cfg, dropout=DROPOUT, device=DEV)
    net.initialize()
    if dtype != torch.float32:
        net.cast(dtype)
    model = PretrainWithLoss(net)
    model.hybridize()
    trainer = Trainer(model.collect_params(), opt[0], dict(opt[1]),
                      keep_grads=False)
    return net, model, trainer


def _counts():
    """Launches so far of each training kernel, inside graph replays
    included."""
    return {n: _graphs.launches(KERNELS[n]["fn"])
            for n in TRAINING_KERNELS + FLASH_KERNELS}


def _zero_counts():
    for n in TRAINING_KERNELS + FLASH_KERNELS:
        KERNELS[n]["fn"].launches = 0
    _graphs.reset_counts()


def _per_step(L, T, hybridized=True) -> dict:
    """Launches of each kernel in one training step at sequence length
    T: flash (forward, dK/dV, dQ) once a layer where the model's
    attention takes it (at or above the 512² crossover), else never."""
    flash = L if fa_mod.kernel_active(T, T, DEV) else 0
    # each dropout site (the embedding's, two DropoutAdds a layer) is one
    # fused forward and one fused backward launch: a hybridized block's
    # recorded forward (graphed or its eager body) reads its seeds from
    # the program's seed table (the device-seed entry), a block never
    # hybridized passes them by value; the mask-only kernels are off the
    # path
    sites = 2 * L + 1
    return {"dropout_mask": 0, "dropout_mask_dev": 0,
            "dropout_fwd": 0 if hybridized else sites,
            "dropout_fwd_dev": sites if hybridized else 0,
            "dropout_bwd": sites, "xent_forward": 1,
            "xent_backward": 1, **{n: flash for n in FLASH_KERNELS}}


# phase 8's peak while step 1 held two copies of the activations
# (PERF.md), which step 1 must stay below
TWO_COPY_PEAK_GIB = 18.27
# the kernels of a recorded forward program (F, ``fwd_record``): the call
# that captures F runs them twice, its warm-up and then a replay of the
# capture for the call's result, so that the warm-up's activations are
# gone before the captured graph's exist
RECORDED_FWD = ("dropout_fwd_dev", "flash_attention", "xent_forward")


def _step_launches(per_step, fwd_captures=0, fwd=RECORDED_FWD) -> dict:
    """`per_step`, with ``fwd``'s launches once more for each capture of
    a recorded forward the step made."""
    return {n: k * (1 + fwd_captures) if n in fwd else k
            for n, k in per_step.items()}


def _fwd_captures() -> int:
    return _graphs.captures.get("fwd_record", 0)


def phase_training(smi: str, B: int, T: int) -> dict:
    L, D, V = BERT["num_layers"], BERT["units"], BERT["vocab_size"]
    t0 = time.perf_counter()
    net, model, trainer = _bert_model(BERT, torch.bfloat16, seed=0)
    tokens, labels = _bert_batch(V, B, T)
    n_params = sum(p.numel() for p in net.collect_params().values()
                   if p.grad_req != "null")
    torch.cuda.synchronize()
    log(f"training path (B={B}, T={T}): BERTForPretraining {BERT} bf16 + "
        f"f32 masters, {n_params} trainable parameters, built in "
        f"{time.perf_counter() - t0:.1f} s")
    rec = {}

    def keep_first(key):
        def keep(args, kw):
            rec.setdefault(key, _kept(args))
        return keep

    def keep_first_site(args, kw):
        # a DropoutAdd's inputs: the first call with a residual
        if args[1] is not None:
            rec.setdefault("dropout_fwd", _kept(args))

    def step():
        with autograd.record():
            loss = model(tokens, labels)
        loss.backward()
        trainer.step(1)
        return loss

    per_step = _per_step(L, T)
    torch.cuda.reset_peak_memory_stats()
    # the counts start from 0 here and are read right after the phase
    _zero_counts()
    with recording(dk_mod, "_fwd_cuda", keep_first_site), \
            recording(dk_mod, "_bwd_cuda", keep_first("dropout_bwd")), \
            recording(xk_mod, "_fwd_cuda", keep_first("fwd")), \
            recording(xk_mod, "_bwd_cuda", keep_first("bwd")), \
            recording(fa_mod, "_flash_bwd_core", keep_first("flash_bwd")):
        # step 1 by hand: which parameters it reaches, and that each moves
        before = {n: p.detach().clone()
                  for n, p in model.collect_params().items()}
        c0 = _counts()
        with autograd.record():
            loss = model(tokens, labels)
        loss.backward()
        torch.cuda.synchronize()
        # the capturing step's peak through its backward: one copy of
        # the activations
        step1_peak = torch.cuda.max_memory_allocated()
        # where the recorded backward left each gradient (read in
        # place, no copy)
        unreached = sorted(n for n, p in model.collect_params().items()
                           if p.requires_grad and p.take_grad() is None)
        t1 = time.perf_counter()
        trainer.step(1)
        torch.cuda.synchronize()
        # the update's capturing call, its host snapshot included
        update_capture_ms = (time.perf_counter() - t1) * 1e3
        # and with the update program's capture
        step1_total = torch.cuda.max_memory_allocated()
        losses = [loss.detach()]
        # a bf16 weight near 1 (a LayerNorm gain) need not move in one
        # step at lr 1e-3; its f32 master, the value of record, must
        for i, name in enumerate(before):
            st = trainer._states.get(i)
            now = st[0] if isinstance(st, tuple) else \
                trainer._params[i].detach()
            moved = not torch.equal(now.float(), before[name].float())
            if trainer._params[i].grad_req == "null" or name in unreached:
                assert not moved, f"{name} moved without a gradient"
            else:
                assert moved, f"{name} did not change in step 1"
        del before
        # bench.py's forward passes no token types: only that table is
        # left out of the graph, and the Trainer steps it with a zero
        # gradient (as the JAX package's zero-initialised gradient)
        assert unreached == ["net.bert.token_type_embed.weight"], unreached
        c1 = _counts()
        first = _step_launches(per_step, 1)
        assert all(c1[n] - c0[n] == k for n, k in first.items()), \
            (c0, c1)
        # the two-copy figure is phase 8's (T=128)
        assert T != BERT_BATCH[1] \
            or step1_total < TWO_COPY_PEAK_GIB * 2**30, \
            f"step 1 peaks at {step1_total / 2**30:.2f} GiB"
        losses.append(step().detach())                # warm-up 2
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            c0 = _counts()
            losses.append(step().detach())
            c1 = _counts()
            assert all(c1[n] - c0[n] == k for n, k in per_step.items()), \
                (c0, c1)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / 5
    launches = _counts()
    peak_bytes = torch.cuda.max_memory_allocated()
    loss_vals = torch.stack(losses).float().cpu()
    assert torch.isfinite(loss_vals).all(), f"non-finite loss {loss_vals}"
    for name, n in launches.items():
        assert n == 6 * per_step[name] + first[name], (name, n)
    # bench.py's pattern took the captured path: one capture of each
    # program, then replays (F's capturing call replays it too)
    progs = ("fwd_record", "bwd_record", "update")
    assert {k: _graphs.captures[k] for k in progs} == dict.fromkeys(progs, 1) \
        and {k: _graphs.replays[k] for k in progs} == dict(
            fwd_record=7, bwd_record=6, update=6), \
        (dict(_graphs.captures), dict(_graphs.replays))
    # one more step under the profiler: the card's busy share
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    busy = device_busy(prof, prof_s)
    snap = _snapshot_ms(trainer._updates.targets)
    n_embed = V * D + 512 * D + 2 * D
    flops_per_token = 6 * (n_params - n_embed) + 12 * L * T * D
    tok_s = B * T / dt
    # the H100 SXM's dense bf16 peak, picked by torch's device name
    name = torch.cuda.get_device_name(0)
    peak = PEAK_FLOPS[torch.bfloat16] \
        if "H100" in name and "PCIe" not in name else None
    mfu = tok_s * flops_per_token / peak if peak else None
    log(f"training main path [{smi}]: B={B} T={T}, on CUDA graphs "
        f"(captures {dict(_graphs.captures)}, replays "
        f"{dict(_graphs.replays)}), step "
        f"{dt * 1e3:.2f} ms (mean of 5 after 2 warm-up), {tok_s:.1f} "
        f"tokens/s, MFU "
        + (f"{mfu:.4f} of {peak / 1e12:.0f} TFLOP/s bf16" if mfu
           else "not measured (no peak known for this card)")
        + f" ({flops_per_token} flop/token), peak memory "
        f"{peak_bytes / 2**30:.2f} GiB (step 1, the capturing step: "
        f"{step1_peak / 2**30:.2f} GiB through its backward, "
        f"{step1_total / 2**30:.2f} GiB with the update's capture"
        + (f"; {TWO_COPY_PEAK_GIB} GiB with two copies"
           if T == BERT_BATCH[1] else "")
        + f"; the update's capturing call {update_capture_ms:.1f} ms, of "
        f"which its failure snapshot of {snap['bytes']} B to the host "
        f"takes about {snap['host_ms']:.1f} ms, where a snapshot on the "
        f"card took {snap['card_ms']:.1f} ms), losses "
        f"{loss_vals.tolist()}; launches {launches}")
    # the flash backward kernels' device time in the step (both dtypes'
    # instantiations: names carry the kernel's function name)
    bwd_ms = sum(ms for n, ms in busy["by_name"].items()
                 if "dkdv_kernel" in n or "dq_kernel" in n)
    fwd_ms = sum(ms for n, ms in busy["by_name"].items()
                 if "tc::fwd_kernel" in n or "flash_fwd_kernel" in n)
    drop_ms = sum(ms for n, ms in busy["by_name"].items()
                  if "dropout_kernel" in n)
    card_ms = busy["busy_s"] * 1e3
    log(f"one profiled training step [{smi}]: {prof_s * 1e3:.1f} ms wall, "
        f"card busy {card_ms:.1f} ms = {busy['busy_share']:.3f} "
        f"(idle {1 - busy['busy_share']:.3f}), {busy['kernels']} kernels; "
        f"dropout kernels {drop_ms:.3f} ms = {drop_ms / card_ms:.3f}, "
        f"flash forward kernel {fwd_ms:.3f} ms = {fwd_ms / card_ms:.3f} and "
        f"flash backward kernels {bwd_ms:.3f} ms = "
        f"{bwd_ms / card_ms:.3f} of the card time; "
        f"device ms by kernel: " + "; ".join(
            f"{n} {ms:.3f}" for n, ms in busy["top"]))
    return {"launches": launches, "rec": rec, "step_s": dt, "tok_s": tok_s,
            "mfu": mfu, "peak_bytes": peak_bytes, "step1_peak": step1_peak,
            "step1_total": step1_total,
            "update_capture_ms": update_capture_ms, "snapshot": snap,
            "losses": loss_vals, "busy": busy}


def _snapshot_ms(targets) -> dict:
    """Ms of the update's failure snapshot of ``targets`` as the Trainer
    takes it at a capture (to the host) and as a clone on the card, each
    once, synchronised."""
    out = {"bytes": sum(t.numel() * t.element_size() for t in targets)}
    for key, take in (("host_ms", lambda t: t.detach().to("cpu", copy=True)),
                      ("card_ms", lambda t: t.detach().clone())):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kept = [take(t) for t in targets]
        torch.cuda.synchronize()
        out[key] = (time.perf_counter() - t0) * 1e3
        del kept
    return out


# ---------------------------------------------------------------- phase 25
def _mfu(n_params, B, T, dt):
    """(tokens/s, MFU or None, flop a token): bench.py's FLOP count over
    the H100 SXM's dense bf16 peak, picked by torch's device name."""
    L, D, V = BERT["num_layers"], BERT["units"], BERT["vocab_size"]
    n_embed = V * D + 512 * D + 2 * D
    flops_per_token = 6 * (n_params - n_embed) + 12 * L * T * D
    tok_s = B * T / dt
    name = torch.cuda.get_device_name(0)
    peak = PEAK_FLOPS[torch.bfloat16] \
        if "H100" in name and "PCIe" not in name else None
    return tok_s, (tok_s * flops_per_token / peak if peak else None), \
        flops_per_token


def _captured_run(B, T, mode, smi):
    """Phase 8's model and batch, ``random.seed(7)``, three steps of
    bench.py's pattern: on graphs (``graph``), on the programs' eager
    bodies (``eager``, inside `_graphs.eager()`) or with the block never
    hybridized (``plain``).  Each step's launches are held to
    `_per_step`.  Then (not for ``plain``) five timed steps and one
    profiled step.  Returns the three losses, clones of the f32 masters
    and momenta after step 3, and the numbers."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    net, model, trainer = _bert_model(BERT, torch.bfloat16, seed=0)
    if mode == "plain":
        model.hybridize(False)
    tokens, labels = _bert_batch(BERT["vocab_size"], B, T)
    n_params = sum(p.numel() for p in net.collect_params().values()
                   if p.grad_req != "null")
    per_step = _per_step(BERT["num_layers"], T, mode != "plain")

    def step():
        with autograd.record():
            loss = model(tokens, labels)
        loss.backward()
        trainer.step(1)
        return loss.detach()

    out = {"mode": mode}
    _zero_counts()
    mx_random.seed(7, device=DEV)
    with _graphs.eager() if mode == "eager" else contextlib.nullcontext():
        losses = []
        for _ in range(3):
            c0, f0 = _counts(), _fwd_captures()
            losses.append(step())
            c1 = _counts()
            want = _step_launches(per_step, _fwd_captures() - f0)
            assert {n: c1[n] - c0[n] for n in per_step} == want, \
                (mode, c0, c1)
        states = [trainer._states[i] for i in sorted(trainer._states)]
        out["losses"] = torch.stack(losses).float().cpu()
        out["masters"] = [s[0].clone() for s in states]
        out["moms"] = [s[1].clone() for s in states]
        out["captures"] = dict(_graphs.captures)
        out["replays"] = dict(_graphs.replays)
        out["launches"] = _counts()
        if mode == "plain":
            del net, model, trainer, states
            return out
        each = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            each.append(time.perf_counter() - t0)
        dt = sum(each) / 5
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            prof_s = time.perf_counter() - t0
    out["launches"] = _counts()
    busy = device_busy(prof, prof_s)
    tok_s, mfu, fpt = _mfu(n_params, B, T, dt)
    out.update(step_ms=dt * 1e3, each_ms=[t * 1e3 for t in each],
               tok_s=tok_s, mfu=mfu,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               prof_ms=prof_s * 1e3, card_ms=busy["busy_s"] * 1e3,
               busy=busy["busy_share"], kernels=busy["kernels"])
    log(f"captured training [{smi}] B={B} T={T} {mode}: step "
        f"{out['step_ms']:.2f} ms (mean of 5 after 3, each synchronised: "
        f"{', '.join(f'{t:.2f}' for t in out['each_ms'])}), "
        f"{tok_s:.1f} tokens/s, "
        f"MFU " + (f"{mfu:.4f}" if mfu else "not measured") + f" ({fpt} "
        f"flop/token), peak memory {out['peak_gib']:.2f} GiB; one profiled "
        f"step {out['prof_ms']:.2f} ms wall, card busy {out['card_ms']:.2f} "
        f"ms = {out['busy']:.3f}, {out['kernels']} kernels")
    del net, model, trainer, states
    return out


def phase_captured_training(smi: str, B: int, T: int) -> dict:
    """bench.py's step on CUDA graphs against its eager bodies and
    against the block never hybridized, at BERT-large width: the same
    losses, f32 masters and momenta bit for bit over three steps (the
    plain step draws the same masks by value); one capture of each
    program (recorded forward and backward, the Trainer's update), then
    replays; each step's launches as `_per_step` says; the graphed and
    the eager step timed in the same run."""
    runs = {}
    for mode in ("graph", "eager", "plain"):
        runs[mode] = _captured_run(B, T, mode, smi)
        gc.collect()
        torch.cuda.empty_cache()
    g = runs["graph"]
    progs = ("fwd_record", "bwd_record", "update")
    assert {k: g["captures"].get(k) for k in progs} \
        == dict.fromkeys(progs, 1) and {k: g["replays"].get(k)
                                        for k in progs} \
        == THREE_STEP_REPLAYS, (g["captures"], g["replays"])
    for mode in ("eager", "plain"):
        r = runs[mode]
        assert torch.equal(r["losses"], g["losses"]), \
            (mode, r["losses"], g["losses"])
        assert all(torch.equal(a, b) for a, b in zip(r["masters"],
                                                     g["masters"])), \
            f"{mode}: f32 masters differ from the graphed step's"
        assert all(torch.equal(a, b) for a, b in zip(r["moms"], g["moms"])), \
            f"{mode}: momenta differ from the graphed step's"
    e = runs["eager"]
    log(f"captured training [{smi}] B={B} T={T}: 3 steps on graphs, on "
        f"the eager bodies and never hybridized bit-identical (losses "
        f"{g['losses'].tolist()}, {len(g['masters'])} f32 masters and "
        f"momenta); captures {g['captures']}, replays after 3 steps "
        f"{g['replays']}; step {g['step_ms']:.2f} ms graphed against "
        f"{e['step_ms']:.2f} ms eager ({e['step_ms'] / g['step_ms']:.2f}x), "
        f"card busy {g['busy']:.3f} against {e['busy']:.3f}, kernels a "
        f"step {g['kernels']} against {e['kernels']}")
    return {"launches": {n: g["launches"][n] + e["launches"][n]
                         + runs["plain"]["launches"][n]
                         for n in g["launches"]},
            "graph": {k: v for k, v in g.items()
                      if k not in ("masters", "moms")},
            "eager": {k: v for k, v in e.items()
                      if k not in ("masters", "moms")}}


# replays after three captured steps: F also replays at its capture
THREE_STEP_REPLAYS = dict(fwd_record=3, bwd_record=2, update=2)


class _TwoDense(HybridBlock):
    """``mean(b(relu(a(x)))^2)``, width 1024."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.a = Dense(1024, 1024, device=DEV, dtype=dtype)
        self.b = Dense(1024, 1024, device=DEV, dtype=dtype)

    def forward(self, x):
        return (self.b(torch.relu(self.a(x))).float() ** 2).mean()


def _edge_steps(hybrid, dtype, fuse, x_grad):
    """Three recorded steps of `_TwoDense` from seed 11 (SGD, lr 0.05,
    momentum 0.9, wd 1e-4, no f32 masters), a fresh input each: each
    step's loss, input gradient (``x_grad``) and weights, and the
    momenta after step 3."""
    mx_random.seed(11, device=DEV)
    net = _TwoDense(dtype).initialize()
    if hybrid:
        net.hybridize()
    tr = Trainer(net.collect_params(), "sgd", {
        "learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4},
        keep_grads=False, fuse_step=fuse)
    steps = []
    for s in range(3):
        x = torch.from_numpy(np.random.RandomState(20 + s).uniform(
            -1, 1, (64, 1024)).astype(np.float32)).to(DEV, dtype)
        if x_grad:
            x.requires_grad_()
        with autograd.record():
            loss = net(x)
        loss.backward()
        tr.step(1)
        steps.append((loss.detach().clone(), x.grad,
                      [p.detach().clone() for p in
                       net.collect_params().values()]))
    torch.cuda.synchronize()
    return steps, [s for s in tr._states.values() if s is not None]


def check_train_step_edges(smi: str) -> dict:
    """Phase 25's two patterns beside bench.py's (see the module
    docstring): input gradients through the recorded programs, and the
    captured update of a bf16 model without f32 masters."""
    progs = ("fwd_record", "bwd_record", "update")
    c0 = {k: _graphs.captures.get(k, 0) for k in progs}
    r0 = {k: _graphs.replays.get(k, 0) for k in progs}
    graphed, _ = _edge_steps(True, torch.float32, True, True)
    caps = {k: _graphs.captures.get(k, 0) - c0[k] for k in progs}
    reps = {k: _graphs.replays.get(k, 0) - r0[k] for k in progs}
    assert caps == dict.fromkeys(progs, 1) and \
        reps == THREE_STEP_REPLAYS, (caps, reps)
    plain, _ = _edge_steps(False, torch.float32, True, True)
    for i, ((lg, gg, wg), (lp, gp, wp)) in enumerate(zip(graphed, plain)):
        assert gg is not None and torch.count_nonzero(gg) > 0, i
        assert torch.equal(lg, lp) and torch.equal(gg, gp), \
            f"step {i + 1}: the input's gradient differs from eager"
        assert all(torch.equal(a, b) for a, b in zip(wg, wp)), \
            f"step {i + 1}: weights differ from the never-hybridized block"
    fused, mf = _edge_steps(True, torch.bfloat16, True, False)
    unfused, mu = _edge_steps(True, torch.bfloat16, False, False)
    for i, ((lf, _, wf), (lu, _, wu)) in enumerate(zip(fused, unfused)):
        assert all(w.dtype == torch.bfloat16 for w in wf)
        assert torch.equal(lf, lu) and all(
            torch.equal(a, b) for a, b in zip(wf, wu)), \
            f"bf16 step {i + 1}: fused update differs from unfused"
    assert all(torch.equal(a, b) for a, b in zip(mf, mu)), \
        "bf16: momenta of the fused update differ from unfused"
    # the rule's product (f32, rounded once) against torch's own foreach
    # product with a Python float on a bf16 list, in place and not
    xs = [t.detach().clone() for t in fused[0][2]]
    rule = opt_mod._mul(xs, torch.tensor(0.9, device=DEV))
    own = torch._foreach_mul(xs, 0.9)
    torch._foreach_mul_(xs, 0.9)
    agree = (all(torch.equal(a, b) for a, b in zip(rule, own)),
             all(torch.equal(a, b) for a, b in zip(rule, xs)))
    log(f"captured training edges [{smi}]: input gradients through the "
        f"recorded programs over 3 steps equal the never-hybridized "
        f"block's bit for bit (captures {caps}, replays {reps}); bf16 "
        f"without f32 masters: the captured update equals fuse_step=False "
        f"bit for bit over 3 steps (losses "
        f"{[float(s[0]) for s in fused]}); torch's foreach bf16 product "
        f"with a Python float equals the rule's f32 product: out of place "
        f"{agree[0]}, in place {agree[1]}")
    return {"captures": caps, "replays": reps, "float_product": agree}


# ---------------------------------------------------------------- phase 26
# BASELINE config #4: Transformer-big on WMT En-De as
# examples/nlp/train_transformer.py trains it (bf16 over f32 masters,
# Adam 0.9/0.98 under the inverse-sqrt schedule, label smoothing 0.1),
# B=16 at T=256 (BASELINE.md, "Transformer-big train"); 6+6 layers,
# nothing cut
NMT = dict(src_vocab=32000, tgt_vocab=32000, units=1024, hidden_size=4096,
           num_layers=6, num_heads=16)
NMT_BATCH = (16, 256)
NMT_SMOOTHING = 0.1
# the Noam schedule's rate: d_model^-0.5 · min(t^-0.5, t · warmup^-1.5)
NMT_ADAM = {"learning_rate": NMT["units"] ** -0.5, "beta1": 0.9,
            "beta2": 0.98, "multi_precision": True}
NMT_WARMUP = 4000


def _nmt_model(cfg, dtype, seed, dropout=DROPOUT, hybrid=True):
    """A Transformer from ``seed``, cast to ``dtype``, inside
    `NMTWithLoss`, hybridized or not at all (the loss hybridizes itself
    otherwise), and its Adam Trainer under a fresh inverse-sqrt
    schedule."""
    mx_random.seed(seed, device=DEV)
    net = Transformer(**cfg, dropout=dropout, max_length=512, device=DEV)
    net.initialize()
    if dtype != torch.float32:
        net.cast(dtype)
    model = NMTWithLoss(net, NMT_SMOOTHING)
    model.hybridize(hybrid)
    trainer = Trainer(model.collect_params(), "adam", dict(
        NMT_ADAM, lr_scheduler=InvSqrtScheduler(NMT_WARMUP)),
        keep_grads=False)
    return net, model, trainer


def _nmt_batch(V, B, S, T, seed=0):
    """Source, shifted target in and out, source lengths: half the rows
    padded (length S/2..S-1, their targets ignored past it), on DEV."""
    g = torch.Generator().manual_seed(seed)
    src = torch.randint(1, V, (B, S), generator=g)
    tgt = torch.randint(1, V, (B, T + 1), generator=g)
    vl = torch.full((B,), S)
    vl[:B // 2] = torch.randint(S // 2, S, (B // 2,), generator=g)
    out = tgt[:, 1:].clone()
    out[torch.arange(T)[None, :] >= vl[:, None]] = -1
    return tuple(t.to(DEV) for t in (src, tgt[:, :-1].contiguous(), out, vl))


def _nmt_per_step(L, hybridized=True) -> dict:
    """Launches of each kernel in one NMT training step: 2 embedding
    dropouts, 3 a encoder layer and 4 a decoder layer (the FFN's own
    and the residual adds), each one fused forward and one backward;
    the decoder's causal flash forward, dK/dV and dQ once a layer (the
    encoder's self-attention is masked: torch ops); the smoothed
    cross-entropy's forward and backward once."""
    sites = 2 + 3 * L + 4 * L
    return {"dropout_mask": 0, "dropout_mask_dev": 0,
            "dropout_fwd": 0 if hybridized else sites,
            "dropout_fwd_dev": sites if hybridized else 0,
            "dropout_bwd": sites, "xent_forward": 1, "xent_backward": 1,
            **{n: L for n in FLASH_KERNELS}}


def _nmt_mfu(n_params, n_embed, T, dt, tokens):
    """(tokens/s, MFU or None, flop a token): train_transformer.py's
    count, 6·(N - N_embed) + 12·T·D·3L a target token (encoder and
    decoder matmuls; encoder self, decoder self and cross attention),
    over the H100 SXM's dense bf16 peak."""
    fpt = 6 * (n_params - n_embed) \
        + 12 * T * NMT["units"] * 3 * NMT["num_layers"]
    tok_s = tokens / dt
    name = torch.cuda.get_device_name(0)
    peak = PEAK_FLOPS[torch.bfloat16] \
        if "H100" in name and "PCIe" not in name else None
    return tok_s, (tok_s * fpt / peak if peak else None), fpt


def _nmt_run(mode, smi, rec=None):
    """`transformer_big` bf16, seed 0, ``random.seed(7)``: three steps
    of the NMT step on CUDA graphs (``graph``: the hybridized block's
    recorded forward and backward, the Trainer's update program) or
    never hybridized (``plain``), each step's launches held to
    `_nmt_per_step`; then five timed steps and one profiled step.
    Returns the losses, clones of the f32 masters and Adam moments after
    step 3, the numbers, and for ``graph`` the trained net."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    hybrid = mode == "graph"
    t0 = time.perf_counter()
    net, model, trainer = _nmt_model(NMT, torch.bfloat16, 0, hybrid=hybrid)
    B, T = NMT_BATCH
    src, tin, tout, vl = _nmt_batch(NMT["src_vocab"], B, T, T)
    n_params = sum(p.numel() for p in net.collect_params().values()
                   if p.grad_req != "null")
    n_embed = net.src_embed.weight.numel()
    torch.cuda.synchronize()
    built_s = time.perf_counter() - t0
    per_step = _nmt_per_step(NMT["num_layers"], hybrid)

    def step():
        with autograd.record():
            loss = model(src, tin, tout, vl)
        loss.backward()
        trainer.step(1)
        return loss.detach()

    def keep_first(key):
        def keep(args, kw):
            if rec is not None:
                rec.setdefault(key, _kept(args))
        return keep

    out = {"mode": mode}
    _zero_counts()
    mx_random.seed(7, device=DEV)
    def keep_mixed(args, kw):
        # the first bf16 sublayer output added to the f32 residual
        # stream: copied in the warm-up, before any capture records it
        x, res, seed, rate = args
        if rec is not None and "drop_mixed" not in rec and res is not None \
                and (x.dtype, res.dtype) == (torch.bfloat16, torch.float32):
            rec["drop_mixed"] = (x.clone(), res.clone(), seed.clone()
                                 if isinstance(seed, torch.Tensor) else seed,
                                 rate)

    with recording(xk_mod, "_fwd_cuda", keep_first("fwd")), \
            recording(xk_mod, "_bwd_cuda", keep_first("bwd")), \
            recording(fa_mod, "_flash_bwd_core", keep_first("flash_bwd")), \
            recording(dk_mod, "_fwd_cuda", keep_mixed):
        losses = []
        for _ in range(3):
            c0, f0 = _counts(), _fwd_captures()
            losses.append(step())
            c1 = _counts()
            want = _step_launches(per_step, _fwd_captures() - f0)
            assert {n: c1[n] - c0[n] for n in per_step} == want, \
                (mode, c0, c1)
    states = [trainer._states[i] for i in sorted(trainer._states)]
    out["losses"] = torch.stack(losses).float().cpu()
    out["masters"] = [s[0].clone() for s in states]
    out["moments"] = [t.clone() for s in states for t in s[1]]
    out["captures"] = dict(_graphs.captures)
    out["replays"] = dict(_graphs.replays)
    lrs = trainer.learning_rate
    each = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        each.append(time.perf_counter() - t0)
    dt = sum(each) / 5
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    out["launches"] = _counts()
    busy = device_busy(prof, prof_s)
    tok_s, mfu, fpt = _nmt_mfu(n_params, n_embed, T, dt, B * T)

    def share(*keys):
        ms = sum(v for n, v in busy["by_name"].items()
                 if any(k in n for k in keys))
        return ms, ms / max(busy["busy_s"] * 1e3, 1e-9)

    out.update(step_ms=dt * 1e3, each_ms=[t * 1e3 for t in each],
               tok_s=tok_s, mfu=mfu,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               prof_ms=prof_s * 1e3, card_ms=busy["busy_s"] * 1e3,
               busy=busy["busy_share"], kernels=busy["kernels"],
               top=busy["top"], n_params=n_params,
               shares={"flash forward": share("tc::fwd_kernel",
                                              "flash_fwd_kernel"),
                       "flash backward": share("dkdv_kernel", "dq_kernel"),
                       "dropout": share("dropout_kernel"),
                       "xent": share("xent_"),
                       "gemm": share("gemm", "nvjet", "cutlass", "sm90_"),
                       "foreach": share("multi_tensor_apply")})
    log(f"NMT training [{smi}] {mode}: transformer_big {NMT} bf16 + f32 "
        f"masters, {n_params} trainable parameters (built in "
        f"{built_s:.1f} s), B={B} S=T={T}, Adam {NMT_ADAM} under "
        f"InvSqrtScheduler({NMT_WARMUP}) (lr {lrs:.3e} at step 3), label "
        f"smoothing {NMT_SMOOTHING}; losses {out['losses'].tolist()}; step "
        f"{out['step_ms']:.2f} ms (mean of 5 after 3, each synchronised: "
        f"{', '.join(f'{t:.2f}' for t in out['each_ms'])}), "
        f"{tok_s:.1f} target tokens/s, MFU "
        + (f"{mfu:.4f}" if mfu else "not measured") + f" ({fpt} flop a "
        f"target token), peak memory {out['peak_gib']:.2f} GiB; captures "
        f"{out['captures']}, replays after 3 steps {out['replays']}; "
        f"launches a step {per_step}")
    log(f"NMT one profiled step [{smi}] {mode}: {out['prof_ms']:.2f} ms "
        f"wall, card busy {out['card_ms']:.2f} ms = {out['busy']:.3f} (idle "
        f"{1 - out['busy']:.3f}), {out['kernels']} kernels; shares of the "
        f"card time: " + "; ".join(f"{k} {ms:.3f} ms = {sh:.3f}"
                                   for k, (ms, sh) in out["shares"].items())
        + "; device ms by kernel: " + "; ".join(
            f"{n} {ms:.3f}" for n, ms in busy["top"]))
    del model, trainer, states
    if hybrid:
        out["net"] = net
    return out


def phase_nmt_training(smi: str) -> dict:
    """Phase 26 (see the module docstring): the NMT step on graphs and
    never hybridized, bit for bit over three steps, each timed; the
    kernels' inputs of the graphed run's first step are kept for
    `time_nmt_kernels`."""
    rec = {}
    plain = _nmt_run("plain", smi)
    graph = _nmt_run("graph", smi, rec)
    progs = ("fwd_record", "bwd_record", "update")
    assert {k: graph["captures"].get(k) for k in progs} \
        == dict.fromkeys(progs, 1) and {k: graph["replays"].get(k)
                                        for k in progs} \
        == THREE_STEP_REPLAYS, (graph["captures"], graph["replays"])
    assert torch.isfinite(graph["losses"]).all(), graph["losses"]
    assert torch.equal(plain["losses"], graph["losses"]), \
        (plain["losses"], graph["losses"])
    assert all(torch.equal(a, b) for a, b in zip(plain["masters"],
                                                 graph["masters"])), \
        "NMT: f32 masters differ between graphs and never hybridized"
    assert all(torch.equal(a, b) for a, b in zip(plain["moments"],
                                                 graph["moments"])), \
        "NMT: Adam moments differ between graphs and never hybridized"
    x2, want_sum = rec["fwd"]
    bx, labels, lse, g, eps = rec["bwd"]
    assert want_sum and eps == NMT_SMOOTHING, (want_sum, eps)
    mixed = check_nmt_mixed_dropout(rec["drop_mixed"])
    log(f"NMT training [{smi}]: 3 steps on graphs and never hybridized "
        f"bit-identical (losses, {len(graph['masters'])} f32 masters, "
        f"{len(graph['moments'])} Adam moments); the smoothed "
        f"cross-entropy ran with the row sum (forward) and eps "
        f"{eps} (backward) at {tuple(x2.shape)} {x2.dtype}; step "
        f"{graph['step_ms']:.2f} ms graphed against {plain['step_ms']:.2f} "
        f"ms never hybridized ({plain['step_ms'] / graph['step_ms']:.2f}x), "
        f"card busy {graph['busy']:.3f} against {plain['busy']:.3f}; "
        f"{mixed}")
    for r in (plain, graph):
        del r["masters"], r["moments"]
    return {"launches": {n: plain["launches"][n] + graph["launches"][n]
                         for n in plain["launches"]},
            "rec": rec, "net": graph.pop("net"), "graph": graph,
            "plain": plain}


def check_nmt_mixed_dropout(rec) -> str:
    """The fused dropout at the bf16 residual stream's mixed dtypes (a
    bf16 x, an f32 residual): the kernel's y at the first such input of
    phase 26's graphed step equals the plain version's bits, and at
    (4096, 1024), contiguous and one element into its buffers, y (f32),
    dx (bf16) and dres equal the plain composition's and its autograd
    gradients' (`check_dropout_fused`)."""
    x, res, seed, rate = rec
    fwd = dropout_fwd_dev if isinstance(seed, torch.Tensor) else dropout_fwd
    y, mask = fwd(x, res, seed, rate)
    ref_y, ref_mask = dropout_fwd_reference(x, res, seed, rate)
    torch.cuda.synchronize()
    assert y.dtype == torch.float32 and torch.equal(mask, ref_mask) \
        and torch.equal(_bits(y), _bits(ref_y)), \
        "NMT: the mixed-dtype dropout forward differs from its plain version"
    checks = 2 + sum(check_dropout_fused(torch.bfloat16, (4096, 1024), 0.1,
                                         seed_, offset, False,
                                         torch.float32)
                     for seed_, offset in ((1234567891234, 0), (7, 1)))
    return (f"the fused dropout at the mixed dtypes (bf16 x, f32 residual "
            f"and y) bit-identical to its plain version at the step's "
            f"input {tuple(x.shape)} and at (4096, 1024) ({checks} checks)")


def time_nmt_kernels(nres) -> dict:
    """The NMT path's kernels at the inputs its graphed run's first step
    gave them: the flash forward, dK/dV and dQ at the decoder's causal
    self-attention (the first backward call: the last decoder layer),
    beside SDPA ``is_causal=True``'s forward or backward; the smoothed
    cross-entropy forward (lse and the row sum) and backward (eps 0.1),
    held to the plain versions and timed beside
    ``F.cross_entropy(label_smoothing=0.1)`` and its autograd backward.
    Bounds: bytes (the logits read once, each output written once) or
    operations, as the other rows."""
    q, k, v, do, lse, delta, causal, scale = nres["rec"]["flash_bwd"]
    q, k, v = (t.detach() for t in (q, k, v))
    assert causal, "the decoder's flash call was not causal"
    out = {"flash_attention": time_flash_fwd(q, k, v, causal, scale,
                                             "NMT decoder")}
    out.update(time_flash_bwd(q, k, v, do, lse, delta, causal, scale,
                              "NMT decoder"))
    (x2, want_sum), (bx, labels, blse, g, eps) = nres["rec"]["fwd"], \
        nres["rec"]["bwd"]
    N, V = x2.shape
    ref_lse, ref_sum = stats_reference(x2, want_sum)
    got_lse, got_sum = xent_forward(x2, want_sum)
    err = ((got_lse - ref_lse).abs() / ref_lse.abs().clamp(min=1)).max().item()
    assert err <= LSE_RTOL, f"smoothed xent forward: lse err {err}"
    l1 = x2.float().abs().sum(-1).clamp(min=1)
    sum_err = ((got_sum - ref_sum).abs() / l1).max().item()
    assert sum_err <= SUM_RTOL, f"smoothed xent forward: sum err {sum_err}"
    bound, by = _bound(x2.numel() * x2.element_size() + N * 8, 5 * N * V,
                       PEAK_FLOPS[torch.float32])
    out["xent_forward"] = {
        "shape": f"({N}, {V}) {x2.dtype} with the row sum",
        "max_abs_err": err, "sum_err": sum_err,
        "ms": time_ms(lambda: xent_forward(x2, want_sum)),
        "plain_ms": time_ms(lambda: stats_reference(x2, want_sum)),
        "library_ms": time_ms(lambda: F.cross_entropy(
            x2, labels, label_smoothing=eps, reduction="none")),
        "bound_ms": bound, "bound_by": by}
    err = check_dlogits(xent_backward(bx, labels, blse, g, eps),
                        dlogits_reference(bx, labels, blse, g, eps), bx,
                        labels, g, eps, "smoothed xent backward at NMT inputs")
    xr = bx.detach().requires_grad_()
    ce = F.cross_entropy(xr, labels, label_smoothing=eps, reduction="none")
    bound, by = _bound(2 * bx.numel() * bx.element_size() + N * 12,
                       4 * N * V, PEAK_FLOPS[torch.float32])
    out["xent_backward"] = {
        "shape": f"({N}, {V}) {bx.dtype} eps={eps}", "max_abs_err": err,
        "ms": time_ms(lambda: xent_backward(bx, labels, blse, g, eps)),
        "plain_ms": time_ms(lambda: dlogits_reference(bx, labels, blse, g,
                                                      eps)),
        "library_ms": time_ms(lambda: torch.autograd.grad(
            ce, xr, g.to(ce.dtype), retain_graph=True)),
        "bound_ms": bound, "bound_by": by}
    return out


# ---------------------------------------------------------------- phase 27
NMT_GRAD_TOL = BWD_TOL[torch.float32]


def _nmt_one_step(cfg, B, T, plain: bool):
    net, model, trainer = _nmt_model(cfg, torch.float32, 1, dropout=0.0)
    batch = _nmt_batch(cfg["src_vocab"], B, T, T, seed=1)
    c0, f0 = _counts(), _fwd_captures()
    with plain_kernels() if plain else contextlib.nullcontext():
        with autograd.record():
            loss = model(*batch)
        loss.backward()
        grads = {n: p.grad.detach().clone()
                 for n, p in model.collect_params().items()
                 if p.grad is not None}
        trainer.step(1)
    torch.cuda.synchronize()
    c1 = _counts()
    L = cfg["num_layers"]
    want = {n: 0 if plain or n.startswith("dropout") else k
            for n, k in _step_launches(_nmt_per_step(L),
                                       _fwd_captures() - f0).items()}
    assert {n: c1[n] - c0[n] for n in c1} == want, (plain, c0, c1)
    return float(loss.detach()), grads, net


def phase_nmt_parity() -> dict:
    """Phase 27: 2+2 layers at full width in f32, dropout off, B=4,
    S=T=256: the hybridized step through the kernels against the same
    step with every kernel swapped for its plain version (loss within
    1e-5 relative, each gradient within rtol·|ref| + atol·max|ref|,
    `NMT_GRAD_TOL`); then greedy ``translate`` on the programs against
    their eager bodies, token for token."""
    cfg = dict(NMT, num_layers=2)
    loss_k, grads_k, net = _nmt_one_step(cfg, 4, 256, plain=False)
    loss_p, grads_p, _ = _nmt_one_step(cfg, 4, 256, plain=True)
    assert abs(loss_k - loss_p) <= 1e-5 * abs(loss_p), (loss_k, loss_p)
    assert grads_k.keys() == grads_p.keys()
    worst = max(_excess(grads_k[n], grads_p[n], NMT_GRAD_TOL)
                for n in grads_p)
    assert worst <= 1.0, f"NMT parity: a gradient at {worst:.3g}x its bound"
    src = torch.randint(1, cfg["src_vocab"], (4, 64),
                        generator=torch.Generator().manual_seed(3)).to(DEV)
    vl = torch.tensor([64, 40, 64, 17], device=DEV)
    graphed = net.translate(src, 32, src_valid_length=vl)
    again = net.translate(src, 32, src_valid_length=vl)
    with _graphs.eager():
        eager = net.translate(src, 32, src_valid_length=vl)
    assert torch.equal(graphed, eager) and torch.equal(again, eager), \
        (graphed, eager)
    log(f"NMT parity (f32, 2+2 layers, width {NMT['units']}, B=4 S=T=256, "
        f"dropout 0): loss {loss_k:.7f} kernels vs {loss_p:.7f} plain; "
        f"every gradient within {worst:.3g} of its allowance (rtol "
        f"{NMT_GRAD_TOL[0]} of |ref| + atol {NMT_GRAD_TOL[1]} of max|ref|) "
        f"over {len(grads_p)} tensors; greedy translate (B=4, S=64, "
        f"max_len 32, masked) on graphs equals the eager bodies token for "
        f"token")
    return {"loss_err": abs(loss_k - loss_p) / abs(loss_p), "grad": worst}


# ---------------------------------------------------------------- phase 28
def _translate_runs(net, smi, tag, src, max_len, **kw):
    """One signature of ``net.translate``: the capturing call, a second
    call (replays only: no capture), and the eager bodies; the tokens
    of all three equal.  Returns the numbers."""
    progs = ("nmt_start", "nmt_step")
    c0 = {p: _graphs.captures.get(p, 0) for p in progs}
    r0 = {p: _graphs.replays.get(p, 0) for p in progs}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = net.translate(src, max_len, **kw)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    c1 = {p: _graphs.captures.get(p, 0) for p in progs}
    t0 = time.perf_counter()
    second = net.translate(src, max_len, **kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    c2 = {p: _graphs.captures.get(p, 0) for p in progs}
    r2 = {p: _graphs.replays.get(p, 0) - r0[p] for p in progs}
    with _graphs.eager():
        t0 = time.perf_counter()
        eager = net.translate(src, max_len, **kw)
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t0
    caps = {p: c1[p] - c0[p] for p in progs}
    assert caps == dict.fromkeys(progs, 1), (tag, caps)
    assert c2 == c1, f"{tag}: the repeated signature captured again"
    # the first call: the step's warm-up runs, then N-2 replays; the
    # second: one start replay and N-1 step replays
    assert r2 == {"nmt_start": 1, "nmt_step": 2 * max_len - 3}, (tag, r2)
    beams = isinstance(first, tuple)
    toks = (lambda r: r[0]) if beams else (lambda r: r)
    assert torch.equal(toks(first), toks(second)) and \
        torch.equal(toks(first), toks(eager)), f"{tag}: tokens differ"
    if beams:
        assert torch.equal(first[1], eager[1]), f"{tag}: scores differ"
    B = src.shape[0]
    K = kw.get("beam_size", 1)
    out = {"tag": tag, "first_s": first_s, "replay_s": dt,
           "eager_s": eager_s, "tok_s": B * max_len / dt,
           "beam_tok_s": B * K * max_len / dt,
           "eager_tok_s": B * max_len / eager_s,
           "captures": caps, "replays": r2}
    log(f"NMT translate [{smi}] {tag}: B={B} S={src.shape[1]} "
        f"max_len={max_len} {kw}: second call {dt * 1e3:.1f} ms = "
        f"{out['tok_s']:.1f} output tok/s"
        + (f" ({out['beam_tok_s']:.1f} beam-token steps/s)" if beams else "")
        + f", the capturing call {first_s * 1e3:.1f} ms, the eager bodies "
        f"{eager_s * 1e3:.1f} ms ({out['eager_tok_s']:.1f} tok/s); "
        f"captures {caps}, replays over both graphed calls {r2}; tokens "
        f"equal three ways")
    return out


def phase_nmt_translate(smi: str, net) -> dict:
    """Phase 28: phase 26's trained transformer_big in bf16: greedy B=8,
    S=128, max_len 128 with no eos (every step runs); beam K=4 at B=2
    with alpha 0.6; greedy on the int8 decoder (`quantize_for_decode`);
    each a capturing call, a replayed call and the eager bodies
    (`_translate_runs`); the decode weight bytes, float and int8."""
    g = torch.Generator().manual_seed(5)
    V = NMT["src_vocab"]
    src = torch.randint(1, V, (8, 128), generator=g).to(DEV)
    out = {"greedy": _translate_runs(net, smi, "greedy", src, 128,
                                     eos_id=-1)}
    out["beam"] = _translate_runs(net, smi, "beam", src[:2], 128,
                                  beam_size=4, alpha=0.6)
    fbytes = gen_mod._weight_nbytes(gen_mod._gather_nmt_params(net))
    net.quantize_for_decode()
    try:
        qbytes = gen_mod._weight_nbytes(gen_mod._gather_nmt_params(
            net, net._decode_quant))
        out["int8"] = _translate_runs(net, smi, "greedy int8 decoder", src,
                                      128, eos_id=-1)
    finally:
        net.dequantize_decode()
    out["weight_bytes"] = {"float": fbytes, "int8": qbytes}
    log(f"NMT translate [{smi}]: decode weight bytes a step float {fbytes} "
        f"against int8 {qbytes} ({qbytes / fbytes:.3f}); greedy "
        f"{out['greedy']['tok_s']:.1f} tok/s float against "
        f"{out['int8']['tok_s']:.1f} int8")
    return out


def check_two_pending_calls(smi: str) -> dict:
    """Two recorded calls of a hybridized block before one backward
    (`_TwoDense`, width 1024, f32): on graphs the second call captures
    programs of its own, the backward of their sum gives the gradients
    of the block never hybridized bit for bit, and a third call after
    it replays the first programs."""
    xs = [torch.from_numpy(np.random.RandomState(30 + i).uniform(
        -1, 1, (64, 1024)).astype(np.float32)).to(DEV) for i in range(2)]
    got = []
    progs = ("fwd_record", "bwd_record")
    c0 = {k: _graphs.captures.get(k, 0) for k in progs}
    for hybrid in (True, False):
        mx_random.seed(12, device=DEV)
        net = _TwoDense().initialize()
        if hybrid:
            net.hybridize()
        with autograd.record():
            total = net(xs[0]) + net(xs[1])
        total.backward()
        got.append([p.grad.clone() for p in net.collect_params().values()])
        if hybrid:
            with autograd.record():
                net(xs[0]).backward()
            caps = {k: _graphs.captures.get(k, 0) - c0[k] for k in progs}
    torch.cuda.synchronize()
    assert caps == dict.fromkeys(progs, 2), caps
    assert all(torch.equal(a, b) for a, b in zip(*got)), \
        "two pending recorded calls: gradients differ from never hybridized"
    log(f"two recorded calls before one backward [{smi}]: gradients equal "
        f"the never-hybridized block's bit for bit over {len(got[0])} "
        f"tensors; captures {caps} (two instances), the third call "
        f"replayed the first")
    return {"captures": caps}


# ------------------------------------------------------------ phases 29-31
# ResNet-50 v1 (examples/image_classification/train.py and
# benchmark_score.py): bf16 over f32 masters, BASELINE.md's BS 128
RESNET_CLASSES = 1000
RESNET_BATCH = 128
RESNET_HW = 224
RESNET_SGD = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4,
              "multi_precision": True}
RESNET_INFER_BATCHES = (1, 32, 256)
# BASELINE.md: ResNet-50's forward FLOPs an image
BASELINE_FWD_FLOPS = 8.2e9
# phase 29's small net (tests/test_torch_resnet.py's v1 net) and rate
RESNET_SMALL = dict(layers=[1, 1, 1, 1], channels=[8, 16, 32, 64, 128],
                    classes=600)
RESNET_SMALL_SGD = {"learning_rate": 0.005, "momentum": 0.9, "wd": 1e-4}
# rtol·|ref| + atol·(max|ref| over the tensor's layer): f32 BatchNorm
# statistics (E[x²] - mean²) make a gradient's rounding noise scale with
# its layer's largest gradient (tests/test_torch_resnet.py `_by_layer`)
RESNET_TOL = (1e-4, 1e-4)


@contextlib.contextmanager
def cudnn_mode(deterministic: bool):
    """cuDNN's deterministic algorithms without autotuning
    (``deterministic``), or autotuning (``benchmark``) without the
    deterministic restriction."""
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = deterministic
    torch.backends.cudnn.benchmark = not deterministic
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved


def _images(B, hw, classes, seed, dtype, device=None):
    """Normalized images (standard normal) and labels from ``seed``, on
    ``device`` (DEV)."""
    device = DEV if device is None else device
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, 3, hw, hw, generator=g)
    y = torch.randint(0, classes, (B,), generator=g)
    return x.to(device=device, dtype=dtype), y.to(device)


def _layer_excess(got, ref, tol) -> float:
    """The worst ratio of |got - ref| to rtol·|ref| + atol·(the largest
    |ref| of the tensor's layer) over dicts of tensors by name."""
    scale = {}
    for k, r in ref.items():
        layer = k.rsplit(".", 1)[0]
        scale[layer] = max(scale.get(layer, 0.0), r.abs().max().item())
    worst = 0.0
    for k, r in ref.items():
        allow = tol[0] * r.abs() + tol[1] * scale[k.rsplit(".", 1)[0]]
        ex = ((got[k] - r).abs() / allow.clamp(min=1e-30)).max().item()
        worst = max(worst, ex)
    return worst


def _resnet_parity_run(device):
    mx_random.seed(3, device=device)
    net = vision.ResNetV1(vision.BottleneckV1, RESNET_SMALL["layers"],
                          RESNET_SMALL["channels"],
                          classes=RESNET_SMALL["classes"],
                          device=device).initialize()
    net.hybridize()
    tr = Trainer(net.collect_params(), "sgd", dict(RESNET_SMALL_SGD))
    loss_fn = SoftmaxCrossEntropyLoss()
    out = {"losses": []}
    for s in range(3):
        x, y = _images(2, 64, RESNET_SMALL["classes"], 10 + s,
                       torch.float32, device)
        with autograd.record():
            logits = net(x)
            loss = loss_fn(logits, y)
        autograd.backward(loss)
        if s == 0:
            out["logits"] = logits.detach().cpu()
            out["grads"] = {n: p.grad.detach().cpu().clone()
                            for n, p in net.collect_params().items()
                            if p.grad is not None}
        tr.step(2)
        out["losses"].append(loss.detach().cpu())
    out["weights"] = {n: p.detach().cpu().clone()
                      for n, p in net.named_parameters()}
    return out


def phase_resnet_parity() -> dict:
    """Phase 29: chip_smoke's small ResNet v1 bottleneck net in f32, B=2
    at 64x64, 600 classes (the loss on the streamed cross-entropy
    kernels on the card, its plain version on the CPU), three
    hybridized SGD steps (momentum, wd) on the card against the port's
    CPU path from the same seed: the logits and the per-sample losses
    within 1e-5 relative, every gradient of step 1 and every weight and
    running stat after step 3 within `RESNET_TOL` of its layer.  TF32 is
    off for cuDNN and cuBLAS (phase 1), so the card computes in f32."""
    assert not torch.backends.cudnn.allow_tf32 \
        and not torch.backends.cuda.matmul.allow_tf32
    with cudnn_mode(True):
        card = _resnet_parity_run(DEV)
    cpu = _resnet_parity_run(torch.device("cpu"))
    torch.cuda.synchronize()
    lg = _excess(card["logits"], cpu["logits"], (1e-5, 1e-5))
    ls = max(_excess(a, b, (1e-5, 0.0)) for a, b in zip(card["losses"],
                                                       cpu["losses"]))
    assert card["grads"].keys() == cpu["grads"].keys()
    gr = _layer_excess(card["grads"], cpu["grads"], RESNET_TOL)
    wt = _layer_excess(card["weights"], cpu["weights"], RESNET_TOL)
    assert max(lg, ls, gr, wt) <= 1.0, \
        f"ResNet parity: logits {lg}, losses {ls}, grads {gr}, weights {wt}"
    n_stats = sum(k.endswith(("running_mean", "running_var"))
                  for k in cpu["weights"])
    log(f"ResNet parity (f32, TF32 off, small v1 bottleneck "
        f"{RESNET_SMALL}, B=2 64x64, SGD {RESNET_SMALL_SGD}, 3 steps): card "
        f"against the CPU path: logits at {lg:.3g}, losses at {ls:.3g} of "
        f"their bounds; {len(cpu['grads'])} gradients at {gr:.3g} and "
        f"{len(cpu['weights'])} weights and running stats ({n_stats} stats) "
        f"after 3 steps at {wt:.3g} of rtol {RESNET_TOL[0]} + atol "
        f"{RESNET_TOL[1]} of the layer's max")
    return {"logits": lg, "losses": ls, "grads": gr, "weights": wt}


def _resnet_model(hybrid):
    """train.py's net: ``get_model("resnet50_v1", classes=1000)``,
    ``initialize()`` from seed 0, ``cast("bfloat16")``, hybridized or
    not, and its SGD Trainer (f32 masters, ``keep_grads=False``)."""
    mx_random.seed(0, device=DEV)
    net = vision.get_model("resnet50_v1", classes=RESNET_CLASSES,
                           device=DEV)
    net.initialize()
    net.cast("bfloat16")
    if hybrid:
        net.hybridize()
    trainer = Trainer(net.collect_params(), "sgd", dict(RESNET_SGD),
                      keep_grads=False)
    return net, trainer


def _running_stats(net):
    return [p for n, p in net.named_parameters()
            if n.endswith(("running_mean", "running_var"))]


def resnet_macs(net) -> int:
    """Multiply-adds of every convolution and Dense of ``net`` for one
    image, from the shapes one eager forward gives them."""
    macs = []

    def conv_hook(m, inp, out):
        macs.append(out.numel() * m.weight[0].numel())

    def dense_hook(m, inp, out):
        macs.append(out.numel() * m.weight.shape[1])

    hooks = [m.register_forward_hook(conv_hook) for m in net.modules()
             if isinstance(m, _Conv)]
    hooks += [m.register_forward_hook(dense_hook) for m in net.modules()
              if isinstance(m, Dense)]
    try:
        with autograd.predict_mode():
            net(torch.zeros(1, 3, RESNET_HW, RESNET_HW, device=DEV,
                            dtype=next(net.parameters()).dtype))
    finally:
        for h in hooks:
            h.remove()
    return int(sum(macs))


_CONV_KEYS = ("fprop", "dgrad", "wgrad", "conv", "implicit_gemm", "xmma",
              "cudnn")


def _resnet_shares(busy) -> dict:
    """Card time (ms, share) of one profiled step by kind of kernel,
    each kernel counted once in the first kind that names it."""
    kinds = (("layout transposes", ("nchwToNhwc", "nhwcToNchw",
                                    "transpose")),
             ("convolution", _CONV_KEYS),
             ("gemm", ("gemm", "nvjet", "cutlass", "sm90_")),
             ("foreach (optimizer)", ("multi_tensor_apply",)),
             ("xent kernels", ("xent_",)),
             ("pooling", ("pool",)),
             ("reductions (BatchNorm statistics, means)", ("reduce",)),
             ("elementwise (BatchNorm apply, relu, adds, casts)",
              ("elementwise", "addcmul", "CatArray")))
    total = max(busy["busy_s"] * 1e3, 1e-9)
    out = {k: 0.0 for k, _ in kinds}
    out["other"] = 0.0
    for name, ms in busy["by_name"].items():
        kind = next((k for k, keys in kinds
                     if any(s in name for s in keys)), "other")
        out[kind] += ms
    return {k: (ms, ms / total) for k, ms in out.items()}


def _resnet_run(mode, smi, rec=None):
    """train.py's step on ResNet-50 v1 bf16 (B=128, 224x224, seed 0,
    one fixed batch): ``graph`` hybridized (three CUDA graphs F, B, U)
    or ``plain`` never hybridized, both under deterministic cuDNN; or
    ``graph_autotuned``, hybridized under ``cudnn.benchmark`` (timing
    only).  Three steps, each launching each cross-entropy kernel once
    and nothing else of the port's, the running stats kept after each;
    then five timed steps and one profiled one."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    hybrid = mode != "plain"
    B = RESNET_BATCH
    with cudnn_mode(mode != "graph_autotuned"):
        t0 = time.perf_counter()
        net, trainer = _resnet_model(hybrid)
        x, y = _images(B, RESNET_HW, RESNET_CLASSES, 1, torch.bfloat16)
        loss_fn = SoftmaxCrossEntropyLoss()
        torch.cuda.synchronize()
        built_s = time.perf_counter() - t0

        def step():
            with autograd.record():
                loss = loss_fn(net(x), y)
            autograd.backward(loss)
            trainer.step(B)
            return loss.detach()

        def keep_first(key):
            def keep(args, kw):
                if rec is not None:
                    rec.setdefault(key, _kept(args))
            return keep

        per_step = {n: 0 for n in TRAINING_KERNELS + FLASH_KERNELS}
        per_step.update(xent_forward=1, xent_backward=1)
        out = {"mode": mode}
        _zero_counts()
        t0 = time.perf_counter()
        with recording(xk_mod, "_fwd_cuda", keep_first("fwd")), \
                recording(xk_mod, "_bwd_cuda", keep_first("bwd")):
            losses, stats = [], []
            for _ in range(3):
                c0 = _counts()
                losses.append(step())
                c1 = _counts()
                # no kernel runs inside the net's recorded forward (its
                # loss is called eagerly, outside it)
                assert {n: c1[n] - c0[n] for n in per_step} == per_step, \
                    (mode, c0, c1)
                stats.append([s.detach().clone()
                              for s in _running_stats(net)])
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        states = [trainer._states[i] for i in sorted(trainer._states)]
        out["losses"] = torch.stack(losses).float().cpu()
        out["masters"] = [s[0].clone() for s in states]
        out["moms"] = [s[1].clone() for s in states]
        out["stats"] = stats
        out["captures"] = dict(_graphs.captures)
        out["replays"] = dict(_graphs.replays)
        each = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            each.append(time.perf_counter() - t0)
        dt = sum(each) / 5
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            prof_s = time.perf_counter() - t0
    out["launches"] = _counts()
    busy = device_busy(prof, prof_s)
    n_params = sum(p.numel() for p in net.collect_params().values()
                   if p.grad_req != "null")
    # by torch op (a replay's kernels have no host op: never hybridized)
    ops = sorted(((e.key, getattr(e, "self_device_time_total", 0.0) * 1e-3)
                  for e in prof.key_averages() if e.key.startswith("aten::")),
                 key=lambda kv: -kv[1])[:10] if mode == "plain" else []
    out.update(step_ms=dt * 1e3, each_ms=[t * 1e3 for t in each],
               img_s=B / dt, first3_s=first_s, built_s=built_s,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               prof_ms=prof_s * 1e3, card_ms=busy["busy_s"] * 1e3,
               busy=busy["busy_share"], kernels=busy["kernels"],
               top=busy["top"], shares=_resnet_shares(busy),
               n_params=n_params)
    log(f"ResNet-50 v1 training [{smi}] {mode} (cuDNN "
        + ("benchmark" if mode == "graph_autotuned" else
           "deterministic, no benchmark") + f"): bf16 + f32 masters, "
        f"{n_params} trainable parameters (built in {built_s:.1f} s), "
        f"B={B} {RESNET_HW}x{RESNET_HW}, SGD {RESNET_SGD}; mean losses "
        f"{out['losses'].mean(1).tolist()} (3 steps in {first_s:.1f} s); step "
        f"{out['step_ms']:.2f} ms (mean of 5 after 3, each synchronised: "
        f"{', '.join(f'{t:.2f}' for t in out['each_ms'])}), "
        f"{out['img_s']:.1f} img/s, peak memory {out['peak_gib']:.2f} GiB; "
        f"captures {out['captures']}, replays after 3 steps "
        f"{out['replays']}")
    log(f"ResNet-50 one profiled step [{smi}] {mode}: {out['prof_ms']:.2f} "
        f"ms wall, card busy {out['card_ms']:.2f} ms = {out['busy']:.3f} "
        f"(idle {1 - out['busy']:.3f}), {out['kernels']} kernels; shares of "
        f"the card time: " + "; ".join(
            f"{k} {ms:.3f} ms = {sh:.3f}"
            for k, (ms, sh) in out["shares"].items())
        + "; device ms by kernel: " + "; ".join(
            f"{n} {ms:.3f}" for n, ms in busy["top"])
        + ("; device ms by torch op: " + "; ".join(
            f"{n} {ms:.3f}" for n, ms in ops) if ops else ""))
    del trainer, states
    out["net"] = net
    return out


def phase_resnet_training(smi: str) -> dict:
    """Phase 30: train.py's step at full width on CUDA graphs and never
    hybridized, under deterministic cuDNN: losses, f32 masters, momenta
    and every step's running stats bit-identical over three steps (the
    stats move once a step, the first included); one capture of each
    program; step time, img/s, MFU, busy share and peak memory for both
    paths, and the graphed step again under cuDNN autotuning."""
    rec = {}
    plain = _resnet_run("plain", smi)
    macs = resnet_macs(plain.pop("net"))
    graph = _resnet_run("graph", smi, rec)
    progs = ("fwd_record", "bwd_record", "update")
    assert {k: graph["captures"].get(k) for k in progs} \
        == dict.fromkeys(progs, 1) and {k: graph["replays"].get(k)
                                        for k in progs} \
        == THREE_STEP_REPLAYS, (graph["captures"], graph["replays"])
    assert torch.isfinite(graph["losses"]).all(), graph["losses"]
    assert torch.equal(plain["losses"], graph["losses"]), \
        (plain["losses"], graph["losses"])
    assert all(torch.equal(a, b) for a, b in zip(plain["masters"],
                                                 graph["masters"])), \
        "ResNet: f32 masters differ between graphs and never hybridized"
    assert all(torch.equal(a, b) for a, b in zip(plain["moms"],
                                                 graph["moms"])), \
        "ResNet: momenta differ between graphs and never hybridized"
    for s, (a, b) in enumerate(zip(plain["stats"], graph["stats"])):
        assert all(torch.equal(u, v) for u, v in zip(a, b)), \
            f"ResNet: running stats differ after step {s + 1}"
    net = graph.pop("net")
    start = [torch.zeros_like(t) if i % 2 == 0 else torch.ones_like(t)
             for i, t in enumerate(_running_stats(net))]
    assert not any(torch.equal(u, v) for u, v in zip(start,
                                                     graph["stats"][0]))
    fast = _resnet_run("graph_autotuned", smi)
    del fast["net"]
    name = torch.cuda.get_device_name(0)
    peak = PEAK_FLOPS[torch.bfloat16] \
        if "H100" in name and "PCIe" not in name else None
    flops_img = 6 * macs
    for r in (plain, graph, fast):
        r["mfu"] = r["img_s"] * flops_img / peak if peak else None
    log(f"ResNet-50 v1 training [{smi}]: 3 steps on graphs and never "
        f"hybridized bit-identical under deterministic cuDNN (losses, "
        f"{len(graph['masters'])} f32 masters and momenta, "
        f"{len(graph['stats'][0])} running stats after each step, moved "
        f"from their initial values in step 1); step "
        f"{graph['step_ms']:.2f} ms graphed against {plain['step_ms']:.2f} "
        f"ms never hybridized ({plain['step_ms'] / graph['step_ms']:.2f}x), "
        f"{graph['img_s']:.1f} against {plain['img_s']:.1f} img/s, card "
        f"busy {graph['busy']:.3f} against {plain['busy']:.3f}, peak memory "
        f"{graph['peak_gib']:.2f} against {plain['peak_gib']:.2f} GiB; "
        f"graphed under cuDNN autotuning {fast['step_ms']:.2f} ms, "
        f"{fast['img_s']:.1f} img/s, busy {fast['busy']:.3f}; MFU "
        + ("/".join(f"{r['mfu']:.4f}" for r in (graph, plain, fast))
           if peak else "not measured")
        + f" (graphed/never hybridized/autotuned) at 3 x 2 x {macs} "
        f"multiply-adds an image ({2 * macs / 1e9:.3f} GFLOP forward, "
        f"BASELINE.md counts {BASELINE_FWD_FLOPS / 1e9:.1f}) over "
        f"{PEAK_FLOPS[torch.bfloat16] / 1e12:.0f} TFLOP/s")
    for r in (plain, graph, fast):
        del r["masters"], r["moms"], r["stats"]
    return {"launches": {n: plain["launches"][n] + graph["launches"][n]
                         + fast["launches"][n] for n in plain["launches"]},
            "rec": rec, "net": net, "macs": macs, "graph": graph,
            "plain": plain, "autotuned": fast}


def time_resnet_kernels(rres) -> dict:
    """The streamed cross-entropy forward and backward at the inputs of
    phase 30's graphed first step, (128, 1000) bf16: held to the plain
    versions there and timed beside them, ``F.cross_entropy`` (forward;
    its autograd backward) and the byte bound."""
    (x2, want_sum), (bx, labels, lse, g, eps) = rres["rec"]["fwd"], \
        rres["rec"]["bwd"]
    N, V = x2.shape
    assert (N, V) == (RESNET_BATCH, RESNET_CLASSES) and not want_sum \
        and eps == 0.0, (x2.shape, want_sum, eps)
    ref_lse, _ = stats_reference(x2, False)
    got_lse, _ = xent_forward(x2, False)
    err = ((got_lse - ref_lse).abs() / ref_lse.abs().clamp(min=1)).max().item()
    assert err <= LSE_RTOL, f"ResNet xent forward: lse err {err}"
    bound, by = _bound(x2.numel() * x2.element_size() + N * 4, 5 * N * V,
                       PEAK_FLOPS[torch.float32])
    out = {"xent_forward": {
        "shape": f"({N}, {V}) {x2.dtype}", "max_abs_err": err,
        "ms": time_ms(lambda: xent_forward(x2, False)),
        "plain_ms": time_ms(lambda: stats_reference(x2, False)),
        "library_ms": time_ms(lambda: F.cross_entropy(
            x2, labels, reduction="none")),
        "bound_ms": bound, "bound_by": by}}
    err = check_dlogits(xent_backward(bx, labels, lse, g, eps),
                        dlogits_reference(bx, labels, lse, g, eps), bx,
                        labels, g, eps, "xent backward at ResNet inputs")
    xr = bx.detach().requires_grad_()
    ce = F.cross_entropy(xr, labels, reduction="none")
    bound, by = _bound(2 * bx.numel() * bx.element_size() + N * 12,
                       4 * N * V, PEAK_FLOPS[torch.float32])
    out["xent_backward"] = {
        "shape": f"({N}, {V}) {bx.dtype}", "max_abs_err": err,
        "ms": time_ms(lambda: xent_backward(bx, labels, lse, g, eps)),
        "plain_ms": time_ms(lambda: dlogits_reference(bx, labels, lse, g,
                                                      eps)),
        "library_ms": time_ms(lambda: torch.autograd.grad(
            ce, xr, g.to(ce.dtype), retain_graph=True)),
        "bound_ms": bound, "bound_by": by}
    return out


def phase_resnet_inference(smi: str, net) -> dict:
    """Phase 31: phase 30's trained net (its training programs dropped)
    in bf16, hybridized, ``predict_mode``, under deterministic cuDNN, at
    B = 1, 32 and 256: the first call captures the signature's program,
    a second one only replays it, and the replay's logits equal the
    eager body's bit for bit; the running stats are only read; img/s
    graphed against the eager bodies (20 calls after 3)."""
    net.hybridize()
    gc.collect()
    torch.cuda.empty_cache()
    stats0 = [s.detach().clone() for s in _running_stats(net)]
    out = {}
    with cudnn_mode(True), autograd.predict_mode():
        for B in RESNET_INFER_BATCHES:
            x, _ = _images(B, RESNET_HW, RESNET_CLASSES, 40 + B,
                           torch.bfloat16)
            c0 = _graphs.captures.get("raw_fn", 0)
            first = net(x)
            c1 = _graphs.captures.get("raw_fn", 0)
            r1 = _graphs.replays.get("raw_fn", 0)
            again = net(x)
            assert _graphs.captures.get("raw_fn", 0) == c1 == c0 + 1 \
                and _graphs.replays.get("raw_fn", 0) == r1 + 1, \
                (B, c0, c1, dict(_graphs.captures))
            with _graphs.eager():
                eager = net(x)
            assert first.shape == (B, RESNET_CLASSES) \
                and torch.isfinite(first).all()
            assert torch.equal(again, eager) and torch.equal(first, eager), \
                f"ResNet inference B={B}: replay differs from the eager body"
            row = {}
            for kind in ("graph", "eager"):
                with _graphs.eager() if kind == "eager" \
                        else contextlib.nullcontext():
                    for _ in range(3):
                        net(x)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(20):
                        net(x)
                    torch.cuda.synchronize()
                    row[kind] = 20 * B / (time.perf_counter() - t0)
            out[B] = row
    assert all(torch.equal(a, b) for a, b in zip(stats0,
                                                 _running_stats(net))), \
        "ResNet inference moved the running stats"
    log(f"ResNet-50 v1 inference [{smi}] bf16, predict mode, cuDNN "
        f"deterministic: " + "; ".join(
            f"B={B} {r['graph']:.1f} img/s graphed against "
            f"{r['eager']:.1f} on the eager bodies "
            f"({r['graph'] / r['eager']:.2f}x)" for B, r in out.items())
        + "; each replay bit-identical to its eager body, one capture a "
        "signature, the running stats read only")
    return out


# --------------------------------------------------------- phases 32-34
# H100 SXM dense int8 tensor-core peak, operations/s (NVIDIA data sheet)
INT8_PEAK_OPS = 1979e12
PTQ_CALIB = (2, 8)              # benchmark_score.py: batches, images each
INT8_BATCHES = (256, 1)         # phase 32's batches (the first timed in full)
# small cases beyond ResNet-50's shapes: (x shape, weight shape, stride,
# pad, dilation, groups, bias, dtype): grouped, dilated, strided 1-D and
# 3-D, f32 activations
INT8_SMALL_CASES = (
    ((2, 32, 28, 28), (64, 4, 3, 3), (2, 2), (1, 1), (1, 1), 8, True,
     torch.bfloat16),
    ((2, 16, 30, 30), (32, 16, 3, 3), (1, 1), (2, 2), (2, 2), 1, False,
     torch.float32),
    ((4, 16, 100), (32, 16, 5), (2,), (2,), (1,), 1, True, torch.bfloat16),
    ((2, 8, 8, 12, 12), (16, 8, 3, 3, 3), (1, 2, 2), (1, 1, 1), (1, 1, 1),
     1, True, torch.float32),
    ((1, 3, 224, 224), (64, 3, 7, 7), (2, 2), (3, 3), (1, 1), 1, False,
     torch.float32))
# the int8 convolution's row in the kernel table: layer1's 3x3 64->64 at
# 56x56, B=256
INT8_ROW_SPEC = ((64, 56, 56), (64, 64, 3, 3), (1, 1), (1, 1), (1, 1), 1,
                 False)


def resnet_conv_specs(net) -> list:
    """[spec, count] for each distinct convolution of ``net`` (one eager
    bf16 forward at B=1, 224x224): spec = (input's (C, H, W), weight
    shape, stride, pad, dilation, groups, bias)."""
    specs = {}

    def hook(m, inp, out):
        spec = (tuple(inp[0].shape[1:]), tuple(m.weight.shape),
                tuple(m._strides), tuple(m._padding), tuple(m._dilation),
                m._groups, m.bias is not None)
        specs[spec] = specs.get(spec, 0) + 1

    hooks = [m.register_forward_hook(hook) for m in net.modules()
             if isinstance(m, _Conv)]
    try:
        with autograd.predict_mode():
            net(torch.zeros(1, 3, RESNET_HW, RESNET_HW, device=DEV,
                            dtype=torch.bfloat16))
    finally:
        for h in hooks:
            h.remove()
    return [[k, n] for k, n in specs.items()]


def _int8_inputs(xs, ws, bias, dtype, seed):
    """x (normal), int8 weights, f32 scale ``act_scale * w_scale`` and
    bias from ``seed``; act_scale clips the top 40% of |x|'s range."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(xs, generator=g).to(DEV, dtype)
    w_q = torch.randint(-127, 128, ws, generator=g).to(DEV, torch.int8)
    w_scale = (torch.rand(ws[0], generator=g) * 1e-2 + 1e-4).to(DEV)
    act = float(x.float().abs().max()) * 0.6 / 127.0
    scale = torch.tensor([act], dtype=torch.float32, device=DEV) * w_scale
    b = torch.randn(ws[0], generator=g).to(DEV) if bias else None
    return x, w_q, scale, act, b


def check_int8(xs, ws, stride, pad, dil, groups, bias, dtype, seed,
               timed=False, plain_timed=False) -> dict:
    """The two kernels against `int8_conv_reference` bit for bit at one
    shape (the dense case when ``ws`` is 2-D), over weights packed once
    as the quantized layers pack them, and the quantize kernel alone
    against its plain version; with ``timed`` the ms of the whole call,
    of the quantize pass and of the GEMM (with its split-K epilogue)
    apart, the bounds and the bf16 cuDNN (``F.linear``) time of the same
    layer under autotuning; with ``plain_timed`` the plain versions' ms
    too."""
    x, w_q, scale, act, b = _int8_inputs(xs, ws, bias, dtype, seed)
    dense = len(ws) == 2
    if dense:
        args = (x[:, :, None, None], w_q[:, :, None, None], scale, act, b,
                (1, 1), (0, 0), (1, 1), 1)
        wp = pack_weight(args[1])

        def run():
            return int8_dense(x, w_q, scale, act, b, w_packed=wp)

        def plain():
            return int8_conv_reference(*args).reshape(xs[0], ws[0])
    else:
        args = (x, w_q, scale, act, b, stride, pad, dil, groups)
        wp = pack_weight(w_q, groups)

        def run():
            return int8_conv(*args, w_packed=wp)

        def plain():
            return int8_conv_reference(*args)
    got, want = run(), plain()
    torch.cuda.synchronize()
    tag = f"int8 {'dense' if dense else 'conv'} x{xs} w{ws} {dtype}"
    assert got.dtype == dtype and got.shape == want.shape, tag
    assert torch.equal(_bits(got), _bits(want)), \
        f"{tag}: differs from the plain version " \
        f"({(got.float() - want.float()).abs().max().item()})"
    geo = ic_mod._Geometry(tuple(args[0].shape), tuple(args[1].shape),
                           *args[5:])
    sub, fold = geo.quant_args()

    def quantize():
        return int8_quantize(args[0], act, groups, sub, fold)

    xq = quantize()
    assert tuple(xq.shape) == geo.xq_shape and torch.equal(
        xq, quantize_channels_last_reference(args[0], act, groups, sub,
                                             fold)), f"{tag}: quantize pass"
    splits = geo.splits(ic_mod._sm_count(DEV))
    out = {"shape": tag.split(" ", 2)[2], "max_abs_err": 0.0,
           "splits": splits, "bn": geo.bn}
    if not timed:
        return out
    macs = got.numel() * math.prod(ws[1:])
    nbytes = x.numel() * x.element_size() + w_q.numel() \
        + got.numel() * got.element_size() + 4 * ws[0] * (2 if bias else 1)
    out["bound_ms"], out["bound_by"] = _bound(nbytes, 2 * macs,
                                              INT8_PEAK_OPS)
    out["quantize_bound_ms"], _ = _bound(
        args[0].numel() * x.element_size() + xq.numel(), 0, INT8_PEAK_OPS)
    out["ms"] = time_ms(run)
    out["quantize_ms"] = time_ms(quantize)
    res = torch.empty(geo.out_shape, dtype=dtype, device=DEV)
    ws_ = torch.empty((splits, geo.o, geo.m), dtype=torch.int32,
                      device=DEV) if splits > 1 else None
    out["conv_ms"] = time_ms(lambda: ic_mod._conv_cuda(
        xq, wp, scale, b, res, ws_, geo, splits))
    wf = w_q.to(dtype)
    bf = None if b is None else b.to(dtype)
    nd_ = x.dim() - 2
    with cudnn_mode(False):
        out["cudnn_ms"] = time_ms(
            (lambda: F.linear(x, wf, bf)) if dense else
            (lambda: getattr(F, f"conv{nd_}d")(x, wf, bf, stride, pad, dil,
                                               groups)))
    if plain_timed:
        out["plain_ms"] = time_ms(plain, iters=3, warmup=1)
        out["quantize_plain_ms"] = time_ms(
            lambda: quantize_channels_last_reference(args[0], act, groups,
                                                     sub, fold), iters=3,
            warmup=1)
    out["macs"] = macs
    return out


def phase_int8_kernels(smi: str) -> dict:
    """Phase 32 (see the module docstring)."""
    mx_random.seed(0, device=DEV)
    net = vision.get_model("resnet50_v1", classes=RESNET_CLASSES,
                           device=DEV).initialize().cast("bfloat16")
    specs = resnet_conv_specs(net)
    del net
    assert sum(n for _, n in specs) == 53, specs
    rows, seed = {}, 0
    keys = ("ms", "quantize_ms", "conv_ms", "cudnn_ms", "bound_ms")

    def show(r):
        return (f"{r['ms']:.4f} ms (quantize {r['quantize_ms']:.4f} + GEMM "
                f"{r['conv_ms']:.4f}, {r['splits']}-way split-K, "
                f"{r['bn']} channels a block), bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']})")

    for B in INT8_BATCHES:
        total = dict.fromkeys(keys, 0.0)
        for (cin, ws, st, pd, dl, gr, bias), n in specs:
            seed += 1
            r = check_int8((B,) + cin, ws, st, pd, dl, gr, bias,
                           torch.bfloat16, seed, timed=True,
                           plain_timed=B == INT8_BATCHES[0] and (
                               cin, ws, st, pd, dl, gr, bias)
                           == INT8_ROW_SPEC)
            for k in total:
                total[k] += n * r[k]
            rows[(B, cin, ws, st)] = r
            log(f"int8_conv [{smi}] B={B} {r['shape']} stride {st} pad {pd} "
                f"(x{n} in the net): {show(r)}, bf16 cuDNN autotuned "
                f"{r['cudnn_ms']:.4f} ms (a different function: torch has "
                f"no int8 convolution on CUDA); bit-identical to the plain "
                f"version, the quantize pass too")
        seed += 1
        r = check_int8((B, 2048), (RESNET_CLASSES, 2048), None, None, None,
                       1, True, torch.bfloat16, seed, timed=True,
                       plain_timed=B == INT8_BATCHES[0])
        rows[(B, "dense")] = r
        for k in total:
            total[k] += r[k]
        log(f"int8_dense [{smi}] B={B} {r['shape']}: {show(r)}, bf16 cuBLAS "
            f"F.linear {r['cudnn_ms']:.4f} ms; bit-identical")
        log(f"int8 layers of one ResNet-50 v1 forward [{smi}] at B={B}, "
            f"summed over the 53 convolutions and the Dense: "
            f"{total['ms']:.3f} ms of kernel time (quantize "
            f"{total['quantize_ms']:.3f} + GEMM {total['conv_ms']:.3f}) "
            f"against {total['bound_ms']:.3f} ms of bounds and "
            f"{total['cudnn_ms']:.3f} ms of bf16 cuDNN/cuBLAS")
        rows[(B, "total")] = total
    for i, (xs, ws, st, pd, dl, gr, bias, dt) in enumerate(INT8_SMALL_CASES):
        r = check_int8(xs, ws, st, pd, dl, gr, bias, dt, 1000 + i)
        log(f"int8_conv small case {r['shape']} stride {st} pad {pd} "
            f"dilation {dl} groups {gr} ({r['splits']}-way split-K): "
            f"bit-identical, the quantize pass too")
    B = INT8_BATCHES[0]
    conv = rows[(B, INT8_ROW_SPEC[0], INT8_ROW_SPEC[1], INT8_ROW_SPEC[2])]
    quant = {"shape": conv["shape"].split(" w")[0] + " -> channels-last int8",
             "max_abs_err": 0.0, "ms": conv["quantize_ms"],
             "plain_ms": conv["quantize_plain_ms"],
             "bound_ms": conv["quantize_bound_ms"], "bound_by": "bytes"}
    return {"int8_quantize": quant, "int8_conv": conv,
            "int8_dense": rows[(B, "dense")], "rows": rows, "specs": specs}


def _ptq_net(seed: int):
    """benchmark_score.py's net: ResNet-50 v1 from ``seed``, 1000
    classes, ``cast("bfloat16")``."""
    mx_random.seed(seed, device=DEV)
    return vision.get_model("resnet50_v1", classes=RESNET_CLASSES,
                            device=DEV).initialize().cast("bfloat16")


def _wrapped(net):
    return [(n, m) for n, m in net.named_modules()
            if isinstance(m, _QuantizedWrapper)]


def phase_ptq_inference(smi: str, bf16_rows: dict) -> dict:
    """Phase 33 (see the module docstring); ``bf16_rows``: phase 31's
    img/s by batch."""
    net = _ptq_net(0)
    calib = [_images(PTQ_CALIB[1], RESNET_HW, RESNET_CLASSES, 60 + i,
                     torch.bfloat16)[0] for i in range(PTQ_CALIB[0])]
    xs = {B: _images(B, RESNET_HW, RESNET_CLASSES, 40 + B,
                     torch.bfloat16)[0] for B in RESNET_INFER_BATCHES}
    with cudnn_mode(True), autograd.predict_mode():
        ref = {B: net(x) for B, x in xs.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    quantize_net(net, calib, calib_mode="minmax")
    minmax_s = time.perf_counter() - t0
    wrapped = _wrapped(net)
    kinds = [type(m.src).__name__ for _, m in wrapped]
    assert len(wrapped) == 54 and kinds.count("Conv2D") == 53 \
        and kinds.count("Dense") == 1, kinds
    other = _ptq_net(0)
    t0 = time.perf_counter()
    quantize_net(other, calib, calib_mode="entropy")
    entropy_s = time.perf_counter() - t0
    ratio = [e._qd.act_scale / m._qd.act_scale
             for (_, e), (_, m) in zip(_wrapped(other), wrapped)]
    del other
    net.hybridize()
    out = {"minmax_s": minmax_s, "entropy_s": entropy_s}
    int8_fns = (int8_quantize, int8_conv, int8_dense)
    for fn in int8_fns:
        fn.launches = 0
        _graphs.replayed_launches[fn] = 0
    with cudnn_mode(True), autograd.predict_mode():
        for B, x in xs.items():
            c0 = _graphs.captures.get("raw_fn", 0)
            first = net(x)
            c1 = _graphs.captures.get("raw_fn", 0)
            r1 = _graphs.replays.get("raw_fn", 0)
            n0 = {fn: _graphs.launches(fn) for fn in int8_fns}
            again = net(x)
            torch.cuda.synchronize()
            n1 = {fn: _graphs.launches(fn) - n0[fn] for fn in int8_fns}
            assert c1 == c0 + 1 and _graphs.captures.get("raw_fn", 0) == c1 \
                and _graphs.replays.get("raw_fn", 0) == r1 + 1, \
                (B, c0, c1, dict(_graphs.captures))
            assert (n1[int8_quantize], n1[int8_conv], n1[int8_dense]) \
                == (54, 53, 1), (B, n1)
            with _graphs.eager():
                eager = net(x)
            with plain_kernels(), _graphs.eager():
                plain = net(x)
            assert first.shape == (B, RESNET_CLASSES) \
                and first.dtype == torch.bfloat16 \
                and torch.isfinite(first).all()
            assert torch.equal(first, eager) and torch.equal(again, eager), \
                f"int8 ResNet B={B}: replay differs from the eager body"
            assert torch.equal(plain, eager), \
                f"int8 ResNet B={B}: kernels differ from the plain versions"
            f = ref[B].float()
            row = {"rel_diff": ((again.float() - f).abs().max()
                                / f.abs().max()).item()}
            for kind in ("graph", "eager"):
                with _graphs.eager() if kind == "eager" \
                        else contextlib.nullcontext():
                    for _ in range(3):
                        net(x)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(20):
                        net(x)
                    torch.cuda.synchronize()
                    row[kind] = 20 * B / (time.perf_counter() - t0)
            out[B] = row
    out["launches"] = {fn.__name__: _graphs.launches(fn) for fn in int8_fns}
    log(f"ResNet-50 v1 int8 inference [{smi}] (benchmark_score.py --dtype "
        f"int8: bf16, quantize_net minmax on {PTQ_CALIB[0]} x "
        f"{PTQ_CALIB[1]} images in {minmax_s:.2f} s, entropy in "
        f"{entropy_s:.2f} s (its thresholds / minmax's: median "
        f"{float(np.median(ratio)):.3f}, min {min(ratio):.3f}); 54 layers "
        f"wrapped, 54 quantize + 53 + 1 GEMM launches a forward inside "
        f"the replay): "
        + "; ".join(
            f"B={B} {r['graph']:.1f} img/s graphed against {r['eager']:.1f} "
            f"on the eager bodies ({r['graph'] / r['eager']:.2f}x), phase "
            f"31's bf16 net {bf16_rows[B]['graph']:.1f} graphed; int8 logits "
            f"within {r['rel_diff']:.4f} of the float net's largest |logit|"
            for B, r in out.items() if isinstance(B, int))
        + "; each replay bit-identical to its eager body and to the eager "
        "body on the plain versions, one capture a signature; launches "
        f"{out['launches']}")
    out["net"] = net
    return out


def phase_params(smi: str, trained, qnet) -> dict:
    """Phase 34 (see the module docstring)."""
    with tempfile.TemporaryDirectory() as d:
        f = os.path.join(d, "resnet50_v1.params")
        trained.save_parameters(f)
        size = os.path.getsize(f)
        fresh = _ptq_net(5)
        fresh.load_parameters(f)
        x, _ = _images(32, RESNET_HW, RESNET_CLASSES, 77, torch.bfloat16)
        with cudnn_mode(True), autograd.predict_mode(), _graphs.eager():
            a, b = trained(x), fresh(x)
        torch.cuda.synchronize()
        assert torch.equal(a, b), "a loaded net's logits differ"
        mine = dict(trained._collect_params_with_prefix())
        assert all(torch.equal(p, mine[n]) for n, p in
                   fresh._collect_params_with_prefix().items())
        qf = os.path.join(d, "resnet50_v1_int8.params")
        qnet.save_parameters(qf)
        loaded = nd.load(qf, device=DEV)
    names = {n for n, _ in _wrapped(qnet)}
    want = []
    for n in mine:
        layer, leaf = n.rsplit(".", 1)
        want.append(f"{layer}.src.{leaf}" if layer in names else n)
    assert list(loaded) == want, "the int8 net's keys"
    qparams = qnet._collect_params_with_prefix()
    assert all(torch.equal(v, qparams[k]) for k, v in loaded.items())
    log(f".params [{smi}]: phase 30's trained net ({len(mine)} arrays, "
        f"{size} bytes) saved and loaded into a fresh net: logits at B=32 "
        f"bit-identical; the int8 net's file keeps its {len(names)} "
        f"wrapped layers' float parameters under <layer>.src.<name>")
    return {"bytes": size, "arrays": len(mine)}


# ---------------------------------------------------------------- phase 35
LAMB = {"learning_rate": 1e-3, "wd": 0.01, "multi_precision": True}
CKPT_STEP = 3                       # run A saves after step 3 of 6
STALL_SHARE = 0.1                   # utils/checkpoint.py:18-22 (JAX package)


def _no_decay(params) -> int:
    """``wd_mult`` 0 on every bias and LayerNorm parameter (BERT's
    recipe); returns how many."""
    n = 0
    for name, p in params.items():
        if name.rsplit(".", 1)[-1] in ("bias", "gamma", "beta"):
            p.wd_mult = 0.0
            n += 1
    return n


def _state_steps(model, trainer, tokens, labels, n, per_step, tag,
                 times=None) -> list:
    """``n`` steps of bench.py's pattern, each one's launches held to
    ``per_step``; each step's wall time (synchronised) into ``times``."""
    losses = []
    for _ in range(n):
        c0, f0 = _counts(), _fwd_captures()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with autograd.record():
            loss = model(tokens, labels)
        loss.backward()
        trainer.step(1)
        torch.cuda.synchronize()
        if times is not None:
            times.append(time.perf_counter() - t0)
        losses.append(loss.detach())
        c1 = _counts()
        want = _step_launches(per_step, _fwd_captures() - f0)
        assert {k: c1[k] - c0[k] for k in per_step} == want, \
            (tag, c0, c1)
    return losses


def _lamb_state(trainer) -> dict:
    """Clones of every f32 master, m and v, by parameter index."""
    sts = [trainer._states[i] for i in sorted(trainer._states)]
    return {"masters": [s[0].clone() for s in sts],
            "m": [s[1][0].clone() for s in sts],
            "v": [s[1][1].clone() for s in sts]}


def _run_captures() -> dict:
    progs = ("fwd_record", "bwd_record", "update")
    return {k: _graphs.captures[k] for k in progs}


def phase_training_state(smi: str) -> dict:
    """Phase 35 (see the module docstring)."""
    B, T = BERT_BATCH
    per_step = _per_step(BERT["num_layers"], T)
    tokens, labels = _bert_batch(BERT["vocab_size"], B, T)
    root = tempfile.mkdtemp(prefix="mx_ckpt_")
    free = shutil.disk_usage(root).free
    launches = dict.fromkeys(per_step, 0)
    try:
        # run A: six steps, an async save after step 3
        gc.collect()
        torch.cuda.empty_cache()
        _, model, trainer = _bert_model(BERT, torch.bfloat16, 0,
                                        ("lamb", LAMB))
        n_nodecay = _no_decay(model.collect_params())
        _zero_counts()
        mx_random.seed(7, device=DEV)
        mgr = CheckpointManager(os.path.join(root, "async"), keep=2)
        a = _state_steps(model, trainer, tokens, labels, CKPT_STEP,
                         per_step, "A")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(CKPT_STEP, net=model, trainer=trainer)
        stall = time.perf_counter() - t0
        a_times = []
        a += _state_steps(model, trainer, tokens, labels, CKPT_STEP,
                          per_step, "A", a_times)
        want = _lamb_state(trainer)
        caps_a = _run_captures()
        launches = {k: launches[k] + v for k, v in _counts().items()
                    if k in launches}
        t0 = time.perf_counter()
        mgr.close()
        drain = time.perf_counter() - t0
        wrote = dict(mgr.last_write)
        assert wrote["step"] == CKPT_STEP and mgr.all_steps() == [CKPT_STEP]
        # a synchronous save of the same state (step 6's), same run
        sync = CheckpointManager(os.path.join(root, "sync"), keep=1,
                                 async_save=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sync.save(2 * CKPT_STEP, net=model, trainer=trainer)
        sync_s = time.perf_counter() - t0
        shutil.rmtree(os.path.join(root, "sync"))
        del model, trainer
        gc.collect()
        torch.cuda.empty_cache()
        # run B: fresh objects and programs, another stream, restore
        _, model, trainer = _bert_model(BERT, torch.bfloat16, 1,
                                        ("lamb", LAMB))
        _no_decay(model.collect_params())
        _zero_counts()
        mx_random.seed(12345, device=DEV)
        mx_random.next_seed()
        t0 = time.perf_counter()
        info = CheckpointManager(os.path.join(root, "async")).restore(
            net=model, trainer=trainer)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        assert info["step"] == CKPT_STEP, info
        assert trainer.optimizer.num_update == CKPT_STEP
        b_times = []
        b = _state_steps(model, trainer, tokens, labels, CKPT_STEP,
                         per_step, "B", b_times)
        got = _lamb_state(trainer)
        caps_b = _run_captures()
        launches = {k: launches[k] + v for k, v in _counts().items()
                    if k in launches}
        del model, trainer
    finally:
        shutil.rmtree(root, ignore_errors=True)
    la = torch.stack(a).float().cpu()
    lb = torch.stack(b).float().cpu()
    assert torch.isfinite(la).all(), la
    assert torch.equal(la[CKPT_STEP:], lb), (la, lb)
    for k in ("masters", "m", "v"):
        assert len(want[k]) == len(got[k]) and all(
            torch.equal(x, y) for x, y in zip(want[k], got[k])), \
            f"run B's {k} after step {2 * CKPT_STEP} differ from run A's"
    ones = dict.fromkeys(caps_a, 1)
    assert caps_a == ones and caps_b == ones, (caps_a, caps_b)
    assert stall < STALL_SHARE * sync_s, (stall, sync_s)
    out = {"bytes": wrote["bytes"], "stall_s": stall, "sync_s": sync_s,
           "write_s": wrote["seconds"], "drain_s": drain,
           "restore_s": restore_s, "a_ms": [t * 1e3 for t in a_times],
           "b_ms": [t * 1e3 for t in b_times], "launches": launches,
           "no_decay": n_nodecay, "tensors": len(want["masters"])}
    log(f"training state [{smi}]: BERT-large B={B} T={T} bf16 + f32 "
        f"masters, LAMB {LAMB} with wd_mult 0 on {n_nodecay} bias and "
        f"LayerNorm parameters, on CUDA graphs: run B restored step "
        f"{CKPT_STEP} into fresh objects and programs, and its losses "
        f"{lb.tolist()}, {out['tensors']} f32 masters, m and v after steps "
        f"{CKPT_STEP + 1}-{2 * CKPT_STEP} are bit-identical to run A's; "
        f"captures A {caps_a}, B {caps_b}; checkpoint {wrote['bytes']} "
        f"bytes; save() stalled the caller {stall * 1e3:.2f} ms against "
        f"{sync_s:.3f} s for a synchronous save of step "
        f"{2 * CKPT_STEP}'s state ({stall / sync_s:.5f}, gate "
        f"{STALL_SHARE}); the async write took {wrote['seconds']:.3f} s "
        f"(close() waited {drain:.3f} s after step {2 * CKPT_STEP}), the "
        f"restore {restore_s:.3f} s ({free} bytes free under {root} "
        f"before the phase); steps {CKPT_STEP + 1}-"
        f"{2 * CKPT_STEP} of A (the async write running) "
        f"{', '.join(f'{t:.2f}' for t in out['a_ms'])} ms, of B (capture, "
        f"replays) {', '.join(f'{t:.2f}' for t in out['b_ms'])} ms; "
        f"launches {launches}")
    return out


# ---------------------------------------------------------------- phase 36
RULES = (("sgd", {"momentum": 0.9}), ("nag", {"momentum": 0.9}),
         ("adam", {}), ("adamw", {}), ("adamax", {}), ("nadam", {}),
         ("rmsprop", {}), ("rmsprop", {"centered": True}), ("adagrad", {}),
         ("adadelta", {}), ("ftrl", {}), ("lamb", {}), ("lars", {}),
         ("dcasgd", {"momentum": 0.9}), ("signum", {"wd_lh": 0.01}),
         ("test", {}))


def _rule_steps(name, kw, weights0, groups, grads, graphed) -> list:
    """Two steps of rule ``name``'s captured update over copies of
    ``weights0``: on a CUDA graph, or its eager body.  Returns the
    weights and every state tensor after them."""
    opt = opt_mod.create(name, learning_rate=1e-3, wd=0.01,
                         multi_precision=True, **kw)
    ws = [w.clone() for w in weights0]
    states = [opt.create_state_multi_precision(i, w)
              for i, w in enumerate(ws)]
    bufs = [g.clone() for g in grads[0]]
    upd = _Update(None, opt, ws, states, groups, _graphs.Pool(DEV))
    upd.set_grads(bufs)
    sig = tuple(g.data_ptr() for g in bufs)
    with contextlib.nullcontext() if graphed else _graphs.eager():
        for step in range(2):
            torch._foreach_copy_(bufs, grads[step])
            for i in range(len(ws)):
                opt._update_count(i)
            hyper = np.asarray(opt.hyper_values(dict.fromkeys(groups)),
                               dtype=np.float32)
            upd.prog.run(sig, hyper=hyper)
    torch.cuda.synchronize()
    return [t for t in upd.targets]


def check_rules_graphed(smi: str) -> dict:
    """Phase 36 (see the module docstring)."""
    gc.collect()
    torch.cuda.empty_cache()
    mx_random.seed(0, device=DEV)
    net = BERTForPretraining(**BERT, dropout=DROPOUT, device=DEV)
    net.initialize()
    net.cast(torch.bfloat16)
    params = {n: p for n, p in net.collect_params().items()
              if p.grad_req != "null"}
    _no_decay(params)
    weights = [p.detach() for p in params.values()]
    groups = [(1.0, p.wd_mult, 0) for p in params.values()]
    g = torch.Generator(device=DEV).manual_seed(3)
    grads = [[torch.randn(w.shape, generator=g, device=DEV,
                          dtype=torch.float32).mul_(1e-2).to(torch.bfloat16)
              for w in weights] for _ in range(2)]
    done = []
    for name, kw in RULES:
        c0 = _graphs.captures["update"]
        got = _rule_steps(name, kw, weights, groups, grads, True)
        assert _graphs.captures["update"] == c0 + 1, name
        want = _rule_steps(name, kw, weights, groups, grads, False)
        bad = [i for i, (x, y) in enumerate(zip(got, want))
               if not torch.equal(x, y)]
        assert not bad and len(got) == len(want), \
            f"{name} {kw}: {len(bad)} tensors of the graphed update differ"
        assert all(torch.isfinite(t).all() for t in got[:len(weights)]), name
        done.append(f"{name}{kw or ''}")
        del got, want
        gc.collect()
        torch.cuda.empty_cache()
    log(f"the rules graphed [{smi}]: {len(done)} rules ({', '.join(done)}) "
        f"with f32 masters, wd 0.01 and wd_mult 0 on "
        f"{sum(1 for x in groups if x[1] == 0.0)} of {len(weights)} "
        f"BERT-large parameters: two steps of the captured update "
        f"(capture, replay) bit-identical to its eager body, weights and "
        f"every state tensor")
    return {"rules": done}


# ---------------------------------------------------------------- phase 9
@contextlib.contextmanager
def plain_kernels():
    """Swap every kernel's launcher for its plain version (the parity
    harness's switch; the main paths never enter it)."""
    saved = (dk_mod._mask_cuda, dk_mod._fwd_cuda, dk_mod._bwd_cuda,
             xk_mod._fwd_cuda, xk_mod._bwd_cuda, fa_mod._flash_core,
             fa_mod._flash_bwd_core, pa_mod._launch, pa_mod._launch_q8,
             ic_mod._launch)
    dk_mod._mask_cuda = lambda n, seed, rate, dev: mask_reference(
        n, seed, rate, device=dev)
    dk_mod._fwd_cuda = dropout_fwd_reference
    dk_mod._bwd_cuda = dropout_bwd_reference
    xk_mod._fwd_cuda = stats_reference
    xk_mod._bwd_cuda = dlogits_reference
    fa_mod._flash_core = _reference_attention_lse
    fa_mod._flash_bwd_core = flash_bwd_plain
    pa_mod._launch = paged_attention_dense
    pa_mod._launch_q8 = lambda q, pk, pv, sk, sv, tables, pos: \
        paged_attention_dense(q, pk, pv, tables, pos, sk, sv)
    ic_mod._launch = lambda *args, **kw: int8_conv_reference(*args[:9])
    try:
        yield
    finally:
        (dk_mod._mask_cuda, dk_mod._fwd_cuda, dk_mod._bwd_cuda,
         xk_mod._fwd_cuda, xk_mod._bwd_cuda, fa_mod._flash_core,
         fa_mod._flash_bwd_core, pa_mod._launch, pa_mod._launch_q8,
         ic_mod._launch) = saved


def _one_step(cfg, B, T, plain: bool):
    net, model, trainer = _bert_model(cfg, torch.float32, seed=1)
    tokens, labels = _bert_batch(cfg["vocab_size"], B, T, seed=1)
    c0, f0 = _counts(), _fwd_captures()
    with plain_kernels() if plain else contextlib.nullcontext():
        with autograd.record():
            loss = model(tokens, labels)
        loss.backward()
        grads = {n: p.grad.detach().clone()
                 for n, p in model.collect_params().items()
                 if p.grad is not None}
        trainer.step(1)
    torch.cuda.synchronize()
    c1 = _counts()
    # the plain run launches nothing, the kernels' run every kernel of
    # the path, as often as a main-path step that captures does
    want = {n: 0 if plain else k for n, k in _step_launches(
        _per_step(cfg["num_layers"], T), _fwd_captures() - f0).items()}
    assert {n: c1[n] - c0[n] for n in c1} == want, (plain, c0, c1)
    weights = {n: p.detach().clone()
               for n, p in model.collect_params().items()}
    return float(loss.detach()), grads, weights


def phase_train_parity(B: int, T: int) -> dict:
    cfg = dict(BERT, num_layers=2)
    loss_k, grads_k, w_k = _one_step(cfg, B, T, plain=False)
    loss_p, grads_p, w_p = _one_step(cfg, B, T, plain=True)
    assert abs(loss_k - loss_p) <= 1e-5 * abs(loss_p), (loss_k, loss_p)
    assert grads_k.keys() == grads_p.keys()

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()

    g_err = max(rel(grads_k[n], grads_p[n]) for n in grads_p)
    w_err = max(rel(w_k[n], w_p[n]) for n in w_p)
    assert g_err <= 1e-4, f"training parity: grad err {g_err}"
    assert w_err <= 1e-4, f"training parity: weight err {w_err}"
    log(f"training parity (f32, 2 layers, width {BERT['units']}, B={B} "
        f"T={T}, dropout {DROPOUT}): loss {loss_k:.7f} kernels vs "
        f"{loss_p:.7f} plain; max grad err {g_err:.2e}, max weight err "
        f"{w_err:.2e} (of each tensor's max) over {len(grads_p)} grads")
    return {"loss_err": abs(loss_k - loss_p) / abs(loss_p), "grad": g_err,
            "weight": w_err}


# ---------------------------------------------------------------- phase 10
def _bound(nbytes, flops, peak_flops):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


def sm_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi clocks.max.sm), the clock
    of the integer-multiply bound."""
    try:
        mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60).stdout.split()[0])
    except (OSError, IndexError, ValueError, subprocess.SubprocessError):
        raise SystemExit("chip_smoke: nvidia-smi gave no clocks.max.sm")
    return mhz * 1e6


def time_dropout(rec) -> dict:
    """The three dropout kernels at the inputs of the main path's first
    DropoutAdd (the forward) and its first backward, held bit for bit to
    the plain versions there and timed beside them, the old site (the
    mask kernel, then the torch apply and add, and autograd's backward of
    them) and a one-call PyTorch yardstick; bounds: the mask kernel's the
    larger of its bytes and its integer multiplies, the fused entries'
    their bytes.  The device-seed mask and forward at the same inputs,
    the seed in the slot the main path's program read, held to the
    by-value entries and the plain version bit for bit and timed beside
    them."""
    x, res, slot, rate = rec["dropout_fwd"]
    seed = int(slot)
    dy, mask, brate = rec["dropout_bwd"]
    n, e = x.numel(), x.element_size()
    y, m = dropout_fwd(x, res, seed, rate)
    ref_y, ref_m = dropout_fwd_reference(x, res, seed, rate)
    assert torch.equal(m, ref_m) and torch.equal(_bits(y), _bits(ref_y)), \
        "dropout forward at main-path inputs differs"
    dx = dropout_bwd(dy, mask, brate)
    ref_dx = dropout_bwd_reference(dy, mask, brate)
    assert torch.equal(_bits(dx), _bits(ref_dx)), \
        "dropout backward at main-path inputs differs"
    assert torch.equal(dropout_mask(x, seed, rate).view(-1),
                       mask_reference(n, seed, rate, device=x.device)), \
        "dropout mask at main-path inputs differs"
    dev_y, dev_m = dropout_fwd_dev(x, res, slot, rate)
    assert torch.equal(dev_m, m) and torch.equal(_bits(dev_y), _bits(y)) \
        and torch.equal(dropout_mask_dev(x, slot, rate), m), \
        "device-seed dropout at main-path inputs differs"
    clock = sm_clock_hz()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    int_peak = sms * INT_MULS_PER_CLOCK_SM * clock
    muls = (n + 3) // 4 * PHILOX_MULS
    shape = f"{tuple(x.shape)} {x.dtype} rate={rate}"
    out = {}
    bound, by = _bound(n, muls, int_peak)
    out["dropout_mask"] = {
        "shape": shape, "max_abs_err": 0.0,
        "ms": time_ms(lambda: dropout_mask(x, seed, rate)),
        "plain_ms": time_ms(lambda: mask_reference(n, seed, rate,
                                                   device=x.device)),
        "library_ms": time_ms(lambda: torch.empty(
            n, dtype=torch.uint8, device=x.device).bernoulli_(1 - rate)),
        "bound_ms": bound, "bound_by": by,
        "bytes_ms": n / HBM_BYTES_PER_S * 1e3,
        "ops_ms": muls / int_peak * 1e3, "sm_clock_mhz": clock / 1e6,
        "sms": sms}
    bound, by = _bound(n * (3 * e + 1), muls, int_peak)
    out["dropout_fwd"] = {
        "shape": shape + " + residual", "max_abs_err": 0.0,
        "ms": time_ms(lambda: dropout_fwd(x, res, seed, rate)),
        "plain_ms": time_ms(lambda: dropout_fwd_reference(x, res, seed,
                                                          rate)),
        "old_ms": time_ms(lambda: res + dk_mod._apply_mask(
            x, dropout_mask(x, seed, rate), rate)),
        "library_ms": time_ms(lambda: F.dropout(x, rate) + res),
        "bound_ms": bound, "bound_by": by}
    # the seed read from device memory: 8 more bytes
    bound, by = _bound(n * (3 * e + 1) + 8, muls, int_peak)
    out["dropout_fwd_dev"] = dict(
        out["dropout_fwd"], bound_ms=bound, bound_by=by,
        by_value_ms=out["dropout_fwd"]["ms"],
        ms=time_ms(lambda: dropout_fwd_dev(x, res, slot, rate)),
        plain_ms=time_ms(lambda: dropout_fwd_reference(x, res, slot, rate)))
    out["dropout_fwd_dev"].pop("old_ms")
    bound, by = _bound(n + 8, muls, int_peak)
    out["dropout_mask_dev"] = dict(
        out["dropout_mask"], bound_ms=bound, bound_by=by,
        by_value_ms=out["dropout_mask"]["ms"],
        ms=time_ms(lambda: dropout_mask_dev(x, slot, rate)),
        plain_ms=time_ms(lambda: mask_reference(n, slot, rate,
                                                device=x.device)))
    # the old backward: autograd through the apply and the add
    xr = x.detach().requires_grad_()
    old = res + dk_mod._apply_mask(xr, mask, brate)
    bound, by = _bound(n * (2 * e + 1), 0, PEAK_FLOPS[torch.float32])
    out["dropout_bwd"] = {
        "shape": f"{tuple(dy.shape)} {dy.dtype} rate={brate}",
        "max_abs_err": 0.0,
        "ms": time_ms(lambda: dropout_bwd(dy, mask, brate)),
        "plain_ms": time_ms(lambda: dropout_bwd_reference(dy, mask, brate)),
        "old_ms": time_ms(lambda: torch.autograd.grad(
            old, xr, dy, retain_graph=True)),
        "library_ms": time_ms(lambda: torch.ops.aten.native_dropout_backward(
            dy, mask.view(torch.bool), dk_mod._scale(brate, dy.dtype))),
        "bound_ms": bound, "bound_by": by}
    # what any one launch costs in `time_ms`: a one-element fill
    one = torch.empty(1, device=x.device)
    out["launch_floor_ms"] = time_ms(lambda: one.fill_(0.0))
    return out


def time_training_kernels(tres) -> dict:
    rec = tres["rec"]
    (x2, want_sum), (bx, labels, lse, g, eps) = rec["fwd"], rec["bwd"]
    out = time_xent(x2, want_sum, bx, labels, lse, g, eps, "main-path")
    out.update(time_dropout(rec))
    return out


def time_xent(x2, want_sum, bx, labels, lse, g, eps, tag) -> dict:
    """The cross-entropy kernels at one forward's and one backward's
    inputs: held to the plain versions there, timed beside them,
    ``F.cross_entropy`` (forward; its autograd backward) and the bound
    (bytes, or 4 f32 operations an element)."""
    N, V = x2.shape
    out = {}
    # forward: read (N, V) once, write lse; ~4 f32 ops an element
    ref_lse, _ = stats_reference(x2, want_sum)
    err = ((xent_forward(x2, want_sum)[0] - ref_lse).abs()
           / ref_lse.abs().clamp(min=1)).max().item()
    assert err <= LSE_RTOL, f"xent forward at {tag} inputs: err {err}"
    del ref_lse
    bound, by = _bound(x2.numel() * x2.element_size() + N * 4, 4 * N * V,
                       PEAK_FLOPS[torch.float32])
    out["xent_forward"] = {
        "shape": f"({N}, {V}) {x2.dtype}", "max_abs_err": err,
        "ms": time_ms(lambda: xent_forward(x2, want_sum)),
        "plain_ms": time_ms(lambda: stats_reference(x2, want_sum)),
        "library_ms": time_ms(lambda: F.cross_entropy(
            x2, labels, reduction="none")),
        "bound_ms": bound, "bound_by": by}
    # backward: read (N, V) and the row vectors once, write (N, V)
    err = check_dlogits(xent_backward(bx, labels, lse, g, eps),
                        dlogits_reference(bx, labels, lse, g, eps), bx,
                        labels, g, eps, f"xent backward at {tag} inputs")
    xr = bx.detach().requires_grad_()
    ce = F.cross_entropy(xr, labels, reduction="none")
    bound, by = _bound(2 * bx.numel() * bx.element_size() + N * 12,
                       4 * N * V, PEAK_FLOPS[torch.float32])
    out["xent_backward"] = {
        "shape": f"({N}, {V}) {bx.dtype}", "max_abs_err": err,
        "ms": time_ms(lambda: xent_backward(bx, labels, lse, g, eps)),
        "plain_ms": time_ms(lambda: dlogits_reference(bx, labels, lse, g,
                                                      eps)),
        "library_ms": time_ms(lambda: torch.autograd.grad(
            ce, xr, g.to(ce.dtype), retain_graph=True)),
        "bound_ms": bound, "bound_by": by}
    return out


def _live_pairs(Tq, Tk, causal) -> int:
    """(query, key) pairs a row sees: all, or causal bottom-right."""
    if not causal:
        return Tq * Tk
    return int(np.clip(np.arange(Tq) + (Tk - Tq) + 1, 0, Tk).sum())


def time_flash_bwd(q, k, v, do, lse, delta, causal, scale, tag) -> dict:
    """The dK/dV and dQ kernels at one backward call's inputs: held to
    the plain version there (`BWD_TOL`), timed beside it, SDPA's
    backward (timed alone, a yardstick the port never calls) and the
    bound: 8 (dK/dV) or 6 (dQ) flops x B·H·D per live (query, key) pair
    over 989 TFLOP/s, against reading q, k, v, dO, lse, Δ and writing
    dk, dv or dq once over 3.35 TB/s."""
    B, H, Tq, D = q.shape
    assert Tq == k.shape[2] or not causal   # SDPA's causal mask is top-left
    args = (q, k, v, do, lse, delta, causal, scale)
    got = (flash_bwd_dq(*args),) + tuple(flash_bwd_dkdv(*args))
    err = check_bwd_grads(got, *args, f"flash bwd at {tag} inputs")
    el = q.element_size()
    in_bytes = (q.numel() + k.numel() + v.numel() + do.numel()) * el \
        + 2 * B * H * Tq * 4
    pairs = B * H * D * _live_pairs(Tq, k.shape[2], causal)
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    so = F.scaled_dot_product_attention(qr, kr, vr, is_causal=causal,
                                        scale=scale)
    plain_ms = time_ms(lambda: flash_bwd_plain(*args))
    out = {}
    for name, fn, outs, n_flops, wrt in (
            ("flash_bwd_dkdv", flash_bwd_dkdv, (k, v), 8, (kr, vr)),
            ("flash_bwd_dq", flash_bwd_dq, (q,), 6, (qr,))):
        bound, by = _bound(in_bytes + sum(t.numel() for t in outs) * el,
                           n_flops * pairs, PEAK_FLOPS[q.dtype])
        out[name] = {
            "shape": f"q {tuple(q.shape)} k {tuple(k.shape)} "
                     f"causal={causal} {q.dtype}",
            "max_abs_err": err,
            "ms": time_ms(lambda: fn(*args)),
            "plain_ms": plain_ms,
            "library_ms": time_ms(lambda: torch.autograd.grad(
                so, wrt, do, retain_graph=True)),
            "bound_ms": bound, "bound_by": by}
    return out


def time_flash_training(tres) -> dict:
    """The flash kernels at the inputs the T=512 main path gave them
    (the first backward call of step 1: the last layer's)."""
    q, k, v, do, lse, delta, causal, scale = tres["rec"]["flash_bwd"]
    q, k, v = (t.detach() for t in (q, k, v))
    out = {"flash_attention": time_flash_fwd(q, k, v, causal, scale,
                                             "T=512 main-path")}
    out.update(time_flash_bwd(q, k, v, do, lse, delta, causal, scale,
                              "T=512 main-path"))
    return out


# long-context causal attention (benchmark/longctx_bench.py's T >= 2048
# at generate_bench's 16 heads of 64)
LONGCTX_SHAPE = (1, 16, 2048, 64)
# TransformerLM at generate_bench width, cut to 2 layers, for the causal
# backward through the model
LM_CAUSAL = dict(vocab=32000, units=1024, hidden_size=4096, num_layers=2,
                 num_heads=16, max_len=2048)
# parameter gradients through the flash backward kernels against the
# same step with the plain backward (same forward kernels): each
# tensor's max difference over its max magnitude.  The two differ by the
# bf16 rounding of dq, dk, dv (a few 2^-8 relative) carried back
# through one bf16 layer
LM_GRAD_TOL = 5e-2


def time_flash_longctx() -> dict:
    """The forward and both backward kernels at the long-context causal
    shape, bf16: held to the plain versions (the forward's out within
    TOL, its lse within 1e-4) and timed beside SDPA ``is_causal=True``'s
    forward or backward and the causal bound (live pairs only)."""
    g = torch.Generator().manual_seed(4)
    q, k, v, do = (torch.randn(LONGCTX_SHAPE, generator=g).to(
        DEV, torch.bfloat16) for _ in range(4))
    scale = 1.0 / math.sqrt(LONGCTX_SHAPE[3])
    out, lse = _reference_attention_lse(q, k, v, True, scale)
    # the forward: out within TOL (in time_flash_fwd), lse within 1e-4
    fwd_lse = flash_attention_with_lse(q, k, v, True, scale)[1]
    lse_err = (fwd_lse - lse).abs().max().item()
    assert lse_err <= 1e-4, f"flash at long-context causal: lse err {lse_err}"
    res = {"flash_attention": dict(
        time_flash_fwd(q, k, v, True, scale, "long-context causal"),
        lse_err=lse_err)}
    delta = (do.float() * out.float()).sum(-1)
    res.update(time_flash_bwd(q, k, v, do, lse, delta, True, scale,
                              "long-context causal"))
    return res


def phase_lm_causal(smi: str) -> dict:
    """The causal caller of the flash backward: a trainable 2-layer
    TransformerLM at generate_bench width (D=64) in bf16 from seed 0,
    one (1, 2048) sequence, next-token cross-entropy, ``loss.backward()``
    through the flash kernels.  Each layer's backward call is held to
    the plain version at its inputs (`BWD_TOL`), and every parameter
    gradient to the same step with the plain backward (`LM_GRAD_TOL`)."""
    net = TransformerLM(**LM_CAUSAL, dropout=0.0, device=DEV, seed=0)
    net.cast(torch.bfloat16)
    T = LM_CAUSAL["max_len"]
    g = torch.Generator().manual_seed(0)
    toks = torch.randint(0, LM_CAUSAL["vocab"], (1, T), generator=g).to(DEV)

    def run():
        with autograd.record():
            logits = net(toks)
            loss = F.cross_entropy(logits[0, :-1].float(), toks[0, 1:])
        loss.backward()
        return float(loss.detach()), {n: p.grad.detach().clone()
                             for n, p in net.named_parameters()}

    calls = []
    # the counts start from 0 here and are read right after the step
    for name in FLASH_KERNELS:
        KERNELS[name]["fn"].launches = 0
    with recording(fa_mod, "_flash_bwd_core",
                   lambda args, kw: calls.append(args)):
        loss_k, grads_k = run()
    torch.cuda.synchronize()
    launches = {n: KERNELS[n]["fn"].launches for n in FLASH_KERNELS}
    L = LM_CAUSAL["num_layers"]
    assert launches == {n: L for n in FLASH_KERNELS}, launches
    assert len(calls) == L and all(a[6] for a in calls)      # causal
    err = max(check_bwd_grads(
        (flash_bwd_dq(*a),) + tuple(flash_bwd_dkdv(*a)), *a,
        f"TransformerLM causal layer call {i}") for i, a in enumerate(calls))
    saved = fa_mod._flash_bwd_core
    fa_mod._flash_bwd_core = flash_bwd_plain
    try:
        loss_p, grads_p = run()
    finally:
        fa_mod._flash_bwd_core = saved
    assert loss_k == loss_p, (loss_k, loss_p)
    rel = max(((grads_k[n].float() - grads_p[n].float()).abs().max()
               / grads_p[n].float().abs().max().clamp(min=1e-30)).item()
              for n in grads_p)
    assert math.isfinite(loss_k) and rel <= LM_GRAD_TOL, (loss_k, rel)
    log(f"TransformerLM causal backward [{smi}]: {LM_CAUSAL} bf16, (1, {T}) "
        f"tokens, loss {loss_k:.4f}; {L} layer calls within BWD_TOL of the "
        f"plain version (max err {err:.3g}); parameter grads within "
        f"{rel:.3g} of the plain-backward step (tolerance {LM_GRAD_TOL} of "
        f"each tensor's max) over {len(grads_p)} tensors")
    return {"err": err, "grad_rel": rel, "loss": loss_k,
            "launches": launches}


# ------------------------------------------------------------ phases 37-41
# benchmark/longctx_bench.py: TransformerLM V=32000, D=1024, FFN 4096,
# L=12, H=16, dropout 0.1, bf16 over f32 masters, SGD momentum 0.9,
# keep_grads=False; T in {2048, 8192, 32768} at B = 16384 // T without
# remat, and T=65536 (B=1, max_len=65536) with remat_backward, as the
# bench turns it on above 32768.  Nothing is cut
LONGCTX = dict(vocab=32000, units=1024, hidden_size=4096, num_layers=12,
               num_heads=16, dropout=0.1)
LONGCTX_RUNS = ((2048, 8, False), (8192, 2, False), (32768, 1, False),
                (65536, 1, True))
LONGCTX_WARMUP, LONGCTX_STEPS = 2, 3
# the flash kernels against the chunked plain version at these lengths,
# (1, 16, T, 64) bf16 causal
LONGCTX_KERNEL_T = (8192, 32768, 65536)
LONGCTX_ROWS = 1024                 # query rows a block of the plain version
LONGCTX_SCORE_T = 32768             # lm_score's sequence, on the T=65536 net


def _lm_per_step(L, remat) -> dict:
    """Launches of each kernel in one long-context step: a layer's three
    dropout sites (two DropoutAdds, the FFN's output dropout) and its
    causal flash attention, the loss's cross-entropy; with remat the
    backward program runs the forward again."""
    fwd = 2 if remat else 1
    return {"dropout_mask": 0, "dropout_mask_dev": 0, "dropout_fwd": 0,
            "dropout_fwd_dev": 3 * L * fwd, "dropout_bwd": 3 * L,
            "xent_forward": fwd, "xent_backward": 1,
            "flash_attention": L * fwd, "flash_bwd_dkdv": L,
            "flash_bwd_dq": L}


def _lm_model(T, remat, seed=0):
    """longctx_bench.py's model at max_len T from ``seed`` on the card,
    cast to bf16, its loss block hybridized (with ``remat``), the fused
    SGD-momentum Trainer over f32 masters."""
    net = TransformerLM(**LONGCTX, max_len=T, device=DEV, seed=seed)
    net.cast(torch.bfloat16)
    model = LMWithLoss(net)
    model.hybridize(remat_backward=remat)
    trainer = Trainer(model.collect_params(), "sgd", dict(SGD),
                      keep_grads=False)
    return net, model, trainer


def _lm_flops(net, T):
    """longctx_bench.py's count a token: 6·(N − V·D) + 12·L·T·D (the
    output head a real matmul; attention's full T², not its causal
    half)."""
    n = sum(p.numel() for p in net.collect_params().values()
            if p.grad_req != "null")
    V, D, L = LONGCTX["vocab"], LONGCTX["units"], LONGCTX["num_layers"]
    return 6 * (n - V * D) + 12 * L * T * D


def _lm_kinds(busy) -> dict:
    """Card ms of a profiled step by kind of kernel."""
    kinds = (("flash", ("fwd_kernel", "flash_fwd", "dkdv_kernel",
                        "dq_kernel")),
             ("dropout", ("dropout_kernel",)),
             ("xent", ("xent_",)),
             ("gemm", ("gemm", "nvjet", "cutlass", "sm90_")),
             ("multi_tensor_apply", ("multi_tensor_apply",)))
    out = dict.fromkeys([k for k, _ in kinds] + ["other"], 0.0)
    for name, ms in busy["by_name"].items():
        kind = next((k for k, keys in kinds
                     if any(s in name for s in keys)), "other")
        out[kind] += ms
    return out


def _lm_run(T, B, remat, smi, steps=None, seed=7, keep_net=False):
    """``steps`` (default 2 warm-up + 3 timed) of longctx_bench.py's
    loop at (B, T) from ``random.seed(seed)``, each step's launches held
    to `_lm_per_step`; then (with the default steps) one profiled step.
    Returns the losses, host copies of the f32 masters and momenta, the
    numbers (the peak, and what was allocated before the run), and
    with ``keep_net`` the net (its programs dropped)."""
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    L = LONGCTX["num_layers"]
    t0 = time.perf_counter()
    net, model, trainer = _lm_model(T, remat)
    tokens, labels = _bert_batch(LONGCTX["vocab"], B, T)
    torch.cuda.synchronize()
    built_s = time.perf_counter() - t0
    per_step = _lm_per_step(L, remat)
    names = ("fwd_remat", "bwd_remat", "update") if remat \
        else ("fwd_record", "bwd_record", "update")
    timed = steps is None
    n_steps = LONGCTX_WARMUP + LONGCTX_STEPS if timed else steps

    def step():
        with autograd.record():
            loss = model(tokens, labels)
        loss.backward()
        trainer.step(1)
        return loss.detach()

    _zero_counts()
    mx_random.seed(seed, device=DEV)
    torch.cuda.reset_peak_memory_stats()
    losses, each = [], []
    for _ in range(n_steps):
        c0, f0 = _counts(), _fwd_captures()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses.append(step())
        torch.cuda.synchronize()
        each.append(time.perf_counter() - t1)
        c1 = _counts()
        want = _step_launches(per_step, _fwd_captures() - f0)
        assert {n: c1[n] - c0[n] for n in per_step} == want, \
            (T, remat, c0, c1)
    peak = torch.cuda.max_memory_allocated()
    loss_vals = torch.stack(losses).float().cpu()
    caps = {k: _graphs.captures.get(k, 0) for k in names}
    reps = {k: _graphs.replays.get(k, 0) for k in names}
    assert caps == dict.fromkeys(names, 1), (T, caps)
    extra = 0 if remat else 1           # F's capturing call replays it
    assert reps == {names[0]: n_steps - 1 + extra, names[1]: n_steps - 1,
                    names[2]: n_steps - 1}, (T, reps)
    assert torch.isfinite(loss_vals).all(), (T, loss_vals)
    states = [trainer._states[i] for i in sorted(trainer._states)]
    # on the host: a later run's peak does not count them
    out = {"T": T, "B": B, "remat": remat, "losses": loss_vals,
           "masters": [s[0].cpu() for s in states],
           "moms": [s[1].cpu() for s in states],
           "peak_bytes": peak, "base_bytes": base,
           "step_ms": [t * 1e3 for t in each],
           "launches": _counts(), "captures": caps, "replays": reps,
           "built_s": built_s, "pe_in_program": net._pe is None}
    del states
    if timed:
        # falling or flat: the last timed step's loss no higher than the
        # first step's by more than a bf16 rounding of it
        assert loss_vals[-1] <= loss_vals[0] * (1 + 2 ** -8), \
            (T, loss_vals)
        dt = sum(each[LONGCTX_WARMUP:]) / LONGCTX_STEPS
        fpt = _lm_flops(net, T)
        tok_s = B * T / dt
        name = torch.cuda.get_device_name(0)
        peak_flops = PEAK_FLOPS[torch.bfloat16] \
            if "H100" in name and "PCIe" not in name else None
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            prof_s = time.perf_counter() - t1
        busy = device_busy(prof, prof_s)
        out.update(step_s=dt, tok_s=tok_s, flops_per_token=fpt,
                   mfu=tok_s * fpt / peak_flops if peak_flops else None,
                   busy=busy["busy_share"], card_ms=busy["busy_s"] * 1e3,
                   prof_ms=prof_s * 1e3, kernels=busy["kernels"],
                   kinds=_lm_kinds(busy), top=busy["top"])
        out["launches"] = _counts()
    if keep_net:
        model._invalidate_cached_program()
        out["net"] = net
    del model, trainer
    return out


def phase_longctx_training(smi: str) -> dict:
    """Phase 37: longctx_bench.py's training at full width on CUDA
    graphs, T = 2048 (B=8), 8192 (B=2), 32768 (B=1) without remat and
    65536 (B=1) with it: finite, falling-or-flat losses, one capture of
    each program then replays, each step's launches as `_lm_per_step`
    says; step ms, tokens/s, MFU, peak memory, the busy share and the
    card time by kind of kernel of one profiled step."""
    runs, launches = {}, {}
    for T, B, remat in LONGCTX_RUNS:
        r = _lm_run(T, B, remat, smi, keep_net=remat)
        runs[T] = r
        for n, c in r["launches"].items():
            launches[n] = launches.get(n, 0) + c
        kinds = r["kinds"]
        log(f"long-context training [{smi}]: TransformerLM {LONGCTX} bf16 "
            f"+ f32 masters, T={T} B={B}" + (", remat_backward=True" if remat
                                             else "")
            + f" (max_len {T}, the positional encoding computed in the "
            f"program: {r['pe_in_program']}), built in "
            f"{r['built_s']:.1f} s; on CUDA graphs "
            f"(captures {r['captures']}, replays {r['replays']}); step "
            f"{r['step_s'] * 1e3:.2f} ms (mean of {LONGCTX_STEPS} after "
            f"{LONGCTX_WARMUP}; each synchronised: "
            f"{', '.join(f'{t:.2f}' for t in r['step_ms'])}), "
            f"{r['tok_s']:.1f} tokens/s, MFU "
            + (f"{r['mfu']:.4f} of 989 TFLOP/s bf16" if r["mfu"]
               else "not measured (no peak known for this card)")
            + f" ({r['flops_per_token']} flop/token by longctx_bench.py's "
            f"count, which takes attention's full T², not its causal "
            f"half), peak memory {r['peak_bytes'] / 2**30:.2f} GiB "
            f"({r['peak_bytes']} B; {r['base_bytes']} B allocated before "
            f"the run); losses {r['losses'].tolist()}; one "
            f"profiled step {r['prof_ms']:.1f} ms wall, card busy "
            f"{r['card_ms']:.1f} ms = {r['busy']:.3f}, {r['kernels']} "
            f"kernels; card ms by kind: "
            + ", ".join(f"{k} {v:.2f}" for k, v in kinds.items())
            + "; top kernels: " + "; ".join(f"{n} {ms:.3f}"
                                            for n, ms in r["top"]))
    net = runs[LONGCTX_RUNS[-1][0]].pop("net")
    return {"runs": {T: {k: v for k, v in r.items()
                         if k not in ("masters", "moms")}
                     for T, r in runs.items()},
            "launches": launches, "net": net}


REMAT_PARITY_RUNS = ((8192, 2), (65536, 1))


def phase_remat_parity(smi: str) -> dict:
    """Phase 38: remat against no remat at full width, dropout 0.1,
    three steps each from the same seed and weights, at T=8192 (B=2)
    and T=65536 (B=1): the same losses, f32 masters and momenta, bit
    for bit (the recomputed forward draws the forward's seeds); both
    peaks, above what was allocated before each run, and step times.
    A run that runs out of memory is reported as such."""
    out = {}
    for T, B in REMAT_PARITY_RUNS:
        got = {}
        for remat in (False, True):
            try:
                got[remat] = _lm_run(T, B, remat, smi, steps=3)
            except torch.OutOfMemoryError as e:
                got[remat] = None
                gc.collect()
                torch.cuda.empty_cache()
                log(f"remat parity [{smi}]: T={T} B={B} remat={remat} ran "
                    f"out of memory: {str(e).splitlines()[0]}")
        a, b = got[False], got[True]
        assert b is not None, f"T={T}: remat ran out of memory"
        if a is None:
            out[T] = {"peak": (None, b["peak_bytes"] - b["base_bytes"]),
                      "step_ms": (None, b["step_ms"]),
                      "launches": b["launches"]}
            continue
        assert torch.equal(a["losses"], b["losses"]), \
            (T, a["losses"], b["losses"])
        diffs = [(x.float() - y.float()).abs().max().item()
                 for x, y in zip(a["masters"] + a["moms"],
                                 b["masters"] + b["moms"])]
        assert max(diffs) == 0.0, \
            (f"T={T}: remat differs from no remat: largest {max(diffs)}, "
             f"first at tensor {next(i for i, d in enumerate(diffs) if d)}")
        peaks = [r["peak_bytes"] - r["base_bytes"] for r in (a, b)]
        log(f"remat parity [{smi}]: TransformerLM full width, T={T} B={B}, "
            f"dropout {LONGCTX['dropout']}, 3 steps: remat_backward=True "
            f"gives the losses {b['losses'].tolist()} and the "
            f"{len(a['masters'])} f32 masters and momenta of the step "
            f"without it, bit for bit; peak memory above what was "
            f"allocated before the run ({a['base_bytes'] / 2**30:.2f} and "
            f"{b['base_bytes'] / 2**30:.2f} GiB) "
            f"{peaks[0] / 2**30:.2f} GiB without remat, "
            f"{peaks[1] / 2**30:.2f} GiB with; steps (capture, replay, "
            f"replay) {', '.join(f'{t:.2f}' for t in a['step_ms'])} ms "
            f"without, {', '.join(f'{t:.2f}' for t in b['step_ms'])} ms "
            f"with (replay overhead "
            f"{b['step_ms'][-1] / a['step_ms'][-1]:.3f}x)")
        out[T] = {"peak": tuple(peaks),
                  "step_ms": (a["step_ms"], b["step_ms"]),
                  "launches": {n: a["launches"][n] + b["launches"][n]
                               for n in a["launches"]}}
    launches = {}
    for r in out.values():
        for n, c in r["launches"].items():
            launches[n] = launches.get(n, 0) + c
    return {"runs": out, "launches": launches}


def check_bwd_grads_chunked(got, q, k, v, do, lse, delta, scale, tag):
    """`check_bwd_grads` at long T: the reference is `flash_bwd_chunked`
    (no (T, T) tensor), the rule and the wrong answers the same."""
    tol = BWD_TOL[q.dtype]
    ch = fa_mod.flash_bwd_chunked
    args = (q, k, v, do)
    ref = ch(*args, lse, delta, True, scale, rows=LONGCTX_ROWS)
    no_delta = ch(*args, lse, torch.zeros_like(delta), True, scale,
                  rows=LONGCTX_ROWS)
    lse_1 = ch(*args, lse + 1, delta, True, scale, rows=LONGCTX_ROWS)
    bad = {"dq": no_delta[0], "dk": no_delta[1], "dv": lse_1[2]}
    err = {}
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape, f"{tag}: {name}"
        ex = _excess(g, r, tol)
        assert ex <= 1.0, f"{tag}: {name} {ex:.3g}x its allowance"
        for w, what in ((torch.zeros_like(r), "zeroed"),
                        (bad[name], "wrong-term")):
            assert _excess(w, r, tol) > 1.0, \
                f"{tag}: a {what} {name} would pass the bound"
        err[name] = (g.float() - r.float()).abs().max().item()
    del ref, no_delta, lse_1, bad
    return err


def time_flash_long(T) -> dict:
    """Phase 39 at one length: the forward and both backward kernels at
    (1, 16, T, 64) bf16 causal against the chunked plain version (out
    by `FWD_ROW_TOL`, an out with its later half of rows zeroed or
    halved or its last eighth scaled by 0.9 failing it; lse within
    1e-4; dq, dk, dv by `BWD_TOL`), timed with CUDA events beside the
    plain version, SDPA ``is_causal`` (forward, and its backward alone)
    and the causal bound."""
    shape = (1, 16, T, 64)
    g = torch.Generator().manual_seed(T)
    q, k, v, do = (torch.randn(shape, generator=g).to(DEV, torch.bfloat16)
                   for _ in range(4))
    scale = 1.0 / math.sqrt(64)
    out, lse = flash_attention_with_lse(q, k, v, True, scale)
    ref, ref_lse = fa_mod.attention_chunked(q, k, v, True, scale,
                                            rows=LONGCTX_ROWS)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    excess = _row_excess(out, ref, FWD_ROW_TOL)
    lse_err = (lse - ref_lse).abs().max().item()
    tag = f"flash at (1, 16, {T}, 64) causal"
    assert excess <= 1.0, f"{tag}: out {excess:.3g}x its allowance"
    assert lse_err <= 1e-4, f"{tag}: lse err {lse_err}"
    # the late rows, whose causal tiles this checks, are held too
    for what, first, factor in (("half zeroed", T // 2, 0.0),
                                ("half halved", T // 2, 0.5),
                                ("last eighth scaled by 0.9", T - T // 8,
                                 0.9)):
        wrong = out.clone()
        wrong[:, :, first:] *= factor
        assert _row_excess(wrong, ref, FWD_ROW_TOL) > 1.0, \
            f"{tag}: an out with its later rows {what} would pass"
        del wrong
    del ref, ref_lse
    delta = (do.float() * out.float()).sum(-1)
    args = (q, k, v, do, lse, delta, True, scale)
    got = (flash_bwd_dq(*args),) + tuple(flash_bwd_dkdv(*args))
    berr = check_bwd_grads_chunked(got, q, k, v, do, lse, delta, scale,
                                   f"flash bwd at (1, 16, {T}, 64)")
    del got
    pairs = 16 * 64 * _live_pairs(T, T, True)
    el = q.element_size()
    # the plain versions take seconds a call at these lengths
    plain_fwd = time_ms(lambda: fa_mod.attention_chunked(
        q, k, v, True, scale, rows=LONGCTX_ROWS), iters=3, warmup=1)
    plain_bwd = time_ms(lambda: fa_mod.flash_bwd_chunked(
        *args[:7], scale, rows=LONGCTX_ROWS), iters=3, warmup=1)
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    so = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True,
                                        scale=scale)
    fwd_bound = _bound((2 * q.numel() + k.numel() + v.numel()) * el
                       + 16 * T * 4, 4 * pairs, PEAK_FLOPS[torch.bfloat16])
    in_bytes = 4 * q.numel() * el + 2 * 16 * T * 4
    res = {"flash_attention": {
        "ms": time_ms(lambda: flash_attention_with_lse(q, k, v, True,
                                                       scale)),
        "plain_ms": plain_fwd,
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale)),
        "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1],
        "max_abs_err": err, "excess": excess, "lse_err": lse_err}}
    for name, fn, outs, n_flops, wrt in (
            ("flash_bwd_dkdv", flash_bwd_dkdv, 2, 8, (kr, vr)),
            ("flash_bwd_dq", flash_bwd_dq, 1, 6, (qr,))):
        bound, by = _bound(in_bytes + outs * q.numel() * el,
                           n_flops * pairs, PEAK_FLOPS[torch.bfloat16])
        res[name] = {
            "ms": time_ms(lambda: fn(*args)), "plain_ms": plain_bwd,
            "library_ms": time_ms(lambda: torch.autograd.grad(
                so, wrt, do, retain_graph=True)),
            "bound_ms": bound, "bound_by": by,
            "max_abs_err": max(berr.values()), "err": berr}
    del so, qr, kr, vr
    return res


def time_xent_long(N) -> dict:
    """The cross-entropy kernels at phase 37's loss shape (N, 32000) bf16,
    N = B·T: logits of the scale a random net gives, uniform labels, the
    mean's row gradients 1/N (`time_xent`)."""
    g = torch.Generator().manual_seed(N)
    V = LONGCTX["vocab"]
    x2 = torch.randn((N, V), generator=g).to(DEV, torch.bfloat16)
    labels = torch.randint(0, V, (N,), generator=g).to(DEV)
    lse = stats_reference(x2, False)[0]
    rows = torch.full((N,), 1.0 / N, device=DEV)
    return time_xent(x2, False, x2, labels, lse, rows, 0.0,
                     f"({N}, {V}) long-context")


def phase_longctx_kernels(smi: str) -> dict:
    """Phase 39: `time_flash_long` at each of `LONGCTX_KERNEL_T`, and
    `time_xent_long` at each of phase 37's B·T."""
    out = {"flash": {}, "xent": {}}
    for N in sorted({B * T for T, B, _ in LONGCTX_RUNS}):
        gc.collect()
        torch.cuda.empty_cache()
        out["xent"][N] = r = time_xent_long(N)
        for name, x in r.items():
            half = "forward" if name == "xent_forward" else "backward"
            log(f"{name} at ({N}, {LONGCTX['vocab']}) bf16 [{smi}]: "
                f"{x['ms']:.4f} ms, plain {x['plain_ms']:.4f} ms, "
                f"F.cross_entropy {half} {x['library_ms']:.4f} ms, bound "
                f"{x['bound_ms']:.4f} ms ({x['bound_by']}; "
                f"{x['bound_ms'] / x['ms']:.3f} of it); max err "
                f"{x['max_abs_err']:.3g}")
    for T in LONGCTX_KERNEL_T:
        gc.collect()
        torch.cuda.empty_cache()
        out["flash"][T] = r = time_flash_long(T)
        for name, x in r.items():
            log(f"{name} at (1, 16, {T}, 64) bf16 causal [{smi}]: "
                f"{x['ms']:.4f} ms, chunked plain {x['plain_ms']:.1f} ms, "
                f"SDPA is_causal "
                f"{'forward' if name == 'flash_attention' else 'backward'} "
                f"{x['library_ms']:.4f} ms, causal bound "
                f"{x['bound_ms']:.4f} ms ({x['bound_by']}; "
                f"{x['bound_ms'] / x['ms']:.3f} of it); max err "
                f"{x['max_abs_err']:.3g}"
                + (f" ({x['excess']:.3f} of its row-relative allowance "
                   f"{FWD_ROW_TOL}), lse err {x['lse_err']:.3g}"
                   if "lse_err" in x else f" {x['err']}"))
    return out


def phase_lm_score_long(smi: str, net) -> dict:
    """Phase 40: `lm_score` at (1, 32768) on phase 37's T=65536 net (no
    positional table: the score's width-32768 table from the net's
    LRU): the graphed call against its eager body bit for bit, one
    capture then replays; call ms, tokens/s and the perplexity."""
    T = LONGCTX_SCORE_T
    g = torch.Generator().manual_seed(3)
    toks = torch.randint(0, LONGCTX["vocab"], (1, T), generator=g).to(DEV)
    assert net._pe is None
    _graphs.reset_counts()
    for n in FLASH_KERNELS:
        KERNELS[n]["fn"].launches = 0
    first = gen_mod.lm_score(net, toks)
    again = gen_mod.lm_score(net, toks)
    with _graphs.eager():
        eager = gen_mod.lm_score(net, toks)
    torch.cuda.synchronize()
    assert _graphs.captures["score"] == 1 \
        and _graphs.replays["score"] == 1, \
        (dict(_graphs.captures), dict(_graphs.replays))
    assert torch.equal(first, eager) and torch.equal(again, eager), \
        "lm_score: the graphed call differs from its eager body"
    assert first.shape == (1, T - 1) and torch.isfinite(first).all()
    assert T in net._pe_cache
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen_mod.lm_score(net, toks)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    dt = sum(times) / 3
    ppl = float(torch.exp(-first.mean()))
    launches = {n: _graphs.launches(KERNELS[n]["fn"]) for n in FLASH_KERNELS}
    L = LONGCTX["num_layers"]
    # two captured-program calls and three timed ones replay, one eager
    assert launches["flash_attention"] == 6 * L, launches
    log(f"lm_score at (1, {T}) on the T=65536 net [{smi}]: graphed equals "
        f"its eager body bit for bit; captures {{'score': 1}}, then "
        f"replays; call {dt * 1e3:.2f} ms (mean of 3: "
        f"{', '.join(f'{t * 1e3:.2f}' for t in times)}), "
        f"{T / dt:.1f} tokens/s; perplexity exp(-mean) {ppl:.2f} (random "
        f"weights after phase 37's steps at T=65536; ln V = "
        f"{math.log(LONGCTX['vocab']):.3f})")
    return {"call_ms": dt * 1e3, "tok_s": T / dt, "ppl": ppl,
            "launches": launches}


def _info(fn, *args, n=4) -> list:
    """The ``n`` ints a ``mx_*_info`` entry point writes after ``args``."""
    import ctypes

    vals = [ctypes.c_int() for _ in range(n)]
    err = fn(*args, *(ctypes.byref(x) for x in vals))
    assert err == 0, f"kernel info {args}: CUDA error {err}"
    return [x.value for x in vals]


def fwd_kernel_info() -> dict:
    """Registers, spill bytes, dynamic shared memory, blocks an SM and
    query rows a block of the bf16 forward kernel, per instantiation
    (D = 64, 128)."""
    import ctypes

    fn = _build.load("flash_attention").mx_flash_attention_fwd_info
    fn.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 5
    fn.restype = ctypes.c_int
    return {f"fwd_D{D}": dict(zip(
        ("regs", "local_bytes", "smem_bytes", "blocks_per_sm",
         "rows_per_block"), _info(fn, D, n=5))) for D in (64, 128)}


def paged_kernel_info() -> dict:
    """Registers, spill bytes, static shared memory and blocks an SM of
    the paged kernel at the serving path's instantiations: bf16 q with
    bf16 or int8 pages, f32 q with f32 pages, D = 64."""
    import ctypes

    fn = _build.load("paged_attention").mx_paged_attention_info
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 4
    fn.restype = ctypes.c_int
    return {f"paged_{name}_D64": dict(zip(
        ("regs", "local_bytes", "smem_bytes", "blocks_per_sm"),
        _info(fn, dtype, quant, 64)))
        for name, dtype, quant in (("bf16", 1, 0), ("int8", 1, 1),
                                   ("f32", 0, 0))}


def bwd_kernel_info() -> dict:
    """Registers, spill bytes, dynamic shared memory and blocks an SM of
    the bf16 backward kernels, per instantiation (D = 64, 128)."""
    import ctypes

    fn = _build.load("flash_attention_bwd").mx_flash_attention_bwd_info
    fn.argtypes = [ctypes.c_int, ctypes.c_int] \
        + [ctypes.POINTER(ctypes.c_int)] * 4
    fn.restype = ctypes.c_int
    return {f"{name}_D{D}": dict(zip(
        ("regs", "local_bytes", "smem_bytes", "blocks_per_sm"),
        _info(fn, dq, D))) for name, dq in (("dkdv", 0), ("dq", 1))
        for D in (64, 128)}


# ---------------------------------------------------------------- phase 41
# phase 20's float engine over phase 4's 8 prompts, with telemetry; a
# first request pays the captures (and their counts), so the TTFT target
# of the burn-rate tracker leaves it room
TEL_ENGINE = dict(max_batch=8, block_size=16, prefill_chunk=32)
TEL_SLO_TTFT = 10.0
# the decode program's event-timed card ms against its own graph replayed
# on an idle stream in the same phase (phase 20's back-to-back replay,
# printed beside, overlaps a replay's start with the one before it)
TEL_DECODE_TOL = 0.15
TEL_ISOLATED_REPLAYS = 20
TEL_STEP_GAP_S = 0.002      # the engine's host time between steps, about
TEL_ENDPOINTS = ("/metrics", "/healthz", "/varz", "/requestz", "/stallz",
                 "/profilez?seconds=0")
TEL_CHECKPOINT_METRICS = (
    "checkpoint_step_stall_seconds", "checkpoint_queue_depth",
    "checkpoint_write_seconds", "checkpoint_bytes_total",
    "checkpoint_write_retries_total", "checkpoint_restore_skipped_total")
# the kernels of the paths this phase drives: the engine (paged) and
# ``generate`` (flash prefill, paged-free decode), the BERT step
TEL_SERVING = ("paged_attention", "flash_attention")
TEL_TRAINING = ("dropout_fwd_dev", "dropout_bwd", "xent_forward",
                "xent_backward")


def _scrape(port: int, path: str) -> str:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as resp:
        assert resp.status == 200, (path, resp.status)
        return resp.read().decode()


def _tel_serve(net, prompts, on: bool, keep_open: bool = False):
    """A fresh float engine on graphs (phase 20's: 8 lanes, block 16,
    chunk 32) with telemetry ``on`` or off: a warm-up request (the
    captures; with telemetry on, the programs' counts), the metrics
    reset, then phase 4's 8 prompts at once, 32 tokens each.  Returns
    (the engine, closed unless ``keep_open``; the tokens; decoded
    tok/s)."""
    if on:
        telemetry.enable()
    else:
        telemetry.disable()
    eng = ServingEngine(net, **TEL_ENGINE, slo_ttft=TEL_SLO_TTFT,
                        http_port=0 if keep_open else None)
    try:
        eng.submit(prompts[0][:40], 2).result(timeout=300)
        telemetry.reset()
        telemetry.requestlog.clear()
        t0 = time.perf_counter()
        reqs = [eng.submit(p, 32) for p in prompts]
        toks = [r.result(timeout=600) for r in reqs]
        tok_s = sum(len(t) for t in toks) / (time.perf_counter() - t0)
    except BaseException:
        eng.close()
        raise
    if not keep_open:
        eng.close()
    return eng, toks, tok_s


def _isolated_replay_ms(eng, n=TEL_ISOLATED_REPLAYS) -> float:
    """The median card ms of the engine's step graph replayed ``n``
    times as the engine runs a step: its last inputs staged from host
    arrays (pinned, ``non_blocking``), the replay launched on an idle
    stream, the result read back, then a host gap of a step's length;
    each replay timed by a pair of events recorded on the stream around
    it: the card time the event-timed decode program must read, plus
    the host's launch latency.  Not a counted launch (the graph is
    replayed directly); each replay rewrites the K/V its last step
    wrote with the same values."""
    prog = eng._programs.programs["step"]
    host = {k: v.cpu().numpy() for k, v in prog.static_inputs.items()}
    ms = []
    for _ in range(n):
        prog._stage(host)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        prog._graph.replay()
        e1.record()
        prog._out[-1].cpu()
        ms.append(e0.elapsed_time(e1))
        time.sleep(TEL_STEP_GAP_S)
    return float(np.median(ms))


def _tel_programs(names) -> dict:
    """{program: (runs, median card ms)} of the resolved runs of
    ``names`` in perf's timing stream."""
    by = {}
    for e in telemetry.perf.recent_timings():
        if e["program"] in names:
            by.setdefault(e["program"], []).append(e["dur"] * 1e3)
    return {k: (len(v), float(np.median(v))) for k, v in by.items()}


def _tel_training(smi: str, mfu_25) -> dict:
    """Phase 25's BERT-large step (B=32, T=128, bf16, dropout 0.1),
    three steps with telemetry on, then one checkpoint save."""
    gc.collect()
    torch.cuda.empty_cache()
    net, model, trainer = _bert_model(BERT, torch.bfloat16, seed=0)
    B, T = BERT_BATCH
    tokens, labels = _bert_batch(BERT["vocab_size"], B, T)
    n_params = sum(p.numel() for p in net.collect_params().values()
                   if p.grad_req != "null")
    losses = []
    for _ in range(3):
        with autograd.record():
            loss = model(tokens, labels)
        loss.backward()
        trainer.step(1)
        losses.append(loss.detach())
    torch.cuda.synchronize()
    telemetry.perf.resolve()
    assert all(torch.isfinite(torch.stack(losses).float())), losses
    reg = telemetry.get_registry()
    step_s = reg.get("trainer_step_seconds")
    assert step_s.count == 3 and reg.get("trainer_steps_total").value == 3
    assert reg.get("optimizer_state_bytes_per_device").value \
        == trainer.optimizer_state_bytes_per_device() > 0
    progs = {r["program"]: r for r in telemetry.perf.roofline_table()}
    rec = progs["trainer_step"]
    runs = _tel_programs({"trainer_step", "fwd_record", "bwd_record",
                          "update"})
    assert runs["trainer_step"][0] == 2, runs     # steps 2 and 3
    # the step's record: its recorded forward and backward and update
    assert rec["flops"] == sum(progs[p]["flops"] for p in (
        "fwd_record", "bwd_record", "update")), progs
    assert rec["mfu"] is not None and rec["mfu"] <= 1.0, rec
    _, _, fpt = _mfu(n_params, B, T, 1.0)
    out = {"step_p50_ms": step_s.percentile(0.5) * 1e3,
           "programs": runs, "mfu": rec["mfu"],
           "roofline": rec["roofline_fraction"],
           "flops": rec["flops"], "formula_flops": fpt * B * T,
           "mfu_25": mfu_25}
    log(f"telemetry, BERT-large B={B} T={T} step [{smi}]: "
        f"trainer_step_seconds p50 {out['step_p50_ms']:.2f} ms (host: the "
        f"update is queued, not waited for); programs (runs, median card "
        f"ms by CUDA events): {json.dumps(runs)}; trainer_step counted "
        f"{rec['flops']:.4g} flop against bench.py's formula "
        f"{out['formula_flops']:.4g}: program_mfu {rec['mfu']:.4f}, "
        f"roofline fraction {rec['roofline_fraction']:.4f}; phase 25's own "
        f"MFU in this run " + (f"{mfu_25:.4f}" if mfu_25 else "not measured"))
    root = tempfile.mkdtemp(prefix="mx_tel_ckpt_")
    try:
        mgr = CheckpointManager(os.path.join(root, "ckpt"), keep=1)
        mgr.save(3, net=net, trainer=trainer)
        mgr.wait()
        mgr.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    ck = {}
    for name in TEL_CHECKPOINT_METRICS:
        m = reg.get(name)
        ck[name] = None if m is None else (
            m.snapshot() if m.kind != "histogram"
            else {"count": m.count, "sum": m.sum})
    assert ck["checkpoint_step_stall_seconds"]["count"] == 1, ck
    assert ck["checkpoint_write_seconds"]["count"] == 1, ck
    assert ck["checkpoint_bytes_total"]["value"] > 0, ck
    log(f"telemetry, one CheckpointManager.save of that model and trainer "
        f"[{smi}] (None: never counted): {json.dumps(ck)}")
    out["checkpoint"] = ck
    del net, model, trainer, losses
    return out


def _tel_generate(net, prompt) -> dict:
    """``generate`` B=8, P=128, N=32 (phase 4's prompt) twice with
    telemetry on, the capture and a replay: the ``decode_float`` record
    sums the flash prefill and the 32 steps."""
    for _ in range(2):
        out = net.generate(prompt, 32)
    torch.cuda.synchronize()
    telemetry.perf.resolve()
    assert out.shape == (8, 160)
    rec = {r["program"]: r for r in telemetry.perf.roofline_table()}
    dec = rec["decode_float"]
    assert dec["mfu"] is not None and dec["seconds"], dec
    reg = telemetry.get_registry()
    return {"decode_float": dec,
            "tok_s_gauge": reg.get("decode_tokens_per_second",
                                   {"path": "float"}).value}


def _profiled_spans(eng, prompt) -> dict:
    """One request under ``torch.profiler`` profiling every thread: the
    engine's spans as ``record_function`` ranges, beside the kernels."""
    kw = {}
    cfg = getattr(torch._C._profiler, "_ExperimentalConfig", None)
    if cfg is not None:
        kw["experimental_config"] = cfg(profile_all_threads=True)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA], **kw) as prof:
        eng.submit(prompt, 32).result(timeout=600)
        torch.cuda.synchronize()
    events = prof.events()
    names = {e.name for e in events}
    kernels = sum(e.device_type == torch.autograd.DeviceType.CUDA
                  for e in events)
    return {"ranges": sorted(n for n in names if n.startswith("serving/")),
            "kernels": kernels}


def phase_telemetry(smi: str, prompts, prompt, replay_card_ms: float,
                    mfu_25) -> dict:
    """The telemetry on the port's main paths at full width: phase 25's
    BERT-large step with telemetry on (step seconds, the step's program
    record against the phase's own MFU, a checkpoint's six metrics);
    phase 20's graphed float engine over phase 4's 8 prompts with
    telemetry off, on (with its ops server, scraped), on, off — decoded
    tok/s both ways; the scraped engine's counts, its health, a valid
    merged trace, a profiled request's record_function ranges, every
    program's MFU <= 1 and roofline fraction <= 1.05, the decode
    program's event-timed card ms within 15% of its graph replayed on an
    idle stream (phase 20's back-to-back replay beside it); a
    flight-recorder bundle with the engine's and the steps' sections."""
    net = _build_net(torch.bfloat16, MODEL["num_layers"], seed=0)
    for name in KERNELS:
        KERNELS[name]["fn"].launches = 0
    _graphs.reset_counts()
    flight = tempfile.mkdtemp(prefix="mx_flight_")
    telemetry.perf.clear()
    telemetry.get_registry().clear()
    telemetry.enable()
    telemetry.flight_recorder.install(flight, signals=False)
    eng = None
    try:
        train = _tel_training(smi, mfu_25)
        runs, tok_s = {}, {"off": [], "on": []}
        for i, on in enumerate((False, True, True, False)):
            eng, toks, r = _tel_serve(net, prompts, on, keep_open=(i == 1))
            runs.setdefault("toks", toks)
            assert toks == runs["toks"], "tokens differ between engines"
            tok_s["on" if on else "off"].append(r)
            if i != 1:
                continue
            # the scraped engine (closed before the next run, so no idle
            # engine polls beside a timed one): the counts of the 8
            # requests, a profiled request, the flight bundle
            torch.cuda.synchronize()
            got = {p: _scrape(eng.http_port, p) for p in TEL_ENDPOINTS}
            decode = _tel_programs({"serving_step", "serving_step_float"})
            isolated_ms = _isolated_replay_ms(eng)
            other = ((prompts[5].astype(np.int64) + 1)
                     % MODEL["vocab"]).astype(np.int32)
            spans = _profiled_spans(eng, other)
            paths = telemetry.flight_recorder.dump("manual", flight)
            lines = [json.loads(ln) for ln in open(paths["jsonl"])]
            with open(paths["trace"]) as f:
                json.load(f)
            name = eng._name
            eng.close()
            eng = None
        telemetry.enable()
        gen = _tel_generate(net, prompt)
        text = got["/metrics"]
        assert "\nserving_admitted_total 8.0\n" in text, \
            [ln for ln in text.splitlines() if "admitted" in ln]
        varz = json.loads(got["/varz"])
        tpot = varz["metrics"]['serving_tpot_seconds{path=float}']
        assert tpot["count"] >= 1, tpot
        health = json.loads(got["/healthz"])
        assert health["status"] == "healthy", health
        reqz = json.loads(got["/requestz"])
        assert reqz["ring"]["pushed"] == 8, reqz["ring"]
        stallz = json.loads(got["/stallz"])["engines"][name]
        assert stallz["invariant_violations"] == 0, stallz
        trace = json.loads(got["/profilez?seconds=0"])
        problems = telemetry.profiler.validate_chrome_trace(trace)
        assert problems == [], problems[:5]
        assert varz["perf"]["peak_flops"] is not None, varz["perf"]
        table = telemetry.perf.roofline_table()
        for row in table:
            assert row["mfu"] is None or row["mfu"] <= 1.0, row
            assert row["roofline_fraction"] is None \
                or row["roofline_fraction"] <= 1.05, row
        assert any(r["program"] == "serving_step" and r["mfu"] is not None
                   for r in table), table
        n_step, step_ms = decode["serving_step"]
        dev = abs(step_ms - isolated_ms) / isolated_ms
        assert dev <= TEL_DECODE_TOL, (step_ms, isolated_ms)
        assert {"serving/step", "serving/prefill_chunk"} \
            <= set(spans["ranges"]) and spans["kernels"] > 0, spans
        sections = {ln["section"]: ln for ln in lines if "section" in ln}
        assert "in_flight" in sections[name]["data"], sections.keys()
        assert any(s["name"] == "trainer/step" for ln in lines
                   for s in ln.get("spans", ())), "no step section"
        torch.cuda.synchronize()
        launches = {k: _graphs.launches(KERNELS[k]["fn"]) for k in KERNELS}
        for k in TEL_SERVING + TEL_TRAINING:
            assert launches[k] > 0, f"{k} never launched on phase 41"
    finally:
        if eng is not None:
            eng.close()
        telemetry.disable()
        telemetry.flight_recorder.uninstall()
        telemetry.profiler.uninstall_gc_hooks()
        shutil.rmtree(flight, ignore_errors=True)
    off, on = float(np.mean(tok_s["off"])), float(np.mean(tok_s["on"]))
    log(f"telemetry, phase 20's float engine over phase 4's 8 prompts "
        f"(32 tokens each) [{smi}]: telemetry off "
        f"{', '.join(f'{x:.1f}' for x in tok_s['off'])} decoded tok/s, on "
        f"{', '.join(f'{x:.1f}' for x in tok_s['on'])} (order off, on, on, "
        f"off; on/off {on / off:.4f}); tokens equal")
    log(f"telemetry, the scraped engine [{smi}]: endpoints "
        f"{json.dumps({p: len(b) for p, b in got.items()})} bytes; "
        f"/healthz {health['status']}; /stallz {stallz['steps']} steps, "
        f"attribution {json.dumps(stallz['attribution'][:4])}; decode "
        f"program serving_step: {n_step} runs, median {step_ms:.4f} card "
        f"ms by CUDA events against {isolated_ms:.4f} ms, the median of "
        f"{TEL_ISOLATED_REPLAYS} replays of its graph each on an idle "
        f"stream ({dev:.3f} apart; phase 20's back-to-back replay "
        f"{replay_card_ms:.4f} ms); profiled request: ranges "
        f"{spans['ranges']} "
        f"beside {spans['kernels']} kernels")
    log("telemetry, programs (flop, bytes, card ms of the last run, MFU, "
        "roofline fraction): " + "; ".join(
            f"{r['program']} {r['flops']:.4g} {r['hbm_bytes']:.4g} "
            + (f"{r['seconds'] * 1e3:.4f}" if r["seconds"] else "-") + " "
            + (f"{r['mfu']:.4f}" if r["mfu"] is not None else "-") + " "
            + (f"{r['roofline_fraction']:.4f}"
               if r["roofline_fraction"] is not None else "-")
            for r in table))
    del net
    d = gen["decode_float"]
    log(f"telemetry, generate B=8 P=128 N=32 [{smi}]: decode_float "
        f"{d['flops']:.4g} flop over {d['seconds'] * 1e3:.3f} card ms "
        f"(prefill and 32 steps), MFU {d['mfu']:.4f}, roofline "
        f"{d['roofline_fraction']:.4f}; decode_tokens_per_second "
        f"{gen['tok_s_gauge']:.1f} (host clock)")
    return {"launches": launches, "tok_s": tok_s, "on_off": on / off,
            "decode_ms": step_ms, "isolated_ms": isolated_ms,
            "train": train, "generate": gen}


# --------------------------------------------------------------- phase 42
FED_RECORDS = 1280                  # 10 batches of RESNET_BATCH
FED_QUALITY = 90                    # train.py's make_synthetic_rec
# epoch 0 captures and checks; then FED_TIMED_EPOCHS timed with
# telemetry off; one with telemetry on; one under the profiler
FED_TIMED_EPOCHS = 4
FED_EPOCHS = FED_TIMED_EPOCHS + 3
# train.py's ImageRecordIter arguments (examples/image_classification)
FED_ITER = dict(shuffle=True, rand_mirror=True, mean_r=123.68,
                mean_g=116.78, mean_b=103.94, std_r=58.4, std_g=57.1,
                std_b=57.4, device_normalize=True, preprocess_threads=4)
FED_DISP_BATCHES = 20               # train.py's --disp-batches
FED_BYTE_STEPS = 6
FED_REPLAY_STEPS = 3
FED_THREADS = (1, 2, 4, 8)
FED_SWEEP_BATCHES = 4
FED_SPLIT_BATCHES = 5
# a decoder's pixels against PIL's (libjpeg-turbo), in levels of 255
# (max, mean |diff|): nvJPEG's planes are finished with libjpeg's own
# chroma upsampling and conversion (native/ycc_rgb.h), so on 4:4:4 and
# on the 4:2:0 records alike only the IDCT's rounding differs
DECODE_TOL_444 = (4, 1.0)
DECODE_TOL_420 = (6, 1.0)
FED_CHECK_IMAGES = 32


def make_fed_rec(path, n, classes, hw, seed=7):
    """train.py's `make_synthetic_rec`: JPEG class templates plus noise,
    labels from a seed; returns the first `FED_CHECK_IMAGES` images."""
    from PIL import Image   # noqa: F401  (pack_img's codec; fail early)

    rng = np.random.RandomState(seed)
    templates = rng.randint(0, 255, (classes, hw, hw, 3), dtype=np.uint8)
    order = np.random.RandomState(1).randint(0, classes, n)
    rec = recordio.MXRecordIO(path, "w")
    imgs = []
    for i, cls in enumerate(order):
        noise = rng.randint(-20, 20, templates[cls].shape).astype(np.int16)
        img = np.clip(templates[cls].astype(np.int16) + noise, 0,
                      255).astype(np.uint8)
        if i < FED_CHECK_IMAGES:
            imgs.append(img)
        rec.write(recordio.pack_img(recordio.IRHeader(0, float(cls), i, 0),
                                    img, quality=FED_QUALITY))
    rec.close()
    return imgs


def _fed_decoder() -> str:
    """libjpeg where this host builds the pipeline with it, else nvJPEG;
    the reason is printed either way."""
    try:
        mx_native.image_pipeline_lib("libjpeg")
        log("fed: the native pipeline builds with libjpeg on this host")
        return "libjpeg"
    except MXNetError as e:
        lines = str(e).splitlines()
        why = next((ln for ln in lines if "error" in ln), lines[0])
        log(f"fed: the libjpeg pipeline does not build on this host "
            f"({why.strip()}); decoding with nvJPEG")
        return "nvjpeg"


def _pil_pixels(path, n) -> np.ndarray:
    r = recordio.MXRecordIO(path, "r")
    out = np.stack([recordio.unpack_img(r.read())[1] for _ in range(n)])
    r.close()
    return out.transpose(0, 3, 1, 2).astype(np.int16)


def check_decoder(decoder, path, imgs, tmp, smi) -> dict:
    """The pipeline's uint8 pixels (224² records at 224²: the center crop
    is the whole image; no mirror) against PIL's decode of the same
    records: the train records (4:2:0) and 4:4:4 JPEGs of their first
    images at the same quality (`DECODE_TOL_444`, `DECODE_TOL_420`)."""
    from io import BytesIO

    from PIL import Image

    p444 = os.path.join(tmp, "check444.rec")
    w = recordio.MXRecordIO(p444, "w")
    for i, img in enumerate(imgs):
        buf = BytesIO()
        Image.fromarray(img).save(buf, format="JPEG", quality=FED_QUALITY,
                                  subsampling=0)
        w.write(recordio.pack(recordio.IRHeader(0, 0.0, i, 0),
                              buf.getvalue()))
    w.close()
    out = {}
    for tag, p, n in (("4:2:0", path, RESNET_BATCH), ("4:4:4", p444,
                                                      len(imgs))):
        it = mx_io.ImageRecordIter(p, (3, RESNET_HW, RESNET_HW), n,
                                   device_normalize=True, decoder=decoder,
                                   device=DEV)
        got = it.next().data[0].cpu().numpy().astype(np.int16)
        d = np.abs(got - _pil_pixels(p, n))
        out[tag] = (int(d.max()), float(d.mean()))
    log(f"fed decoder {decoder} [{smi}] against PIL (levels of 255, max, "
        f"mean): {out}")
    for tag, tol in (("4:4:4", DECODE_TOL_444), ("4:2:0", DECODE_TOL_420)):
        assert out[tag][0] <= tol[0] and out[tag][1] <= tol[1], (tag, out)
    # a record that does not decode: nvJPEG fails its batch, libjpeg
    # zero-fills the sample (the JAX package's bits); counted either way
    bad = os.path.join(tmp, "bad.rec")
    w = recordio.MXRecordIO(bad, "w")
    w.write(recordio.pack_img(recordio.IRHeader(0, 0.0, 0, 0), imgs[0],
                              quality=FED_QUALITY))
    w.write(recordio.pack(recordio.IRHeader(0, 1.0, 1, 0), b"no jpeg" * 9))
    w.close()
    it = mx_io.ImageRecordIter(bad, (3, RESNET_HW, RESNET_HW), 2,
                               device_normalize=True, decoder=decoder,
                               device=DEV)
    if decoder == "nvjpeg":
        try:
            it.next()
            raise AssertionError("nvJPEG: a record that does not decode "
                                 "gave a batch")
        except IOError:
            pass
    else:
        assert not it.next().data[0][1].any()
    assert it.decode_failures == 1, it.decode_failures
    log(f"fed decoder {decoder} [{smi}] against PIL's decode of the same "
        f"records (levels of 255): {len(imgs)} 4:4:4 JPEGs max "
        f"{out['4:4:4'][0]}, mean {out['4:4:4'][1]:.4f} (bound "
        f"{DECODE_TOL_444}); {RESNET_BATCH} train records (4:2:0) max "
        f"{out['4:2:0'][0]}, mean {out['4:2:0'][1]:.4f} (bound "
        f"{DECODE_TOL_420}); a record that does not decode counted "
        f"and " + ("its batch raised IOError" if decoder == "nvjpeg" else
                   "its sample zero-filled"))
    return out


def _fed_model(it):
    """train.py's net behind ``wrap_net``: ``get_model("resnet50_v1",
    classes=1000)`` from seed 0, ``cast("bfloat16")``, wrapped,
    hybridized, and its SGD Trainer (f32 masters)."""
    mx_random.seed(0, device=DEV)
    body = vision.get_model("resnet50_v1", classes=RESNET_CLASSES,
                            device=DEV)
    body.initialize()
    body.cast("bfloat16")
    net = it.wrap_net(body, "bfloat16")
    net.hybridize()
    trainer = Trainer(net.collect_params(), "sgd", dict(RESNET_SGD),
                      keep_grads=False)
    return body, net, trainer


def _fed_step(net, trainer, loss_fn, x, y):
    with autograd.record():
        out = net(x)
        loss = loss_fn(out, y)
    autograd.backward(loss)
    trainer.step(RESNET_BATCH)
    return out, loss.detach()


def _fed_state(trainer, body) -> list:
    states = [trainer._states[i] for i in sorted(trainer._states)]
    return [[s[0].clone() for s in states], [s[1].clone() for s in states],
            [t.detach().clone() for t in _running_stats(body)]]


def time_fed_pipeline(decoder, path, smi) -> dict:
    """The pipeline alone (``ImRecIterNext`` back to back, the native
    prefetch one batch ahead) at 1, 2, 4, 8 threads and nproc (at most
    32); then at train.py's 4 threads the PrefetchingIter worker's
    stages in turn (`ImageRecordIter.next`'s work): ``ImRecIterNext``,
    the host float32 → uint8 cast, pinning and the copy to the card
    through the iterator's stager (synchronised)."""
    B, hw = RESNET_BATCH, RESNET_HW
    kw = {k: v for k, v in FED_ITER.items() if k != "preprocess_threads"}
    nproc = min(os.cpu_count() or 1, 32)
    rates = {}
    for th in sorted(set(FED_THREADS + (nproc,))):
        nat = mx_io.ImageRecordIter(path, (3, hw, hw), B, decoder=decoder,
                                    preprocess_threads=th, device=DEV,
                                    **kw)._native
        nat.next()
        t0 = time.perf_counter()
        for _ in range(FED_SWEEP_BATCHES):
            nat.next()
        rates[th] = FED_SWEEP_BATCHES * B / (time.perf_counter() - t0)
        del nat
    # ImageRecordIter.next's work, stage by stage, through the iterator's
    # own stager (its pinned ring warmed by one batch first)
    it = mx_io.ImageRecordIter(path, (3, hw, hw), B, decoder=decoder,
                               device=DEV, **FED_ITER)
    nat = it._native
    d, lab, pad = nat.next()
    it._emit(d.astype("uint8"), lab, pad)
    torch.cuda.synchronize()
    split = {"ImRecIterNext": 0.0, "float32 -> uint8 cast": 0.0,
             "pinning + copy": 0.0}
    for _ in range(FED_SPLIT_BATCHES):
        t0 = time.perf_counter()
        d, lab, pad = nat.next()
        t1 = time.perf_counter()
        u = d.astype("uint8")
        t2 = time.perf_counter()
        it._emit(u, lab, pad)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for k, dt in zip(split, (t1 - t0, t2 - t1, t3 - t2)):
            split[k] += dt * 1e3 / FED_SPLIT_BATCHES
    total = sum(split.values())
    log(f"fed pipeline alone [{smi}] decoder {decoder}, B={B} {hw}x{hw}: "
        + ", ".join(f"{th} threads {r:.1f} img/s" for th, r in
                    rates.items())
        + f" (nproc {os.cpu_count()}); at 4 threads the worker's stages a "
        f"batch: " + "; ".join(f"{k} {ms:.2f} ms = {ms / total:.3f}"
                               for k, ms in split.items())
        + f" (sum {total:.2f} ms = {B / total * 1e3:.1f} img/s)")
    return {"threads": rates, "split_ms": split}


def check_fed_loaders(decoder, path, smi) -> None:
    """A pinned `DataLoader` batch, and a prefetched one on the card equal
    to its host batch; `ImageRecordIter` behind `PrefetchingIter` read
    on a side stream, which waits for each copy (the card's bytes equal
    the host's after work queued on that stream reads them)."""
    x = np.arange(24, dtype=np.float32).reshape(6, 4)
    ds = mx_data.ArrayDataset(x)
    pb = next(iter(mx_data.DataLoader(ds, batch_size=3, pin_memory=True)))
    assert isinstance(pb, torch.Tensor) and pb.is_pinned()
    cb = list(mx_data.DataLoader(ds, batch_size=3, prefetch_to_device=True,
                                 device=DEV))
    assert all(b.device.type == DEV.type for b in cb)
    assert torch.equal(torch.cat(cb).cpu(), torch.from_numpy(x))
    it = mx_io.ImageRecordIter(path, (3, RESNET_HW, RESNET_HW), RESNET_BATCH,
                               decoder=decoder, device=DEV, **FED_ITER)
    host, emit = [], it._emit

    def keep(d, l, pad):
        host.append(d.copy())
        return emit(d, l, pad)

    it._emit = keep
    feed = mx_io.PrefetchingIter(it, prefetch_to_device=True, device=DEV)
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        for k in range(3):
            x = feed.next().data[0]
            sums = x.to(torch.int64).sum((1, 2, 3))     # queued on `side`
            want = torch.from_numpy(host[k].astype(np.int64)).sum((1, 2, 3))
            assert torch.equal(sums.cpu(), want), k
            assert np.array_equal(x.cpu().numpy(), host[k]), k
    feed.close()
    torch.cuda.synchronize()
    log(f"fed [{smi}]: DataLoader(pin_memory=True) gives pinned CPU "
        f"tensors; DataLoader(prefetch_to_device=True) card tensors equal "
        f"to the host batches; PrefetchingIter(ImageRecordIter) read on a "
        f"side stream: 3 batches equal to the host's")


def phase_fed_training(smi: str, synthetic: dict) -> dict:
    """Phase 42: train.py's loop fed from a .rec (see the docstring)."""
    tmp = tempfile.mkdtemp(prefix="fed_")
    try:
        return _fed_run(smi, synthetic, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _fed_run(smi, synthetic, tmp) -> dict:
    B, hw = RESNET_BATCH, RESNET_HW
    path = os.path.join(tmp, "train.rec")
    t0 = time.perf_counter()
    imgs = make_fed_rec(path, FED_RECORDS, RESNET_CLASSES, hw)
    log(f"fed [{smi}]: packed {FED_RECORDS} JPEG records ({RESNET_CLASSES} "
        f"classes, {hw}x{hw}, quality {FED_QUALITY}) into "
        f"{os.path.getsize(path)} bytes in {time.perf_counter() - t0:.2f} s")
    decoder = _fed_decoder()
    check_decoder(decoder, path, imgs, tmp, smi)
    check_fed_loaders(decoder, path, smi)
    it = mx_io.ImageRecordIter(path, (3, hw, hw), B, decoder=decoder,
                               device=DEV, **FED_ITER)
    assert it._native is not None and it.decoder == decoder
    host = []
    emit = it._emit

    def keep(d, l, pad):
        if len(host) < FED_BYTE_STEPS:
            host.append((d.copy(), l.copy()))
        return emit(d, l, pad)

    it._emit = keep
    feed = mx_io.PrefetchingIter(it, prefetch_to_device=True, device=DEV)
    loss_fn = SoftmaxCrossEntropyLoss()
    acc = mx_metric.Accuracy()
    speed = mx_callback.Speedometer(B, FED_DISP_BATCHES)
    per_step = {n: 0 for n in TRAINING_KERNELS + FLASH_KERNELS}
    per_step.update(xent_forward=1, xent_backward=1)
    progs = ("fwd_record", "bwd_record", "update")
    gc.collect()
    torch.cuda.empty_cache()
    _zero_counts()
    tel_epoch, prof_epoch = FED_EPOCHS - 2, FED_EPOCHS - 1
    with cudnn_mode(True):
        t0 = time.perf_counter()
        body, net, trainer = _fed_model(it)
        torch.cuda.synchronize()
        built_s = time.perf_counter() - t0
        kept, losses, accs, walls, waits = [], [], [], [], []
        step, state, tel = 0, None, {}
        for epoch in range(FED_EPOCHS):
            if epoch == tel_epoch:
                telemetry.reset()
                telemetry.enable()
            torch.cuda.synchronize()
            if epoch == prof_epoch:
                # the card's kernels only: no host-side tracing
                prof_ep = torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA])
                prof_ep.start()
            t_ep, wait = time.perf_counter(), 0.0
            if epoch:
                feed.reset()
            acc.reset()
            for nbatch in itertools.count():
                t0 = time.perf_counter()
                try:
                    batch = feed.next()
                except StopIteration:
                    break
                wait += time.perf_counter() - t0
                x, y = batch.data[0], batch.label[0]
                if step < FED_BYTE_STEPS:
                    assert x.dtype == torch.uint8 and x.device.type == DEV.type
                    assert np.array_equal(x.cpu().numpy(), host[step][0]) \
                        and np.array_equal(y.cpu().numpy(),
                                           host[step][1]), step
                if step < FED_REPLAY_STEPS:
                    kept.append((x.cpu(), y.cpu()))
                c0 = _counts()
                out, loss = _fed_step(net, trainer, loss_fn, x, y)
                c1 = _counts()
                assert {n: c1[n] - c0[n] for n in per_step} == per_step, \
                    (step, c0, c1)
                acc.update([y], [out])
                speed(mx_callback.BatchEndParam(epoch, nbatch, acc, None))
                losses.append(loss)
                step += 1
                if step == FED_REPLAY_STEPS:
                    state = _fed_state(trainer, body)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t_ep)
            waits.append(wait)
            accs.append(acc.get()[1])
            if epoch == tel_epoch:
                h = telemetry.histogram("data_wait_seconds")
                tel = {"wait_s": h.sum, "gets": h.count,
                       "h2d": telemetry.counter("h2d_bytes_total").value,
                       "depth": telemetry.gauge("prefetch_queue_depth").value}
                telemetry.disable()
                telemetry.reset()
            if epoch == prof_epoch:
                prof_ep.stop()
                epoch_busy = device_busy(prof_ep, walls[-1])
        captures = {k: _graphs.captures.get(k) for k in progs}
        assert captures == dict.fromkeys(progs, 1), captures
        assert step == FED_EPOCHS * FED_RECORDS // B, step
        # one profiled step, its batch already decoded
        feed.reset()
        b = feed.next()
        _fed_step(net, trainer, loss_fn, b.data[0], b.label[0])
        torch.cuda.synchronize()
        time.sleep(0.2)     # the worker stages the next batch
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            b = feed.next()
            _fed_step(net, trainer, loss_fn, b.data[0], b.label[0])
            torch.cuda.synchronize()
            prof_s = time.perf_counter() - t0
        feed.close()
        # the fed path's launches only, not the direct-fed check's below
        launches = _counts()
        assert it.decode_failures == 0, it.decode_failures
        busy = device_busy(prof, prof_s)
        losses = torch.stack(losses).float().cpu()
        assert torch.isfinite(losses).all(), losses
        del net, body, trainer, out, batch, b, x, y
        gc.collect()
        torch.cuda.empty_cache()
        # the first steps' batches fed directly to a net built afresh
        body, net, trainer = _fed_model(it)
        again = [_fed_step(net, trainer, loss_fn, x.to(DEV), y.to(DEV))[1]
                 for x, y in kept]
        replay = _fed_state(trainer, body)
    assert torch.equal(torch.stack(again).float().cpu(),
                       losses[:FED_REPLAY_STEPS]), (again, losses)
    for what, a, b in zip(("masters", "momenta", "running stats"), state,
                          replay):
        assert len(a) == len(b) and all(torch.equal(u, v)
                                        for u, v in zip(a, b)), what
    del net, body, trainer
    gc.collect()
    torch.cuda.empty_cache()
    per_epoch = FED_RECORDS // B
    timed = slice(1, 1 + FED_TIMED_EPOCHS)
    epoch_img_s = [per_epoch * B / w for w in walls[timed]]
    timed_s = sum(walls[timed])
    n_timed = FED_TIMED_EPOCHS * per_epoch
    img_s, step_ms = n_timed * B / timed_s, timed_s / n_timed * 1e3
    wait_share = sum(waits[timed]) / timed_s
    tel_share = tel["wait_s"] / walls[tel_epoch]
    pipe = time_fed_pipeline(decoder, path, smi)
    log(f"fed ResNet-50 v1 training [{smi}] decoder {decoder}, "
        f"{FED_ITER['preprocess_threads']} threads, B={B} {hw}x{hw} bf16: "
        f"built in {built_s:.1f} s; {step} steps over {FED_EPOCHS} epochs "
        f"(walls {', '.join(f'{w:.3f}' for w in walls)} s), losses finite "
        f"(mean first/last {losses[0].mean():.4f}/{losses[-1].mean():.4f}); "
        f"the card's uint8 batch equal to the host's for {FED_BYTE_STEPS} "
        f"steps; {FED_REPLAY_STEPS} steps bit-identical to the same "
        f"batches fed directly (losses, {len(state[0])} f32 masters and "
        f"momenta, {len(state[2])} running stats); captures {captures}, "
        f"1 + 1 cross-entropy launches a step, {launches['xent_forward']} "
        f"+ {launches['xent_backward']} on the fed path; no decode failure")
    log(f"fed ResNet-50 v1 timed [{smi}]: epochs 1-{FED_TIMED_EPOCHS}, "
        f"telemetry off: {img_s:.1f} img/s over {n_timed} steps (step "
        f"{step_ms:.2f} ms; by epoch "
        f"{', '.join(f'{r:.1f}' for r in epoch_img_s)} img/s, min "
        f"{min(epoch_img_s):.1f}, max {max(epoch_img_s):.1f}) against phase "
        f"30's synthetic-batch graphed step {synthetic['step_ms']:.2f} ms = "
        f"{synthetic['img_s']:.1f} img/s in this run "
        f"({img_s / synthetic['img_s']:.3f} of it); the loop waited for "
        f"input {wait_share:.3f} of those steps' wall")
    log(f"fed ResNet-50 v1 epoch {tel_epoch}, telemetry on, untimed "
        f"[{smi}]: data_wait_seconds {tel['wait_s']:.4f} s over "
        f"{tel['gets']} gets = {tel_share:.3f} of its "
        f"{walls[tel_epoch]:.3f} s, h2d_bytes_total {tel['h2d']:.0f}, "
        f"prefetch_queue_depth {tel['depth']:.0f}; epoch {prof_epoch} "
        f"under the profiler (card kernels only): the card busy "
        f"{epoch_busy['busy_share']:.3f} of its {walls[prof_epoch]:.3f} s "
        f"wall (idle {1 - epoch_busy['busy_share']:.3f}); Accuracy at "
        f"each epoch's end {', '.join(f'{a:.4f}' for a in accs)}")
    log(f"fed one profiled step [{smi}]: {prof_s * 1e3:.2f} ms wall, card "
        f"busy {busy['busy_s'] * 1e3:.2f} ms = {busy['busy_share']:.3f} "
        f"(idle {1 - busy['busy_share']:.3f}), {busy['kernels']} kernels; "
        f"device ms by kernel: " + "; ".join(f"{n} {ms:.3f}"
                                             for n, ms in busy["top"]))
    return {"launches": launches, "decoder": decoder, "img_s": img_s,
            "epoch_img_s": epoch_img_s, "step_ms": step_ms,
            "wait_share": wait_share, "tel_wait_share": tel_share,
            "busy": busy["busy_share"],
            "card_share": epoch_busy["busy_share"],
            "accuracy": accs, "pipeline": pipe}


# ---------------------------------------------------------------- phase 43
CHAIN_K = 4
CHAIN_STEPS = 24
CHAIN_TIMED = (9, 20)               # steps 10-21: three full flushes
CHAIN_RESNET_STEPS = 10             # 1 run, 2 flushes of 4, a tail of 1
CHAIN_KERNELS = ("dropout_fwd_dev", "dropout_bwd", "xent_forward",
                 "xent_backward")


def _first_inputs(rec, key, want=None):
    """A recording keeper: the first call's inputs (copied) outside a
    capture, where ``want(args)`` holds."""
    def keep(args, kw):
        if key not in rec and not _graphs.capturing() \
                and (want is None or want(args)):
            rec[key] = _kept(args)
    return keep


def _chain_bert_run(mode, smi):
    """bench.py's loop, 24 steps: ``chain`` (chain_steps=4), ``single``
    (chain_steps=4, flushed after every step) or ``three``
    (chain_steps=1).  Returns the losses, clones of the weights, masters
    and momenta, the launches of each full flush, the timings and the
    path's kernel inputs (``chain``)."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    L, V = BERT["num_layers"], BERT["vocab_size"]
    B, T = BERT_BATCH
    mx_random.seed(0, device=DEV)
    net = BERTForPretraining(**BERT, dropout=DROPOUT, device=DEV)
    net.initialize()
    net.cast(torch.bfloat16)
    model = PretrainWithLoss(net)
    model.hybridize()
    K = 1 if mode == "three" else CHAIN_K
    trainer = Trainer(model.collect_params(), "sgd", dict(SGD),
                      keep_grads=False, chain_steps=K)
    tokens, labels = _bert_batch(V, B, T)
    per_step = _per_step(L, T)
    rec, flushes, host = {}, [], []
    losses = []
    _zero_counts()
    mx_random.seed(7, device=DEV)
    win = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    with recording(dk_mod, "_fwd_cuda", _first_inputs(
            rec, "dropout_fwd", lambda a: a[1] is not None
            and isinstance(a[2], torch.Tensor))), \
            recording(dk_mod, "_bwd_cuda", _first_inputs(rec, "dropout_bwd")), \
            recording(xk_mod, "_fwd_cuda", _first_inputs(rec, "fwd")), \
            recording(xk_mod, "_bwd_cuda", _first_inputs(rec, "bwd")):
        for s in range(CHAIN_STEPS):
            if s == CHAIN_TIMED[0]:
                win[0].record()
            full = mode == "chain" and len(trainer._chain_buf) == K - 1
            c0 = _counts()
            t0 = time.perf_counter()
            with autograd.record():
                loss = model(tokens, labels)
            loss.backward()
            trainer.step(1)
            if mode == "single":
                trainer.flush()
            host.append(time.perf_counter() - t0)
            if full:
                c1 = _counts()
                flushes.append({n: c1[n] - c0[n] for n in per_step})
            # a deferred loss stays deferred; the first call's keeps no
            # autograd graph alive
            losses.append(loss if isinstance(loss, engine.Deferred)
                          else loss.detach())
            if s == CHAIN_TIMED[1]:
                win[1].record()
        trainer.flush()
        torch.cuda.synchronize()
    step_ms = win[0].elapsed_time(win[1]) / (CHAIN_TIMED[1]
                                             - CHAIN_TIMED[0] + 1)
    states = [trainer._states[i] for i in sorted(trainer._states)]
    out = {"mode": mode, "losses": torch.stack([
               l.detach().float() for l in losses]).cpu(),
           "weights": [p.detach().clone() for p in
                       model.collect_params().values()],
           "masters": [st[0].clone() for st in states],
           "moms": [st[1].clone() for st in states],
           "flushes": flushes, "launches": _counts(), "rec": rec,
           "step_ms": step_ms,
           "host_ms": sum(host[CHAIN_TIMED[0]:CHAIN_TIMED[1] + 1]) * 1e3
           / (CHAIN_TIMED[1] - CHAIN_TIMED[0] + 1),
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "runs": {k: (_graphs.captures.get(k, 0), _graphs.replays.get(k, 0))
                    for k in ("fwd_record", "bwd_record", "update",
                              "chain_step", "full_step")}}
    log(f"chained steps [{smi}] {mode} (chain_steps={K}): {out['step_ms']:.3f}"
        f" ms a step over steps {CHAIN_TIMED[0] + 1}-{CHAIN_TIMED[1] + 1} "
        f"(CUDA events on the stream, no sync in between: the card's "
        f"time, host time hidden where the host runs ahead), host "
        f"{out['host_ms']:.3f} ms a step, "
        f"peak memory {out['peak_gib']:.2f} GiB; (captures, replays) "
        f"{out['runs']}")
    del net, model, trainer, states
    return out


def check_chain_kernels(rec) -> dict:
    """The dropout and cross-entropy kernels at the chained path's inputs
    (the first full flush's warm-up) against their plain versions: the
    dropout entries bit for bit, the forward's lse within `LSE_RTOL`, the
    backward within `DX_TOL`."""
    x, res, slot, rate = rec["dropout_fwd"]
    y, m = dropout_fwd_dev(x, res, slot, rate)
    ry, rm = dropout_fwd_reference(x, res, slot, rate)
    assert torch.equal(m, rm) and torch.equal(_bits(y), _bits(ry)), \
        "dropout forward at the chained path's inputs differs"
    dy, mask, brate = rec["dropout_bwd"]
    assert torch.equal(_bits(dropout_bwd(dy, mask, brate)),
                       _bits(dropout_bwd_reference(dy, mask, brate))), \
        "dropout backward at the chained path's inputs differs"
    x2, want_sum = rec["fwd"]
    ref_lse, _ = stats_reference(x2, want_sum)
    lse_err = ((xent_forward(x2, want_sum)[0] - ref_lse).abs()
               / ref_lse.abs().clamp(min=1)).max().item()
    assert lse_err <= LSE_RTOL, f"xent forward at chained inputs: {lse_err}"
    bx, labels, lse, g, eps = rec["bwd"]
    dx_err = check_dlogits(xent_backward(bx, labels, lse, g, eps),
                           dlogits_reference(bx, labels, lse, g, eps), bx,
                           labels, g, eps, "xent backward at chained inputs")
    return {"dropout_fwd_dev": 0.0, "dropout_bwd": 0.0,
            "xent_forward": lse_err, "xent_backward": dx_err}


def _chain_resnet_run(K):
    """train.py's loop, `CHAIN_RESNET_STEPS` steps at chain_steps ``K``:
    the per-sample loss block called on the net's output, `Accuracy`
    updated at flush boundaries (every step when ``K`` is 1)."""
    gc.collect()
    torch.cuda.empty_cache()
    B = RESNET_BATCH
    with cudnn_mode(True):
        mx_random.seed(0, device=DEV)
        net = vision.get_model("resnet50_v1", classes=RESNET_CLASSES,
                               device=DEV)
        net.initialize()
        net.cast("bfloat16")
        net.hybridize()
        trainer = Trainer(net.collect_params(), "sgd", dict(RESNET_SGD),
                          keep_grads=False, chain_steps=K)
        loss_fn = SoftmaxCrossEntropyLoss()
        acc = mx_metric.Accuracy()
        batches = [_images(B, RESNET_HW, RESNET_CLASSES, 100 + s,
                           torch.bfloat16) for s in range(CHAIN_RESNET_STEPS)]
        per_step = {"xent_forward": 1, "xent_backward": 1}
        losses, outs, deferred, flushes = [], [], [], []
        _zero_counts()
        for x, y in batches:
            full = K > 1 and len(trainer._chain_buf) == K - 1
            c0 = _counts()
            with autograd.record():
                out = net(x)
                loss = loss_fn(out, y)
            autograd.backward(loss)
            trainer.step(B)
            if full:
                c1 = _counts()
                flushes.append({n: c1[n] - c0[n] for n in per_step})
            deferred.append((y, out))
            if len(deferred) >= K:
                for yy, oo in deferred:
                    acc.update([yy], [oo])
                deferred.clear()
            keep = (lambda t: t if isinstance(t, engine.Deferred)
                    else t.detach())
            losses.append(keep(loss))
            outs.append(keep(out))
        trainer.flush()
        for yy, oo in deferred:
            acc.update([yy], [oo])
        torch.cuda.synchronize()
    states = [trainer._states[i] for i in sorted(trainer._states)]
    res = {"losses": [l.detach().clone() for l in losses],
           "outs": [o.detach().clone() for o in outs],
           "masters": [st[0].clone() for st in states],
           "moms": [st[1].clone() for st in states],
           "stats": [t.detach().clone() for t in _running_stats(net)],
           "acc": acc.get()[1], "flushes": flushes, "launches": _counts(),
           "spliced": trainer._full is not None
           and len(trainer._full._template.stages) == 2}
    del net, trainer, states, batches
    return res


def phase_chained_steps(smi: str) -> dict:
    """Phase 43 (see the module docstring)."""
    L, T = BERT["num_layers"], BERT_BATCH[1]
    per_step = _per_step(L, T)
    runs = {m: _chain_bert_run(m, smi) for m in ("chain", "single", "three")}
    c = runs["chain"]
    for m in ("single", "three"):
        r = runs[m]
        assert torch.equal(r["losses"], c["losses"]), \
            (m, r["losses"], c["losses"])
        for key in ("weights", "masters", "moms"):
            assert all(torch.equal(a, b) for a, b in zip(r[key], c[key])), \
                f"chained steps: {key} differ from the {m} loop's"
    assert torch.isfinite(c["losses"]).all(), c["losses"]
    n_full = (CHAIN_STEPS - 1) // CHAIN_K
    assert len(c["flushes"]) == n_full, c["flushes"]
    for f in c["flushes"]:
        assert f == {n: CHAIN_K * k for n, k in per_step.items()}, f
    assert c["runs"]["chain_step"] == (1, n_full - 1) \
        and c["runs"]["full_step"][0] == 1, c["runs"]
    assert runs["single"]["runs"]["full_step"] == (1, CHAIN_STEPS - 2), \
        runs["single"]["runs"]
    errs = check_chain_kernels(c["rec"])
    rn = {K: _chain_resnet_run(K) for K in (CHAIN_K, 1)}
    a, b = rn[CHAIN_K], rn[1]
    assert a["spliced"], "the loss block did not join the chained step"
    for key in ("losses", "outs", "masters", "moms", "stats"):
        assert all(torch.equal(u, v) for u, v in zip(a[key], b[key])), \
            f"ResNet-50 chained: {key} differ from chain_steps=1"
    assert a["acc"] == b["acc"], (a["acc"], b["acc"])
    assert a["flushes"] and all(
        f == {"xent_forward": CHAIN_K, "xent_backward": CHAIN_K}
        for f in a["flushes"]), a["flushes"]
    launches = {n: sum(r["launches"].get(n, 0) for r in runs.values())
                + a["launches"].get(n, 0) + b["launches"].get(n, 0)
                for n in TRAINING_KERNELS + FLASH_KERNELS}
    three, single = runs["three"], runs["single"]
    log(f"chained steps [{smi}] BERT-large B={BERT_BATCH[0]} T={T}: "
        f"chain_steps={CHAIN_K}, {CHAIN_STEPS} single one-program steps and "
        f"the three-program loop bit-identical over {CHAIN_STEPS} steps "
        f"(losses {c['losses'].tolist()}, {len(c['masters'])} f32 masters "
        f"and momenta, {len(c['weights'])} weights); each of {n_full} full "
        f"flushes launched {c['flushes'][0]}; kernels at the chained "
        f"inputs against their plain versions {errs}; ms a step chained "
        f"{c['step_ms']:.3f}, single {single['step_ms']:.3f}, three "
        f"programs {three['step_ms']:.3f} (chained/single "
        f"{c['step_ms'] / single['step_ms']:.4f}); host ms a step "
        f"{c['host_ms']:.3f} / {single['host_ms']:.3f} / "
        f"{three['host_ms']:.3f}; peak memory {c['peak_gib']:.2f} / "
        f"{single['peak_gib']:.2f} / {three['peak_gib']:.2f} GiB")
    log(f"chained steps [{smi}]: launches on phase 43's paths (the five "
        f"loops, replays included) " + json.dumps(
            {n: k for n, k in launches.items() if k}))
    log(f"chained steps [{smi}] ResNet-50 v1 B={RESNET_BATCH} bf16: "
        f"chain_steps={CHAIN_K} with the loss block spliced in against "
        f"chain_steps=1 over {CHAIN_RESNET_STEPS} steps bit-identical "
        f"(losses, outputs, {len(a['masters'])} masters and momenta, "
        f"{len(a['stats'])} running stats, accuracy {a['acc']}); each "
        f"full flush launched {a['flushes'][0]}")
    return {"launches": launches, "errs": errs,
            "bert": {m: {k: r[k] for k in ("step_ms", "host_ms", "peak_gib",
                                           "runs")}
                     for m, r in runs.items()}}


# ------------------------------------------------------ phases 44 and 45
# the word-level LSTM LM that the upstream Gluon and PyTorch
# word_language_model examples document at 650 wide: 2 layers, tied,
# dropout 0.5, bptt 35, batch 20, over WikiText-2's vocabulary
WORD_LM = dict(vocab_size=33278, emsize=650, nhid=650, nlayers=2,
               dropout=0.5, tied=True)
LM_BPTT, LM_BATCH = 35, 20
# the repo example's SGD (lr 1, momentum 0) and clip (0.25 x batch).  At
# the upstream examples' lr 20 the loss diverged within 30 windows under
# this clip (PERF.md)
LM_LR, LM_CLIP = 1.0, 0.25
LM_WINDOWS = 30
# the repo example's synthetic Markov corpus (word_language_model.py's
# `synthetic_corpus`), of a length whose 90% train split holds 10
# windows: 30 windows are three passes over it
LM_CORPUS_TOKENS = 8000
LM_EAGER_WINDOWS = 4


def synthetic_corpus(vocab, n_tokens, seed=7):
    """Markov bigram chain: each token strongly prefers 4 successors
    (`examples/gluon/word_language_model.py`)."""
    rng = np.random.RandomState(seed)
    successors = rng.randint(0, vocab, size=(vocab, 4))
    toks = np.empty(n_tokens, dtype="int32")
    toks[0] = 0
    choices = rng.randint(0, 4, size=n_tokens)          # which successor
    noise = rng.rand(n_tokens) < 0.05                   # 5% random jumps
    jumps = rng.randint(0, vocab, size=n_tokens)
    for i in range(1, n_tokens):
        toks[i] = jumps[i] if noise[i] else successors[toks[i - 1], choices[i]]
    return toks


def _lm_windows():
    """The train split batchified (one column a batch lane) and cut into
    (x, y) windows of bptt rows, int64 on the card."""
    toks = synthetic_corpus(WORD_LM["vocab_size"], LM_CORPUS_TOKENS)
    toks = toks[:int(len(toks) * 0.9)]
    nbatch = len(toks) // LM_BATCH
    data = torch.from_numpy(toks[:nbatch * LM_BATCH].astype(np.int64)) \
        .reshape(LM_BATCH, nbatch).t().contiguous().to(DEV)
    return [(data[i:i + LM_BPTT], data[i + 1:i + 1 + LM_BPTT])
            for i in range(0, nbatch - 1 - LM_BPTT + 1, LM_BPTT)]


def _lm_counts():
    return {n: _graphs.launches(KERNELS[n]["fn"])
            for n in ("dropout_fwd", "dropout_fwd_dev", "dropout_bwd",
                      "dropout_mask", "dropout_mask_dev", "xent_forward",
                      "xent_backward")}


def _lm_loop(hybrid, n_windows, rec=None, snapshot_at=None):
    """The example's training loop on `WordLM` from seed 0 (Uniform(0.1)
    weights): ``n_windows`` windows, three passes over the corpus, the
    states carried and detached (reset at each pass's start, as the
    example resets them each epoch), ``clip_global_norm`` (on the card,
    no host sync) between ``backward()`` and ``step(1)``.  ``hybrid``:
    the model and the loss block hybridized (CUDA graphs), else never
    hybridized.  Returns the losses and norms (on the card), each
    window's launches, and at ``snapshot_at`` windows the weights and
    states."""
    mx_random.seed(0, device=DEV)
    model = WordLM(**WORD_LM, device=DEV)
    model.initialize(mx_init.Uniform(0.1))
    loss_fn = SoftmaxCrossEntropyLoss()
    if hybrid:
        model.hybridize()
        loss_fn.hybridize()
    trainer = Trainer(model.collect_params(), "sgd",
                      {"learning_rate": LM_LR, "momentum": 0.0})
    params = [p for p in model.collect_params().values()
              if p.grad_req != "null"]
    wins = _lm_windows()
    out = {"losses": [], "norms": [], "launches": [], "model": model}

    def keep_first(key):
        def keep(args, kw):
            if rec is not None:
                rec.setdefault(key, _kept(args))
        return keep

    def window(k, states, clip):
        x, y = wins[k % len(wins)]
        if k % len(wins) == 0:
            states = model.begin_state(LM_BATCH)
        states = [s.detach() for s in states]
        with autograd.record():
            logits, states = model(x, states)
            loss = loss_fn(logits, y).mean()
        loss.backward()
        norm = gluon_utils.clip_global_norm(
            [p.grad for p in params], LM_CLIP * LM_BATCH,
            check_isfinite=False) if clip else None
        trainer.step(1)
        return states, loss.detach(), norm

    box = [None]                # the states carried to the next window

    def step(k, clip=True):
        box[0], loss, norm = window(k, box[0], clip)
        return loss, norm

    with recording(dk_mod, "_fwd_cuda", keep_first("dropout_fwd")), \
            recording(dk_mod, "_bwd_cuda", keep_first("dropout_bwd")), \
            recording(xk_mod, "_fwd_cuda", keep_first("xent_fwd")), \
            recording(xk_mod, "_bwd_cuda", keep_first("xent_bwd")):
        for k in range(n_windows):
            c0 = _lm_counts()
            loss, norm = step(k)
            c1 = _lm_counts()
            out["launches"].append({n: c1[n] - c0[n] for n in c0})
            out["losses"].append(loss)
            out["norms"].append(norm)
            if snapshot_at == k + 1:
                out["weights"] = [p.detach().clone() for p in params]
                out["states"] = [s.detach().clone() for s in box[0]]
    out["window"] = step
    return out


def _lm_yardstick(model, smi):
    """The LSTM alone at the window's shapes, (35, 20, 650) in, its two
    layers' states: the port's time loop (the hybridized layer, a
    recorded forward and backward replayed as CUDA graphs) against
    cuDNN's ``torch.nn.LSTM`` loaded with the same weights (the
    yardstick, never a route of the port), forward and backward, no
    dropout in either; outputs held to each other within 1e-4 of their
    largest value."""
    lstm = model.lstm
    H, L = WORD_LM["nhid"], WORD_LM["nlayers"]
    same = gluon_rnn.LSTM(H, num_layers=L, input_size=WORD_LM["emsize"],
                          device=DEV)
    with torch.no_grad():
        same.blob().copy_(lstm.blob())
    same.hybridize()
    g = torch.Generator(device=DEV).manual_seed(3)
    x = torch.randn(LM_BPTT, LM_BATCH, WORD_LM["emsize"], device=DEV,
                    generator=g)
    h0 = [torch.randn(L, LM_BATCH, H, device=DEV, generator=g) * 0.1
          for _ in range(2)]
    dy = torch.randn(LM_BPTT, LM_BATCH, H, device=DEV, generator=g)
    xr = x.clone().requires_grad_()

    def port():
        with autograd.record():
            y, _ = same(xr, h0)
        y.backward(dy)
        return y

    cudnn = torch.nn.LSTM(WORD_LM["emsize"], H, L).to(DEV)
    weights, biases = rnn_impl_mod._unpack(
        lstm.blob().detach(), "lstm", WORD_LM["emsize"], H, L, False)
    with torch.no_grad():
        for i, ((wi, wh), (bi, bh)) in enumerate(zip(weights, biases)):
            getattr(cudnn, f"weight_ih_l{i}").copy_(wi)
            getattr(cudnn, f"weight_hh_l{i}").copy_(wh)
            getattr(cudnn, f"bias_ih_l{i}").copy_(bi)
            getattr(cudnn, f"bias_hh_l{i}").copy_(bh)
    xc = x.clone().requires_grad_()

    def library():
        y, _ = cudnn(xc, tuple(h0))
        y.backward(dy)
        return y

    yp, yc = port().detach(), library().detach()
    err = (yp - yc).abs().max().item()
    assert err <= 1e-4 * yc.abs().max().item(), \
        f"the port's LSTM against cuDNN's: {err}"
    return {"port_ms": time_ms(port, iters=20),
            "cudnn_ms": time_ms(library, iters=20), "err": err}


def time_lm_dropout(rec) -> dict:
    """The dropout kernels at the word LM's first dropout site (the
    embedding's, (35, 20, 650) f32, rate 0.5, the seed in the slot its
    captured program read) and its backward: held bit for bit to the
    plain versions there, timed beside them, ``F.dropout`` (forward) and
    ``native_dropout_backward`` (the library's backward of the same
    mask) and the byte bounds."""
    x, res, slot, rate = rec["dropout_fwd"]
    dy, mask, brate = rec["dropout_bwd"]
    assert res is None and isinstance(slot, torch.Tensor), (res, slot)
    y, m = dropout_fwd_dev(x, None, slot, rate)
    ry, rm = dropout_fwd_reference(x, None, slot, rate)
    assert torch.equal(m, rm) and torch.equal(_bits(y), _bits(ry)), \
        "dropout forward at the word LM's inputs differs"
    dx = dropout_bwd(dy, mask, brate)
    assert torch.equal(_bits(dx), _bits(dropout_bwd_reference(
        dy, mask, brate))), "dropout backward at the word LM's inputs differs"
    n, e = x.numel(), x.element_size()
    fwd_bound, fwd_by = _bound(n * (2 * e + 1) + 8, 0,
                               PEAK_FLOPS[torch.float32])
    bwd_bound, bwd_by = _bound(n * (2 * e + 1), 0, PEAK_FLOPS[torch.float32])
    return {
        "dropout_fwd_dev": {
            "shape": f"{tuple(x.shape)} {x.dtype} rate={rate}",
            "max_abs_err": 0.0,
            "ms": time_ms(lambda: dropout_fwd_dev(x, None, slot, rate)),
            "plain_ms": time_ms(lambda: dropout_fwd_reference(
                x, None, slot, rate)),
            "library_ms": time_ms(lambda: F.dropout(x, rate)),
            "bound_ms": fwd_bound, "bound_by": fwd_by},
        "dropout_bwd": {
            "shape": f"{tuple(dy.shape)} {dy.dtype} rate={brate}",
            "max_abs_err": 0.0,
            "ms": time_ms(lambda: dropout_bwd(dy, mask, brate)),
            "plain_ms": time_ms(lambda: dropout_bwd_reference(dy, mask,
                                                              brate)),
            "library_ms": time_ms(
                lambda: torch.ops.aten.native_dropout_backward(
                    dy, mask.view(torch.bool), dk_mod._scale(brate,
                                                             dy.dtype))),
            "bound_ms": bwd_bound, "bound_by": bwd_by}}


def phase_word_lm(smi: str) -> dict:
    """Phase 44 (see the module docstring)."""
    rec = {}
    t0 = time.perf_counter()
    _zero_counts()
    graph = _lm_loop(True, LM_WINDOWS, rec, snapshot_at=LM_EAGER_WINDOWS)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    eager = _lm_loop(False, LM_EAGER_WINDOWS, snapshot_at=LM_EAGER_WINDOWS)
    losses = torch.stack(graph["losses"]).cpu()
    elosses = torch.stack(eager["losses"]).cpu()
    assert torch.equal(losses[:LM_EAGER_WINDOWS], elosses), \
        (losses[:LM_EAGER_WINDOWS], elosses)
    for key in ("weights", "states"):
        assert all(torch.equal(a, b) for a, b in zip(graph[key],
                                                     eager[key])), \
            f"word LM: {key} after {LM_EAGER_WINDOWS} windows differ " \
            f"between graphs and the body never hybridized"
    assert torch.isfinite(losses).all(), losses
    first, last10 = losses[0].item(), losses[-10:].mean().item()
    assert last10 < first and last10 < math.log(WORD_LM["vocab_size"]), \
        (first, last10, losses.tolist())
    # launches a window once every program is captured: 3 dropout sites
    # (the embedding's, the LSTM's inter-layer, the output's) forward and
    # backward, one cross-entropy forward and backward
    steady = {"dropout_fwd": 0, "dropout_fwd_dev": 3, "dropout_bwd": 3,
              "dropout_mask": 0, "dropout_mask_dev": 0, "xent_forward": 1,
              "xent_backward": 1}
    for k, c in enumerate(graph["launches"][1:], 2):
        assert c == steady, (k, c)
    eager_win = {"dropout_fwd": 3, "dropout_fwd_dev": 0, "dropout_bwd": 3,
                 "dropout_mask": 0, "dropout_mask_dev": 0,
                 "xent_forward": 1, "xent_backward": 1}
    assert all(c == eager_win for c in eager["launches"]), eager["launches"]
    caps = {k: _graphs.captures.get(k, 0) for k in ("fwd_record",
                                                    "bwd_record")}
    reps = {k: _graphs.replays.get(k, 0) for k in ("fwd_record",
                                                   "bwd_record")}
    launches = {n: sum(c[n] for c in graph["launches"] + eager["launches"])
                for n in steady}
    # timing: windows of the graphed loop, each synchronised, then 10
    # between two CUDA events; one profiled window
    model = graph["model"]
    k0 = LM_WINDOWS
    torch.cuda.synchronize()
    host = []
    for k in range(k0, k0 + 5):
        t1 = time.perf_counter()
        graph["window"](k)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t1) * 1e3)
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    t1 = time.perf_counter()
    for k in range(k0 + 5, k0 + 15):
        graph["window"](k)
    end.record()
    end.synchronize()
    ev_ms = start.elapsed_time(end) / 10
    run_ms = (time.perf_counter() - t1) * 1e3 / 10
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        graph["window"](k0 + 15)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t1
    busy = device_busy(prof, prof_s)
    # what clip_global_norm costs: reading the gradients before step()
    # takes the eager update (and the gradients' copies); without it the
    # update is the captured program U (two windows to capture it)
    for k in range(k0 + 16, k0 + 18):
        graph["window"](k, clip=False)
    start.record()
    t1 = time.perf_counter()
    for k in range(k0 + 18, k0 + 28):
        graph["window"](k, clip=False)
    end.record()
    end.synchronize()
    noclip_ev_ms = start.elapsed_time(end) / 10
    noclip_run_ms = (time.perf_counter() - t1) * 1e3 / 10
    assert _graphs.captures.get("update", 0) == 1, dict(_graphs.captures)
    yard = _lm_yardstick(model, smi)
    card_ms = busy["busy_s"] * 1e3
    tok = LM_BPTT * LM_BATCH
    errs = {}
    times = time_xent(*rec["xent_fwd"], *rec["xent_bwd"], "word LM")
    times.update(time_lm_dropout(rec))
    for name, r in times.items():
        errs[name] = r["max_abs_err"]
    log(f"word LM [{smi}] WordLM(V={WORD_LM['vocab_size']}, "
        f"{WORD_LM['emsize']} wide, {WORD_LM['nlayers']} layers, tied, "
        f"dropout {WORD_LM['dropout']}) f32, bptt {LM_BPTT}, batch "
        f"{LM_BATCH}, SGD lr {LM_LR} momentum 0, clip_global_norm "
        f"{LM_CLIP * LM_BATCH}: {LM_WINDOWS} windows on graphs in "
        f"{loop_s:.2f} s, losses {[round(v, 4) for v in losses.tolist()]} "
        f"(first {first:.4f}, mean of the last 10 {last10:.4f}, ln V "
        f"{math.log(WORD_LM['vocab_size']):.4f}); norms "
        f"{[round(float(v), 3) for v in graph['norms'][:5]]}...; "
        f"{LM_EAGER_WINDOWS} graphed windows bit-identical to the body "
        f"never hybridized (losses, {len(graph['weights'])} weights, "
        f"{len(graph['states'])} states); captures {caps}, replays {reps}")
    log(f"word LM [{smi}]: launches a window on graphs, inside replays "
        f"(window 1, which captures: {graph['launches'][0]}) "
        + json.dumps(graph["launches"][1]) + "; never hybridized "
        + json.dumps(eager["launches"][0]))
    log(f"word LM [{smi}]: window {run_ms:.3f} host ms (10 back to back; "
        f"{', '.join(f'{t:.2f}' for t in host)} each synchronised), "
        f"{ev_ms:.3f} ms between CUDA events, {tok / run_ms * 1e3:.1f} "
        f"tokens/s; one profiled window {prof_s * 1e3:.2f} ms wall, card "
        f"busy {card_ms:.3f} ms = {busy['busy_share']:.3f}, "
        f"{busy['kernels']} kernels; device ms by kernel: "
        + "; ".join(f"{n} {ms:.3f}" for n, ms in busy["top"]))
    log(f"word LM [{smi}]: clip_global_norm before step() (the eager "
        f"update): {run_ms:.3f} host ms / {ev_ms:.3f} ms between events a "
        f"window, against {noclip_run_ms:.3f} / {noclip_ev_ms:.3f} without "
        f"it (the captured update): {ev_ms - noclip_ev_ms:.3f} ms a window")
    log(f"word LM [{smi}]: the LSTM alone at ({LM_BPTT}, {LM_BATCH}, "
        f"{WORD_LM['emsize']}), forward and backward: the port's time loop "
        f"on graphs {yard['port_ms']:.3f} ms ({yard['port_ms'] / card_ms:.3f}"
        f" of the profiled window's card time), cuDNN's torch.nn.LSTM with "
        f"the same weights {yard['cudnn_ms']:.3f} ms (yardstick; outputs "
        f"within {yard['err']:.2e})")
    for name, r in times.items():
        log(f"{name} at the word LM's inputs {r['shape']}: {r['ms']:.4f} "
            f"ms, plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), {launches[name]} launches on phase 44's "
            f"path ({steady[name]} a graphed window) [{smi}]")
    del graph["model"], graph["window"]
    return {"launches": launches, "errs": errs, "times": times,
            "window_ms": run_ms, "card_ms": card_ms,
            "clip_ms": ev_ms - noclip_ev_ms,
            "busy": busy["busy_share"], "yardstick": yard}


# DCGAN at the upstream example/gluon/dc_gan widths on the repo
# example's 32x32 networks
DCGAN = dict(ngf=64, ndf=64, latent=100)
GAN_BATCH, GAN_ITERS, GAN_EAGER_ITERS = 64, 20, 3
GAN_ADAM = {"learning_rate": 2e-4, "beta1": 0.5}


def _gan_batches():
    """Images of the port's `SyntheticImageDataset` (4 classes, 3x32x32,
    noise 0.2, seed 3, templates 11; HWC) in a shuffled order, NCHW,
    squashed into (-1, 1) by tanh as the example's ``real_batches``
    does, full batches only, on the card."""
    ds = mx_data.vision.SyntheticImageDataset(
        num_samples=GAN_BATCH * 10, num_classes=4, shape=(3, 32, 32),
        noise=0.2, seed=3, template_seed=11)
    order = np.random.RandomState(0).permutation(len(ds))
    imgs = np.stack([ds[i][0] for i in order]).transpose(0, 3, 1, 2)
    imgs = torch.from_numpy(np.tanh(imgs).astype(np.float32)).to(DEV)
    return list(imgs.split(GAN_BATCH))


def _gan_loop(hybrid, n_iters):
    """The example's loop from seed 0 (``Normal(0.02)`` weights), the
    latent codes from a card generator seeded 1: ``hybrid`` both nets
    hybridized (CUDA graphs), else never hybridized.  Returns each
    iteration's two losses, and the weights and running stats of both
    nets after each iteration."""
    mx_random.seed(0, device=DEV)
    netG, netD = dcgan_nets(**DCGAN, device=DEV)
    netG.initialize(mx_init.Normal(0.02))
    netD.initialize(mx_init.Normal(0.02))
    if hybrid:
        netG.hybridize()
        netD.hybridize()
    loss_fn = SigmoidBinaryCrossEntropyLoss()
    trG = Trainer(netG.collect_params(), "adam", dict(GAN_ADAM))
    trD = Trainer(netD.collect_params(), "adam", dict(GAN_ADAM))
    ones = torch.ones(GAN_BATCH, 1, device=DEV)
    zeros = torch.zeros(GAN_BATCH, 1, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(1)
    batches = _gan_batches()
    lat = (GAN_BATCH, DCGAN["latent"], 1, 1)

    def iteration(k):
        real = batches[k % len(batches)]
        z = torch.randn(lat, device=DEV, generator=gen)
        fake = netG(z).detach()
        with autograd.record():
            lossD = (loss_fn(netD(real), ones)
                     + loss_fn(netD(fake), zeros)).mean()
        lossD.backward()
        trD.step(1)
        z = torch.randn(lat, device=DEV, generator=gen)
        with autograd.record():
            lossG = loss_fn(netD(netG(z)), ones).mean()
        lossG.backward()
        trG.step(1)
        return lossD.detach(), lossG.detach()

    out = {"losses": [], "states": [], "iteration": iteration,
           "nets": (netG, netD), "captures": []}
    for k in range(n_iters):
        out["losses"].append(torch.stack(iteration(k)))
        out["captures"].append(sum(_graphs.captures.values()))
        if k < GAN_EAGER_ITERS:
            out["states"].append([t.detach().clone() for net in (netG, netD)
                                  for t in net.parameters()])
    return out


def phase_dcgan(smi: str) -> dict:
    """Phase 45 (see the module docstring)."""
    _graphs.reset_counts()
    with cudnn_mode(True):
        t0 = time.perf_counter()
        graph = _gan_loop(True, GAN_ITERS)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        eager = _gan_loop(False, GAN_EAGER_ITERS)
        for k in range(GAN_EAGER_ITERS):
            assert torch.equal(graph["losses"][k], eager["losses"][k]), \
                (k, graph["losses"][k], eager["losses"][k])
            assert all(torch.equal(a, b) for a, b in zip(
                graph["states"][k], eager["states"][k])), \
                f"DCGAN: weights or running stats differ after iteration " \
                f"{k + 1} between graphs and the body never hybridized"
        losses = torch.stack(graph["losses"]).cpu()
        assert torch.isfinite(losses).all(), losses
        caps = {k: _graphs.captures.get(k, 0) for k in
                ("raw_fn", "fwd_record", "bwd_record", "update")}
        it = graph["iteration"]
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        t1 = time.perf_counter()
        start.record()
        for k in range(GAN_ITERS, GAN_ITERS + 10):
            it(k)
        end.record()
        end.synchronize()
        iter_ms = (time.perf_counter() - t1) * 1e3 / 10
        ev_ms = start.elapsed_time(end) / 10
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            it(GAN_ITERS + 10)
            torch.cuda.synchronize()
            prof_s = time.perf_counter() - t1
        busy = device_busy(prof, prof_s)
        netG, netD = graph["nets"]
        n_bn = sum(1 for net in (netG, netD) for m in net.modules()
                   if isinstance(m, gluon_nn.BatchNorm))
    log(f"DCGAN [{smi}] ngf={DCGAN['ngf']} ndf={DCGAN['ndf']} latent "
        f"{DCGAN['latent']} batch {GAN_BATCH}, 32x32, Adam {GAN_ADAM}, "
        f"deterministic cuDNN: {GAN_ITERS} iterations on graphs in "
        f"{loop_s:.2f} s, losses (D, G) "
        f"{[[round(v, 4) for v in r] for r in losses.tolist()]}; "
        f"{GAN_EAGER_ITERS} graphed iterations bit-identical to the "
        f"bodies never hybridized (both losses, both nets' weights and "
        f"the running stats of all {n_bn} BatchNorms after each); "
        f"captures {caps}, their running total after each iteration "
        f"{graph['captures']}")
    log(f"DCGAN [{smi}]: iteration {iter_ms:.3f} host ms (10 back to "
        f"back), {ev_ms:.3f} ms between CUDA events, "
        f"{GAN_BATCH / iter_ms * 1e3:.1f} img/s; one profiled iteration "
        f"{prof_s * 1e3:.2f} ms wall, card busy {busy['busy_s'] * 1e3:.3f} "
        f"ms = {busy['busy_share']:.3f}, {busy['kernels']} kernels; device "
        f"ms by kernel: " + "; ".join(f"{n} {ms:.3f}" for n, ms in
                                      busy["top"]))
    return {"iter_ms": iter_ms, "card_ms": busy["busy_s"] * 1e3,
            "busy": busy["busy_share"], "img_s": GAN_BATCH / iter_ms * 1e3}


def main() -> int:
    t_start = time.perf_counter()
    took = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        took[name] = round(time.perf_counter() - t0, 2)
        return out

    smi = timed("device", phase_device)
    timed("build", phase_build)
    info = bwd_kernel_info()
    log("flash backward bf16 kernels (registers a thread at launch, "
        "spill bytes, dynamic shared memory, blocks an SM): "
        + json.dumps(info))
    log("flash forward bf16 kernel (registers a thread at launch, spill "
        "bytes, dynamic shared memory, blocks an SM, query rows a block): "
        + json.dumps(fwd_kernel_info()))
    log("paged attention kernel (registers a thread, spill bytes, static "
        "shared memory, blocks an SM): " + json.dumps(paged_kernel_info()))
    # the serving phases run first, as before the training slice, so
    # their host-bound numbers compare with earlier runs of the script
    errs = timed("kernels", phase_kernels)
    errs.update(timed("flash_bwd_kernels", phase_flash_bwd_kernels))
    # phases 4, 14, 17 and 18 run the un-captured programs (their
    # launch counts and recordings are per call); phase 20 drives the
    # same paths on CUDA graphs
    with _graphs.eager():
        res = timed("main_path", phase_main_path, smi)
    times = timed("timing_paged", time_paged, res)
    serving_flash = timed("timing_flash", time_flash, res)
    timed("parity", phase_parity)
    del res["rec"], res["pools"]
    # the quantized serving path: int8 weights and int8 KV pages
    with _graphs.eager():
        qres = timed("quant_path", phase_quant_path, smi, res)
        # the rest of TransformerLM decode: speculation and beam search
        sres = timed("spec_path", phase_spec_path, smi, res)
        bres = timed("beam", phase_beam, smi, res)
    # the compiled programs as CUDA graphs
    gres = timed("graph_path", phase_graph_path, smi, res)
    gprog = timed("graph_programs", phase_graph_programs, res)
    timed("graph_decode", check_decode_graphs, smi, res)
    timed("weight_writes", check_weight_writes, smi, res)
    timed("hybridize", check_hybridize, smi)
    timed("gc_captures", check_capture_during_collection, smi)
    del res["net"]
    qtimes = timed("quant_timing", time_paged_q8, qres)
    timed("quant_parity", phase_quant_parity)
    timed("spec_parity", phase_spec_parity)
    del qres["rec"], qres["pools"]
    errs.update(timed("training_kernels", phase_training_kernels))
    tres = timed("training", phase_training, smi, *BERT_BATCH)
    timed("training_parity", phase_train_parity, 8, 128)
    times.update(timed("training_timing", time_training_kernels, tres))
    launch_floor = times.pop("launch_floor_ms")
    del tres["rec"]
    # phase-2 pretraining: attention through the flash kernels
    tres512 = timed("training_512", phase_training, smi, *BERT_BATCH_512)
    timed("training_parity_512", phase_train_parity, 2, 512)
    times.update(timed("training_timing_512", time_flash_training, tres512))
    del tres512["rec"]
    # bench.py's step on graphs against its eager bodies, both shapes
    cres = timed("captured_training", phase_captured_training, smi,
                 *BERT_BATCH)
    cres512 = timed("captured_training_512", phase_captured_training, smi,
                    *BERT_BATCH_512)
    timed("captured_training_edges", check_train_step_edges, smi)
    timed("two_pending_calls", check_two_pending_calls, smi)
    # the causal callers: long-context shapes and a trainable TransformerLM
    longctx = timed("flash_longctx_timing", time_flash_longctx)
    lres = timed("lm_causal", phase_lm_causal, smi)
    # the NMT family: transformer_big training on graphs, its kernels at
    # the step's inputs, parity at 2+2 layers, translation
    gc.collect()
    torch.cuda.empty_cache()
    nres = timed("nmt_training", phase_nmt_training, smi)
    ntimes = timed("nmt_timing", time_nmt_kernels, nres)
    del nres["rec"]
    timed("nmt_parity", phase_nmt_parity)
    timed("nmt_translate", phase_nmt_translate, smi, nres.pop("net"))
    # ResNet-50 v1: parity at a small width, training on graphs against
    # never hybridized, its cross-entropy kernels, inference on graphs
    gc.collect()
    torch.cuda.empty_cache()
    timed("resnet_parity", phase_resnet_parity)
    rres = timed("resnet_training", phase_resnet_training, smi)
    rtimes = timed("resnet_timing", time_resnet_kernels, rres)
    del rres["rec"]
    rnet = rres.pop("net")
    rinf = timed("resnet_inference", phase_resnet_inference, smi, rnet)
    # int8 post-training quantization: the kernel at ResNet-50's shapes,
    # benchmark_score.py's int8 flow on graphs, the .params files
    gc.collect()
    torch.cuda.empty_cache()
    i8 = timed("int8_kernels", phase_int8_kernels, smi)
    pres = timed("ptq_inference", phase_ptq_inference, smi, rinf)
    timed("params", phase_params, smi, rnet, pres.pop("net"))
    del rnet
    # training state: BERT-large under LAMB resumed from a checkpoint,
    # then every update rule graphed against its eager body
    gc.collect()
    torch.cuda.empty_cache()
    state = timed("training_state", phase_training_state, smi)
    timed("rules_graphed", check_rules_graphed, smi)
    # long context (benchmark/longctx_bench.py): the flash kernels at long
    # T against the chunked plain version, the training at four lengths
    # (the last with remat), remat against no remat, lm_score a program
    gc.collect()
    torch.cuda.empty_cache()
    ltimes = timed("longctx_kernels", phase_longctx_kernels, smi)
    llong = timed("longctx_training", phase_longctx_training, smi)
    lpar = timed("remat_parity", phase_remat_parity, smi)
    lscore = timed("lm_score_long", phase_lm_score_long, smi,
                   llong.pop("net"))
    # telemetry on the serving engine, generate and the training step
    gc.collect()
    torch.cuda.empty_cache()
    tel = timed("telemetry", phase_telemetry, smi, res["prompts"],
                res["prompt"][:8, :128], gprog["host"]["replay_card"],
                cres["graph"]["mfu"])
    # train.py's loop fed from a .rec: the native pipeline, the prefetcher
    gc.collect()
    torch.cuda.empty_cache()
    fed = timed("fed_training", phase_fed_training, smi, rres["graph"])
    # the one-program step and the chain: bench.py's loop, train.py's
    gc.collect()
    torch.cuda.empty_cache()
    chain = timed("chained_steps", phase_chained_steps, smi)
    for name, e in chain["errs"].items():
        errs.setdefault(name, {})["chained"] = e
    # recurrent and generative Gluon: the word LM and DCGAN
    gc.collect()
    torch.cuda.empty_cache()
    wlm = timed("word_lm", phase_word_lm, smi)
    for name, e in wlm["errs"].items():
        errs.setdefault(name, {})["word_lm"] = e
    gc.collect()
    torch.cuda.empty_cache()
    timed("dcgan", phase_dcgan, smi)
    log(f"phases took {time.perf_counter() - t_start:.1f} s: "
        + json.dumps(took))
    for kind in ("step", "chunk"):
        r = times[kind]
        log(f"paged_attention [{kind}] {r['shape']}: {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['live_pages']} live pages, {r['bytes']} B) [{smi}]")
    for kind in ("step", "chunk"):
        r = qtimes[kind]
        log(f"paged_attention_q8 [{kind}] {r['shape']}: {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}; {r['live_pages']} live pages, {r['bytes']} "
            f"B); the float kernel on the same pages dequantized to bf16 "
            f"{r['float_kernel_ms']:.4f} ms (err {r['float_kernel_err']:.2e})"
            f" [{smi}]")
    r = serving_flash
    log(f"flash_attention at the generate prefill {r['shape']}: "
        f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, sdpa "
        f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
        f"({r['flops']} flop, {r['bytes']} B) [{smi}]")
    for name in FLASH_KERNELS + TRAINING_KERNELS:
        r = times[name]
        log(f"{name} {r['shape']}: {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
            + (f", the old site {r['old_ms']:.4f} ms" if "old_ms" in r
               else "") + f" [{smi}]")
    for name in ("dropout_fwd_dev", "dropout_mask_dev"):
        r = times[name]
        log(f"{name} (the seed read from device memory) {r['shape']}: "
            f"{r['ms']:.4f} ms against {r['by_value_ms']:.4f} ms by value "
            f"[{smi}]")
    r = times["dropout_mask"]
    log(f"dropout_mask bound reckonings: {r['bytes_ms']:.5f} ms of bytes, "
        f"{r['ops_ms']:.5f} ms of {PHILOX_MULS} integer multiplies per 4 "
        f"elements at {INT_MULS_PER_CLOCK_SM} a clock an SM x {r['sms']} "
        f"SMs x {r['sm_clock_mhz']:.0f} MHz (clocks.max.sm); one "
        f"one-element launch takes {launch_floor:.4f} ms in time_ms [{smi}]")
    for name, r in longctx.items():
        half = "forward" if name == "flash_attention" else "backward"
        log(f"{name} long-context {r['shape']}: {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, sdpa is_causal {half} "
            f"{r['library_ms']:.4f} ms, causal bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}) [{smi}]")
    for name, r in ntimes.items():
        log(f"{name} at the NMT step's inputs {r['shape']}: {r['ms']:.4f} "
            f"ms, plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), {nres['launches'][name]} launches on "
            f"phase 26's path ({_nmt_per_step(NMT['num_layers'])[name]} a "
            f"step) [{smi}]")
    for name, r in rtimes.items():
        log(f"{name} at the ResNet-50 step's inputs {r['shape']}: "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), {rres['launches'][name]} launches on "
            f"phase 30's path (1 a step) [{smi}]")
    times["paged_attention"] = times["step"]
    times["paged_attention_q8"] = qtimes["step"]
    # each kernel's launches summed over the main paths that ran it
    launches = {}
    for path in (res, qres, sres, bres, gres, tres, tres512, lres, cres,
                 cres512, nres, rres, pres, state, llong, lpar, lscore, tel):
        for name, n in path["launches"].items():
            launches[name] = launches.get(name, 0) + n
    for name, n in fed["launches"].items():
        launches[name] = launches.get(name, 0) + n
    for name, n in chain["launches"].items():
        launches[name] = launches.get(name, 0) + n
    for name, n in wlm["launches"].items():
        launches[name] = launches.get(name, 0) + n
    rows = []
    for name in ("paged_attention", "paged_attention_q8") + FLASH_KERNELS \
            + TRAINING_KERNELS:
        k, t = KERNELS[name], times[name]
        rows.append({
            "name": name, "route": "cuda", "source": k["source"],
            "replaces": k["replaces"], "launches": launches[name],
            "max_abs_err": max(max(errs[name].values()), t["max_abs_err"],
                               ntimes.get(name, {}).get("max_abs_err", 0.0),
                               rtimes.get(name, {}).get("max_abs_err", 0.0),
                               *(r.get(name, {}).get("max_abs_err", 0.0)
                                 for part in ltimes.values()
                                 for r in part.values())),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t.get("library_ms")})
    for name in INT8_KERNELS:
        k, t = KERNELS[name], i8[name]
        assert launches[name] > 0, f"{name} never launched on its path"
        context = "" if name == "int8_quantize" else (
            f" (bf16 cuDNN/cuBLAS of the same layer {t['cudnn_ms']:.4f} ms)")
        log(f"{name} at {t['shape']} (the JSON row): {t['ms']:.4f} ms, "
            f"plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}), library none{context}, {launches[name]} "
            f"launches on phase 33's path [{smi}]")
        rows.append({
            "name": name, "route": "cuda", "source": k["source"],
            "replaces": k["replaces"], "launches": launches[name],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None})
    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
