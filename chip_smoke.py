"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (or a few), in the order 1–4, 22, 23, 24, 5–7,
16–18, 11–15, 29, 8–10, 26, 27, 19–21, 28; any failure exits non-zero:
1. environment: the card's name and power limit, torch and CUDA versions;
   fails when no CUDA device is available;
2. build: compiles the kernels from ``big_linear_algebra_tpu_torch/csrc/``
   with nvcc, one process per source, started together: the GEMM (K1,
   ``matmul.cu``), flash attention (K2, ``flash_attn.cu``), its backward
   (K2c and K2d, ``flash_attn_bwd.cu``), the fused resnet block (K5a's
   FMA route, K5b, ``fused_block.cu``; K5a's tensor-core route,
   ``fused_block_tc.cu``), the fused flash backward (K3a,
   ``flash_attn_bwd_fused.cu``), the implicit-GEMM conv (K4,
   ``conv_implicit.cu``) and the in-place Adam pass (``adam.cu``);
3. K1 against plain, on the card: nn/nt/tn x f32/bf16 x
   {no epilogue, bias, bias+ReLU} at the three mnist_nn layer shapes and a
   ragged one, and f32 x the same epilogues at the five K1 GEMMs of an
   mnist_nn train step at batch 64 (layers 1 and 2's forwards (nn) and
   weight gradients (tn), layer 2's data gradient (nt)) and at a rank's K1
   GEMMs of the DP and DP x TP steps at 2 and 4 ranks (batch 32 and 16 a
   rank; w1's column shards), against the plain
   PyTorch version with TF32 off; a TF32
   product at the layer shapes must fail the f32 bound; two f32 runs
   bit-equal at each of those shapes; the kernels' registers, shared
   memory and spills (the build's ``-Xptxas -v``), blocks per SM and the
   rule's grid (block shape, K splits over a cluster) at each shape,
   failing on a spill or on clusters that do not all fit at once (the
   train step's and the DP ranks' shapes included); then the kernel's time
   beside the plain
   version's and torch.matmul's (CUDA events, after warm-up), at the layer
   shapes and at the train step's K1 GEMMs, with each one's bound;
4. mnist_nn main path: ``mnist_nn init`` then ``mnist_nn run`` on the
   2048-image synthesized test set in a temporary data directory, with K1's
   launch count read around it; the eval is recomputed on the CPU in f64 by
   the plain path from the same checkpoint;
22. mnist_nn train path (run after 4): in a fresh temporary data directory
   ``mnist_nn init``, ``train 1`` (the 8192-image synthesized set, batch
   64, SGD, on the card) and ``run``, with K1's launches by variant read
   around ``train``: they must equal the epoch's steps times the train
   step's K1 GEMMs (2 nn, 1 nt, 2 tn, derived from the widths and
   ``_SMALL_FLOPS``); the epoch's average loss finite and below the
   untrained loss; ``train 1 --per-batch`` from the same initial CSVs
   bit-equal; every trained leaf within ``TRAIN_RTOL_OF_UPDATE`` of its
   update from the same epoch in f64 on the CPU (same CSVs, same
   permutation); ``run``'s correct count equal to the CPU f64 plain path's
   on the trained checkpoint; then one epoch's host wall time and a
   ``torch.profiler`` trace of one epoch (``trace_summary.py``): the card's
   busy share and K1's share;
23. the remaining programs and the debug flags (run after 22), each in a
   fresh temporary data directory: ``my_first_model init``, ``train 800
   0.1`` (leaves and costs against the same steps in f64 on the CPU) and
   ``run`` on a same-sign and a different-sign pair (the right verdicts);
   the legacy ``mnist init``, ``train 1000 0.05 0`` and ``run 200 0`` and
   ``mnist_hinge init``, ``train 100 0.0005`` and ``run -1 0`` on the
   synthesized sets, whose f32 trajectories are chaotic: the CLI's steps
   replayed on the card bit-equal, each held teacher-forced against f64
   from the card's own state within twice the first-order f32 rounding
   bound; the correct count and the accuracy equal to the CPU f64 path's
   on the trained checkpoints, the hinge convergence iteration (or its
   absence) equal to the f64 run's; ``smoke``'s printed matrices within
   1e-6 of f64 with no K1 launch; ``mnist_nn train 1 --debug-nans
   --disable-jit`` from phase 22's initial CSVs with K1's launches by
   variant as in phase 22 and the trained leaves bit-equal to its, a
   ``train_step`` with a NaN pixel under ``debug_nans()`` raising
   ``FloatingPointError`` at K1's launch, and a NaN made in a gradient
   hook raising in the backward; then 100 eager legacy steps and one
   eager hinge chunk timed and profiled (the card's busy share);
24. the data- and sequence-parallel modes (run after 23): two ranks
   launched with ``python3 -m torch.distributed.run --standalone
   --nproc-per-node=2`` (this script with ``--phase24-rank``), which share
   the card over gloo (a card each over NCCL where there are as many),
   each in fresh temporary data directories: mnist_nn ``train 1 --dp``
   and ``train 1 --dp --per-batch`` (K1's launches per rank by variant
   equal to the count derived from batch 32 and ``_SMALL_FLOPS``, the
   replicas bit-equal, every trained leaf within ``TRAIN_RTOL_OF_UPDATE``
   of its update from the single-device epoch in f64 on the CPU), then the
   epoch replayed bit-equal, each step's gradient on each rank within
   ``DP_GRAD_RTOL_OF_MAX`` of f64 at the same parameters with the card's
   ReLU decisions, which the same gradient from operands truncated to TF32
   must fail; the DP×TP step on (data 1 x model 2) (K1's launches at the
   column shards, its gathered gradient within ``DP_GRAD_RTOL_OF_MAX`` of
   the single-device step's, each leaf within ``TRAIN_RTOL_OF_UPDATE`` of
   the f64 step); mnist_hinge ``train
   100 0.0005 --dp`` (the convergence as f64's, the iterations replayed
   bit-equal and each teacher-forced against f64 from the ranks' gathered
   margins); cifar_unet ``train 1 --dp --image-size=64 --max-steps=20``
   (batch 16 = 2 x 8; finite, falling losses, the replicas bit-equal, K2,
   K2c and K2d 4 each per rank per step), ``train 1 --dp --fused-block
   --max-steps=10`` at 32x32 (K5a and K5b per rank as many as the gate's
   blocks at batch 8, all on the tensor-core route; replicas bit-equal)
   and one resumed step; ring attention, bf16 (4, 8192, 64) and f32 (2,
   2048, 16) (K2, K2c and K2d twice each per rank, two runs bit-equal, o,
   dq, dk and dv within 2e-2 of max|ref| in bf16 and phase 5's and 8's
   bounds in f32 of the plain flash over the whole sequence); then each
   rank's host wall, busy share and collectives per step or call
   (``tools/parallel_check.py`` runs it alone);
25. the U-Net's tensor parallelism and the pipeline modes (run after 24,
   with its launcher; ``tools/pipeline_check.py`` runs it alone), in fresh
   temporary data directories, full width: on 2 ranks ``cifar_unet train
   1 --tp --image-size=64 --max-steps=5`` (K2, K2c and K2d 4 each per rank
   per step), an f32 TP step's gathered gradient and a DP×TP step's first
   moment on (data 1 x model 2) against the single-device step on the same
   card at the same conditioned parameters, draws and masks
   (``PARALLEL_GRAD_RTOL_OF_MAX`` per leaf; the gradient from TF32-
   truncated operands must fail it); on 3 ranks ``train 1 --pp
   --pp-micro=4 --image-size=64 --max-steps=5`` under GPipe and under 1F1B
   resuming it (K2, K2c and K2d per stage derived from the flash sites it
   holds, 1F1B's recompute running K2 again; the replicas bit-equal), and
   ``--pp --fused-block`` at 32x32 (K5a/K5b per stage as many as the gate's
   blocks there at microbatch 4, all on the tensor cores), one f32 step's
   GPipe and 1F1B gradients against the sequential run of the stages with
   the same folds (the same bound and control); on 6 ranks ``train 1 --pp
   --dp --pp-micro=4 --fused-block --max-steps=3`` (stage 3 x data 2; K5
   per rank, the replicas bit-equal); each rank's step wall, collective
   time and bytes, and its stage's share of a pipeline step in its units
   beside ``hetero_stats``' utilizations;
5. K2 against plain, on the card: f32/bf16 x d in {16, 64} x (B, N) in
   {(1, 1024) the U-Net's shape, (2, 300) ragged, (1, 4096), (1, 16384),
   (8, 1024) and (4, 1024) a U-Net DP rank's at 2 and 4 ranks (and a
   pipeline stage's at microbatch 4), (16, 1024) a train step's and a TP
   rank's},
   and the other head dims the kernel takes at (2, 300); o and lse against
   ``_plain_flash``, and bf16 operands that are views one element past an
   aligned buffer; two bf16 runs bit-equal at (1, 1024, 16) and at (16,
   1024, 16); the bf16 tensor-core kernels' registers, shared memory,
   spills, blocks per SM and HMMA count, failing on a spill or on no HMMA;
   then the kernel's time beside the plain version's and
   ``F.scaled_dot_product_attention``'s, the library yardstick, at (1,
   1024, 16), (16, 1024, 16) and (4, 4096, 64);
6. cifar_unet main path: ``cifar_unet init`` then ``run 1
   --image-size=64`` (DDPM sampling, 1000 full-width U-Net forwards) in a
   temporary data directory, with K2's launch count read around ``run``;
   the sample must read back as a 64x64 BMP that is not constant;
7. U-Net oracle: from the same checkpoint, one full-width forward at 64x64
   in f32 through the kernel against the same forward in f64 on the card
   (dense attention, as the dispatch takes for f64); the bf16 forward's
   error is reported beside it; then one bf16 forward's device and host
   time;
8. K2c/K2d against plain, on the card: f32/bf16 x d in {16, 64} x (B, N)
   in {(16, 1024) the train step's shape, (2, 300) ragged, (1, 4096), (8,
   1024) and (4, 1024) a U-Net DP rank's}, and
   the other head dims at (2, 300); dq, dk, dv against
   ``_plain_flash_bwd`` on the same (q, k, v, o, lse, g); the bf16
   tensor-core kernels' registers, shared memory and spills (the build's
   ``-Xptxas -v``), blocks per SM and HMMA count (``cuobjdump -sass``),
   failing on a spill or on no HMMA; two bf16 runs bit-equal; then each
   kernel's time beside the plain backward's and the backward of
   ``F.scaled_dot_product_attention``, the library yardstick;
9. cifar_unet train path: in a fresh temporary data directory,
   ``ensure_cifar``, ``cifar_unet init``, then ``train 1 --image-size=64
   --max-steps=50`` (full width, batch 16, bf16 compute over f32 masters,
   Adam) with the launch counts of K2, K2c and K2d read around it; every
   step's loss finite and the last 10 steps' mean below the first 10's; a
   step directory in ``train_state_torch/``; then ``train 1
   --image-size=64 --max-steps=10`` must resume at epoch 1;
10. gradient oracle: from the trained checkpoint, one f32 full-width 64x64
   gradient at batch 2 on fixed draws through K2c/K2d, on the net with each
   attention site's q and k scaled down to an unsaturated softmax; each leaf
   against the same gradient with the plain backward at the four flash
   sites (bounded), and against the f64 gradient (reported); the kernels
   against the plain backward on each flash site's operands (bounded); the
   bf16 gradient of the trained net itself finite, with its flash sites'
   score range; then one bf16 batch-16 train step's host and device time;
11. K5 against plain, on the card: K5a and K5b (its data-gradient and
   weight-gradient kernels) against ``_plain_fused_fwd`` and
   ``_plain_fused_bwd`` on the same inputs, f32/bf16 x train on/off at the
   path's blocks (16, 256, 8x8), (16, 512 -> 256, 4x4), (1, 512 -> 256,
   8x8) and a TINY-width one, with the count of K5a's cases on each route
   (bf16 at full width: the tensor cores; f32 and the TINY block: FMA);
   the kernels' dropout bits bit-equal to the plain version's; then the
   tensor-core K5a alone, bf16 x train on/off at each split and map its
   plan chooses (B = 1, 4, 5, 16; 8x8 and 4x4; C = 256 and 512 -> 256
   with w3) and at a U-Net DP rank's fused blocks (batch 8 and 4), its
   plan equal to the C side's, two runs bit-equal; its
   registers, shared memory, spills, blocks per SM, clusters resident at
   once and HMMA count, failing on a spill or on no HMMA; then K5b with its
   data gradients on the tensor-core route, bf16 x train on/off at (16,
   256, 8x8), (16, 512 -> 256, 4x4), (1, 512 -> 256, 8x8), (16, 256, 4x4),
   (5, 512 -> 256, 8x8), (1, 256, 8x8) and a U-Net DP rank's fused blocks
   (batch 8 and 4), every output within 2e-2 of
   max|ref| of ``_plain_fused_bwd``, every case on that route, its plan
   equal to the C side's, two runs bit-equal, and the same build record;
12. K5 timing: K5a on both routes (the FMA route forced on the same bf16
   input) and K5b beside the plain versions and the port's unfused block
   (cuDNN convs, GN), at the train step's and the sampler's 8x8 blocks and
   at 15 examples, with the bounds, the tensor-core plan's split and grid,
   and host time per call; then K5b's two kernels apart at the train
   step's three blocks (bf16, train): its data-gradient kernel on the
   tensor cores and on the FMA route forced on the same input, its
   weight-gradient kernel beside ``torch.nn.grad.conv2d_weight``, with
   each kernel's bound and host time per call;
13. ``cifar_unet run 1 --fused-block`` at 32x32 (full width, 1000 DDPM
   steps) from phase 6's checkpoint, with K5a's launches read around it,
   every one on the tensor-core route; a non-constant 32x32 BMP;
14. fused oracle: one f32 full-width 32x32 forward with the fused blocks
   against the same forward unfused (bounded) and f64 (reported); one
   bf16 forward with the fused blocks (the tensor-core K5a) against the
   bf16 forward unfused (bounded by twice the unfused one's distance from
   f64); then one f32 train-mode gradient at batch 16 (K5b's data
   gradients on the FMA route): K5b against the plain backward on every
   fused block's operands (bounded), the gradient's leaves against the one
   with the plain backward at those blocks (reported); then one bf16
   train-mode gradient at batch 16, K5b (its data gradients on the
   tensor-core route) within 2e-2 of max|ref| of the plain backward on
   every fused block's operands;
15. ``cifar_unet train 1 --fused-block --max-steps=30`` at batch 16 (9
   fused blocks: up_2 resnet_1 fails the gate) with the launches of K5a
   and K5b read around it, every K5a and every K5b data-gradient launch on
   the tensor-core route; finite losses, the last 10 steps' mean below the
   first 10's; then one resumed step; then one bf16 train step at that
   configuration profiled (``torch.profiler``, ``trace_summary.py``): the
   card's busy share and K5b's share of the device time, with the data
   gradients on their route and on the FMA route forced, in turns;
16. K4 against plain, on the card: ``conv2d_implicit`` and
   ``conv2d_packed`` (forward and dx, two launches each) against the plain
   tap sum, f32/bf16 at the U-Net's 3x3 maps at batch 16 (32x32 to 4x4) and
   a non-square 5x5 case, and ``conv2d_implicit`` on bf16 operands that
   are views one element past an aligned buffer;
17. K4's kernels (bf16 on the tensor cores, f32 on the CUDA cores):
   registers, shared memory, spills, blocks per SM and HMMA count, failing
   on a spill or on a bf16 kernel without HMMA; then K4's time beside the
   plain version and ``F.conv2d`` at (16, 128, 32x32) and (16, 256,
   16x16), bf16 and f32, with the bounds and the tile rule, two runs
   bit-equal at each;
18. K4 at the U-Net's sites: every stride-1 3x3 conv of one f32 32x32
   forward at batch 16 from phase 6's checkpoint, through both entry points
   (forward, dx, dk) against ``conv2d`` in f64, with K4's launches read
   around them; K4's forward summed over the sites beside ``F.conv2d``'s,
   f32 and bf16; then ``conv2d_im2col`` at one site, with K1's nn, tn and
   nt launches;
19. K3 against plain, on the card: ``flash_attention(..., stream=False)``
   through autograd against ``_plain_flash_bwd``, f32/bf16 x d 16, 64 x
   (B, N) (2, 300), (16, 1024) x blocks (512, 1024), (384, 256), on the
   fused route (K3a) and with the budget at 0 on the two-pass route (K2c +
   K2d); two K3a runs bit-equal; a bf16 case at |s| ~ 1e5 finite and as
   close to the plain backward with f64 sums as the plain f32 version;
20. K3a's bf16 tensor-core kernels: registers, shared memory, spills,
   blocks per SM, cluster size and HMMA count, failing on a spill or on no
   HMMA; K3 timing: K3a beside K2c + K2d, the plain backward and SDPA's
   backward at (16, 1024, 16) and (4, 4096, 64), bf16, with the bounds and
   the dq workspace; K3a beside K2c + K2d in f32 at (16, 1024, 16);
21. K3 at the U-Net's sites: phase 10's four flash sites through
   ``flash_attention(..., stream=False)`` (K3a, then the two-pass route),
   with the launches read around them, against the plain backward;
26. ``--layout=NHWC`` and ``--remat`` (run after 10, in its data
   directory; ``tools/layout_remat_check.py`` runs it alone): the
   channels-last twins against the NCHW ops on the same values, forward
   and backward, f32 (bounds that scale with the longest sum; a TF32 conv
   must fail its bound) and bf16 (``BF16_RTOL_OF_MAX``), at the net's
   shapes (conv 3x3 at (16, 128, 64, 64) and the stride-2 downsample, GN
   at (16, 256, 32, 32), the attention block at 32x32 tokens through K2
   and K2c/K2d), the conv's output and dx and GN's output in channels-last
   memory; ``run 1 --image-size=64 --layout=NHWC`` from phase 10's tree
   (K2 as often as phase 6's NCHW run, a 64x64 BMP) and one bf16 forward
   against NCHW's (``P26_BF16_FACTOR`` times NCHW's distance from f64);
   ``train 1 --image-size=64 --layout=NHWC --max-steps=50`` from the
   seed's init (K2, K2c and K2d 4 each a step, a falling loss), then
   ``train 1 --fused-block --layout=NHWC`` at 32x32 (no fused block); the
   f32 NHWC gradient against NCHW's on phase 10's conditioned net, leaf by
   leaf within max(``P26_GRAD_FLOOR``, twice NCHW's own distance from
   f64), the TF32 control failing it; a ``--remat`` step at 64x64, batch
   16, bf16, bit-equal to the plain step, with each one's peak of
   allocated memory (and NHWC's); NCHW, NHWC and ``--remat`` steps in
   turns (host wall, device busy); one launch of ``train 1 --dp
   --layout=NHWC --remat --max-steps=2`` on two ranks (the replicas
   bit-equal after each step, 18 blocks recomputed a step, K2, K2c and
   K2d 4 each a step per rank);
27. the XLA dispatch modes as replayed CUDA graphs (``utils/graphs.py``;
   run after 26, on phase 10's tree; ``tools/graph_check.py`` runs it
   alone): the graphed sampler against the eager one at full width 64x64
   on a 40-step schedule (bit-equal images, K2 4 a step) and ``run 1
   --image-size=64`` through the CLI (K2 4000 by the counters); ``train 1
   --image-size=64`` (the graphed device epoch, 50 steps on an 800-image
   set) against ``--host-loop`` from the same tree (train states bit-equal:
   parameters, Adam moments and step, the generator's state; K2, K2c and
   K2d 4 a step); ``TrainSteps`` (one warm-up step, then replays of 4)
   against 21 ``train_step`` calls at 64x64 bf16, 32x32 ``--fused-block``
   (K5a and K5b 9 a step), ``--remat``, ``--bf16-params`` and
   ``--layout=NHWC``, and ``--scan-steps=5`` over 23 steps (a ragged tail
   of 3), every parameter, moment, loss and the generator's state bit for
   bit, the launches equal; mnist_nn's graphed resident epoch against the
   eager one (bit-equal, K1 640); the graphed U-Net steps with f32
   parameters take the in-place Adam pass (``ceil(122 / 48)`` = 3
   launches a step; none under ``--bf16-params`` or in the eager steps),
   the other launches equal; for two replays of three graphs, in a
   process of its own (``--phase27-counters``), the counters' launches
   (the Adam pass's too) against the kernels ``torch.profiler`` records;
   the
   sampler's, the U-Net train step's and the mnist_nn step's host time a
   step, device busy and images/s, graph against eager in turns; the peak
   of allocated memory, eager against graphs of 4 and 1 steps;
28. the last one-dispatch loops as CUDA graphs (run last;
   ``tools/graph_check.py --phase=28`` runs it alone): my_first_model
   ``train 800 0.1``, the legacy mnist ``train 1000 0.05 0`` and
   mnist_hinge ``train 100 0.0005``, each from one ``init``'s CSVs graphed
   (``make_sgd_scan``'s graphs of 2 steps; a whole hinge chunk a graph)
   and inside ``graphs.eager()``: the loop's parameters and every cost
   (the hinge's weights and norm history after every chunk, its
   convergence), the saved parameters and the printed lines bit-equal;
   the three loops' host time a step, graph against eager in turns,
   beside the device busy share; a one-rank NCCL world on the card:
   ``spmd._psum_leaves`` over the world group captured in a
   ``StepGraph`` and replayed 3 times, the sums right and the collective
   counters advanced per replay. (Phase 24 checks that ranks sharing the
   card over gloo print the eager rule and keep their counts; the DP and
   TP epochs graphed over NCCL need a card a rank: ``tools/graph_check.py
   --ranks=4 --spawned``.)
29. the in-place Adam pass (``csrc/adam.cu``, ``nn/optim.py``
   ``adam_update_at_``; run after 15, in its data directory): the
   kernel's registers, shared memory and spills; 3 steps at the
   full-width U-Net's 122 leaves from random moments, every parameter and
   moment bit-equal to ``adam_update_at``, 3 launches a call; its device
   time beside the plain update (``adam_update_at`` and the copy-back)
   and ``torch._fused_adam_``, each over replays of a CUDA graph, in
   turns, against its bytes bound (28 B a parameter over 3.35 TB/s); then
   ``train 1 --fused-block --scan-steps=5 --max-steps=30`` from phase
   15's train state, the pass's launches (3 a step) read from 0;
Then a JSON line of per-kernel results (K1's launches: phase 4's ``run``
and phase 22's train epoch), the ``nvidia-smi`` name/power-limit line, and
as the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

# The port must run without JAX: make any import of it fail loudly.
sys.modules["jax"] = None

import torch  # noqa: E402

# Tolerances of the kernel against its plain version on the same inputs.
# f32: true-f32 FMA on both sides; only the summation order differs. That
# error grows with the partial sums, so the bound scales with the operands,
# not with a fixed output size:
#     |kernel - plain| <= F32_ULPS * K * max|a| * max|b| * 2**-24.
# A TF32 product (inputs cut to a 10-bit mantissa) errs by about
# sqrt(K) * |a||b| * 2**-11, more than ten times this bound at the main
# path's K; phase 3 shows that such a product fails it.
F32_ULPS = 8
# bf16: identical bf16 inputs, f32 accumulation on both sides, then one
# rounding to bf16 (relative step 2**-8); 2e-2 of max|ref| leaves room for
# the output rounding and the summation order.
BF16_RTOL_OF_MAX = 2e-2
# Main path: f32 kernel logits against the CPU f64 plain path.
LOGIT_ATOL = 1e-3
# mnist_nn train 1 on the card (f32, K1) against the same epoch on the CPU
# in f64 (plain path) from the same CSVs and permutation, leaf by leaf:
#     max|card - f64| <= TRAIN_RTOL_OF_UPDATE * max|f64 - initial|.
# Fixed before the first run, from the CPU plain path's f32 epoch against its
# f64 epoch on the same synthesized set (three permutations): 2.2e-7 to
# 3.6e-5 of each leaf's largest update; but 6.0e-4 (b1) when one layer-1
# pre-activation falls within f32 rounding of 0 and its ReLU mask flips for
# one example and step. 5e-3 leaves room for several such flips and still
# fails a gradient that is off by 0.5% of the epoch's update. (Against
# max|ref| the weights would say little: one epoch moves them by ~3% of
# their initial size.)
TRAIN_RTOL_OF_UPDATE = 5e-3
# The rank counts whose per-rank shapes the kernel phases hold (3, 5, 8, 11):
# phase 24's two ranks and the four-card run (tools/parallel_check.py
# --ranks=4).
DP_RANK_COUNTS = (2, 4)
# A DP (or DP×TP) step's gradient on the card against the f64 gradient of
# the same batch at the same parameters with the card's ReLU decisions
# (phase 24), max|err| / max|ref| per leaf. Fixed before the first run from
# readings of sound runs (each shard's gradient at 1, 2 and 4 shards of
# batch 64 on an H100, teacher-forced over an epoch: 1.8e-7 to 5.8e-7;
# tools/mnist_dp_check.py) and of a control that the phase runs and needs
# to fail: the same gradient from operands truncated to TF32's 10-bit
# mantissa, as a TF32 product would see them (1.3e-3 to 2.5e-3).
DP_GRAD_RTOL_OF_MAX = 1e-5

# K2 against its plain version on the same inputs. f32: both sides exp2 and
# sum in f32 and differ only in the order of the sums (the kernel merges
# per-tile partial sums); the JAX tests' flash tolerance
# (tests/test_attention.py) bounds o, elementwise |kernel - plain| <=
# K2_F32_ATOL + K2_F32_RTOL * |plain|.
K2_F32_RTOL = 2e-4
K2_F32_ATOL = 2e-5
# lse: f32 logsumexp of O(1..10) values on both sides.
K2_LSE_ATOL = 1e-4
# bf16: the same bf16 q and P roundings on both sides, but P is rounded
# against the running max of a tile on the card and against the row max in
# the plain version, so single probabilities may round apart by a bf16 step
# (2**-8); o is then rounded to bf16 once.
K2_BF16_RTOL_OF_MAX = 2e-2
# U-Net oracle: the f32 forward through the kernel against the f64 forward.
UNET_F32_RTOL_OF_MAX = 1e-3

# K2c/K2d against their plain version on the same inputs. f32: both sides
# form p, dp and ds in f32 and differ in the order of the sums over keys
# (query rows for dk/dv), as K2 does; the JAX tests' flash-backward
# tolerance (tests/test_attention.py) bounds each element:
#     |kernel - plain| <= K2BWD_F32_ATOL + K2BWD_F32_RTOL * |plain|.
K2BWD_F32_RTOL = 3e-4
K2BWD_F32_ATOL = 3e-5
# bf16: ds and p are rounded to bf16 before their products on both sides,
# but from f32 values that differ in the last bits, so single terms may
# round a bf16 step (2**-8) apart; the outputs are rounded to bf16 once.
K2BWD_BF16_RTOL_OF_MAX = 2e-2
# Gradient oracle: the kernels' own share of an f32 full-width gradient,
# leaf by leaf. The trained checkpoint's scores span up to ~1e6 within a row
# at the up_3 sites: the softmax is saturated there, and the backward
# through it amplifies a 1e-7 difference at a site into 1e-3..1 of a small
# leaf's max|ref| (f32 against f64 alike). So the gradient is taken on a
# conditioned net: each attention site's q and k projections scaled down,
# in forward order, until the widest row of its scores q.k^T/sqrt(d) spans
# GRAD_SCORE_RANGE (the TINY net's widest row at 64x64 with q and k scaled
# by 0.1, where the CPU tests hold the port's f32 gradient within 2e-4 of
# JAX's at every leaf). There, each leaf of the gradient through K2c/K2d is
# within GRAD_SHARE_RTOL_OF_MAX of that leaf's max|ref| of the gradient with
# the plain backward at the four flash sites: summation order alone, in f32,
# where every other op is the same.
GRAD_SCORE_RANGE = 16.0
GRAD_SHARE_RTOL_OF_MAX = 1e-3

# K5a/K5b against their plain version on the same inputs, the JAX tests'
# fused-block tolerances (tests/test_fused_block.py), elementwise |kernel -
# plain| <= atol + rtol*|plain|, for the block's output and its gradients.
# In f32 the plain version is evaluated in f64 on the kernel's f32 inputs:
# the weight gradients sum B*HW = 1024 products per element, and where an
# element is near 0 only the atol applies, which the f32 summation error of
# either side alone nearly fills (the plain f32 version's error against
# f64 is reported beside the kernel's).
K5_F32_ATOL, K5_F32_RTOL = 2e-5, 2e-5
K5_GRAD_ATOL, K5_GRAD_RTOL = 5e-5, 5e-4
# bf16: the same bf16 operands on both sides, f32 sums in other orders, so
# a rounding to bf16 (a1, d, dh1t, the outputs) may fall a step (2**-8)
# apart.
K5_BF16_RTOL_OF_MAX = 2e-2
# Fused oracle: the f32 forward with the fused blocks against the same
# forward unfused. Both are f32 with other rounding (one-pass GN statistics,
# other sum orders) in ten blocks; the net amplifies rounding as it does
# f32 against f64 at 64x64, where phase 7 measured 6.1e-4 of max|ref|
# (PERF.md). Fixed before the first run: 1e-3 of max|ref|, phase 7's bound.
K5_UNET_RTOL_OF_MAX = 1e-3
# The bf16 forward with the fused blocks against the bf16 forward unfused.
# The random-weight net amplifies bf16 rounding (phase 7's bf16 forward is
# O(1) of max|ref| from f64 at 64x64; PERF.md), so no fixed share of max|ref|
# holds both; the fused block rounds less than the unfused one (h1t and GN
# 2's input stay f32). Fixed before the first run: |fused - unfused| <=
# K5_UNET_BF16_FACTOR * |unfused - f64| (max over elements): the triangle
# bound when the fused forward is no farther from f64 than the unfused.
K5_UNET_BF16_FACTOR = 2.0
K5A_TPU_KERNEL = "big_linear_algebra_tpu/nn/fused_block.py:396"
K5B_TPU_KERNEL = "big_linear_algebra_tpu/nn/fused_block.py:441"
# (B, C, F, H, W, group size): the train step's 8x8 block, up_1 resnet_1 at
# batch 16, up_2 resnet_1 in sampling, and a TINY-width block
K5_SHAPES = [(16, 256, 256, 8, 8, 32), (16, 512, 256, 4, 4, 32),
             (1, 512, 256, 8, 8, 32), (2, 24, 12, 8, 8, 4)]
K5_TIMED = [(16, 256, 256, 8, 8, 32), (1, 256, 256, 8, 8, 32)]
# The tensor-core K5a's own bf16 cases (forward only): each split its plan
# chooses (clusters of 16 at B <= 4, of 8 from B = 5) at 8x8 and 4x4, with
# C = 256 and 512 -> 256 (w3); K5_SHAPES' bf16 cases take it too
K5_TC_SHAPES = [(1, 256, 256, 8, 8, 32), (1, 256, 256, 4, 4, 32),
                (1, 512, 256, 4, 4, 32), (4, 256, 256, 8, 8, 32),
                (5, 512, 256, 8, 8, 32), (16, 256, 256, 4, 4, 32),
                (16, 512, 256, 8, 8, 32)]
# one example fewer than the train step: 15 clusters of 8 blocks
K5_WAVE = (15, 256, 256, 8, 8, 32)
# K5b's tensor-core data-gradient kernel's own bf16 cases (train on/off):
# K5_SHAPES' bf16 full-width cases, the train step's 4x4 block, up_2
# resnet_1 at 5 examples and the 8x8 block at one
K5B_TC_SHAPES = [(16, 256, 256, 8, 8, 32), (16, 512, 256, 4, 4, 32),
                 (1, 512, 256, 8, 8, 32), (16, 256, 256, 4, 4, 32),
                 (5, 512, 256, 8, 8, 32), (1, 256, 256, 8, 8, 32)]
# K5b's two kernels timed apart, bf16 train: the train step's blocks (8x8,
# 4x4, and up_1 resnet_1's 512 -> 256 at 4x4 with w3)
K5B_TIMED = [(16, 256, 256, 8, 8, 32), (16, 256, 256, 4, 4, 32),
             (16, 512, 256, 4, 4, 32)]
K5_RATE = 0.1  # Config.dropout_rate
FUSED_TRAIN_STEPS = 30
# fused blocks per forward at 32x32: all ten at batch 1; at batch 16 up_2
# resnet_1 (512 in-channels at 8x8) needs 58.2 MB of the gate's 50.3 MB
FUSED_PER_RUN_STEP, FUSED_PER_TRAIN_STEP = 10, 9

# K3a (and the two-pass route's K2c/K2d) against the plain backward: phase
# 8's tolerances, fixed before the first run: the same p, dp and ds in f32,
# sums in another order (K3a sums dq per key tile, then over the tiles in
# tile order).
K3A_TPU_KERNEL = "big_linear_algebra_tpu/nn/attention.py:712"
K3BC_TPU_KERNEL = "big_linear_algebra_tpu/nn/attention.py:738 and :762"
K3_SHAPES = [(2, 300), (16, 1024)]  # B, N
K3_BLOCKS = [(512, 1024), (384, 256)]  # (block_q, block_k): route only
K3_MAIN = (16, 1024, 16)  # the train step's flash shape
K3_TIMED = [K3_MAIN, (4, 4096, 64)]  # bench.py's flash shape second
# bf16 scores of |s| ~ 1e5 (q and k scaled by this, as the CPU test does)
K3_LARGE_SCALE = 300.0
# K4 against the plain tap sum: K1's scale-free f32 bound with K = C*k^2
# (F*k^2 for dx), fixed before the first run; bf16 as K1.
K4_TPU_KERNEL = "big_linear_algebra_tpu/nn/conv_implicit.py:85 and :171"
# (B, C, H, W, F, k): the full-width U-Net's 3x3 maps at batch 16 (32x32 to
# 4x4) and the JAX tests' non-square 5x5 case
K4_SHAPES = [(16, 128, 32, 32, 128, 3), (16, 256, 16, 16, 256, 3),
             (16, 256, 8, 8, 256, 3), (16, 256, 4, 4, 256, 3),
             (3, 4, 5, 7, 8, 5)]
K4_TIMED = [(16, 128, 32, 32, 128, 3), (16, 256, 16, 16, 256, 3)]
K4_ODD_VIEWS = [(16, 128, 32, 32, 128, 3), (3, 4, 5, 7, 8, 5)]  # bf16 at +1
# The bf16 |s| ~ 1e5 case, at phase 8's bf16 tolerance of max|ref|: dq, dk
# and dv against K2c + K2d on the same operands (the same scores, ds and
# roundings, summed in the same order), dv also against the plain backward
# evaluated with f64 sums (the same bf16 roundings of q^, p and ds). dq and
# dk are not held to a plain reference there: with one-hot rows they can be
# rounding noise of ds = p * (dp - delta) (dp ~ delta, and p is exp2 of a
# difference of two scores near 1e5 whose f32 sums differ in the last
# place), and the plain version in f32 is then itself about max|ref| from
# the f64 sums. Phase 19 prints each version's error against them.
# K3a's tensor-core kernel at more than one thread-block cluster of keys
# (workspace slots, then the reduce kernel) and at a last cluster of
# padding blocks: (B, N) in bf16 at d 16, 32, 64, 128.
K3_CLUSTER_SHAPES = [(1, 1100), (4, 4096)]

MAIN_SHAPES = [(2048, 784, 256), (2048, 256, 128), (2048, 128, 10)]  # M, K, N
RAGGED_SHAPE = (130, 257, 200)
# K1's block shapes, in the C entry's numbering: 128x64 tiles of 128
# threads with 8x8 each, and 128x16 tiles of 64 threads with 8x4 (N <= 16)
K1_SHAPES = ("Wide", "Thin")
TPU_KERNEL = "big_linear_algebra_tpu/ops/matmul.py:220"
K2_TPU_KERNEL = "big_linear_algebra_tpu/nn/attention.py:545"
# B, N; then a U-Net DP rank's flash sites at 64x64 (batch 8 and 4 a rank)
K2_SHAPES = [(1, 1024), (2, 300), (1, 4096), (1, 16384), (8, 1024),
             (4, 1024), (16, 1024)]
K2_MAIN = (1, 1024, 16)  # B, N, d at the U-Net's four flash sites, 64x64
K2_TRAIN = (16, 1024, 16)  # B, N, d at the flash sites of a train step
# B·heads, N, d at ADM ImageNet-64's seven 32×32 sites, batch 128 (the
# adm_imagenet64.train_b128 cell)
K2_ADM = (768, 1024, 64)
K2_TIMED = [K2_MAIN, K2_TRAIN, (4, 4096, 64), K2_ADM]
K2_ODD_VIEWS = [K2_MAIN, (2, 300, 64)]  # bf16 operands at +1 element
K2C_TPU_KERNEL = "big_linear_algebra_tpu/nn/attention.py:662"
K2D_TPU_KERNEL = "big_linear_algebra_tpu/nn/attention.py:682"
# B, N; then a U-Net DP rank's flash sites at 64x64 (batch 8 and 4 a rank)
K2BWD_SHAPES = [(16, 1024), (2, 300), (1, 4096), (8, 1024), (4, 1024)]
K2BWD_MAIN = (16, 1024, 16)  # B, N, d at the flash sites of a train step
K2BWD_TIMED = [K2BWD_MAIN, (4, 4096, 64), K2_ADM]
TRAIN_STEPS, RESUME_STEPS = 50, 10

# Peaks of one H100 SXM at its full 700 W limit (NVIDIA's data sheet, dense
# rates): HBM3 bytes/s, and FLOP/s for true f32 on the CUDA cores and for
# bf16 on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# exp2 results per clock per SM on compute capability 9.0 (CUDA C++
# Programming Guide, arithmetic instruction throughput table); times the
# SM count and the card's maximum SM clock read in phase 1.
EXP2_PER_CLOCK_PER_SM = 16


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def phase_environment():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    if clock.returncode != 0:
        fail(f"nvidia-smi failed: {clock.stderr.strip()}")
    sm_mhz = float(clock.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"[1 environment] card: {smi_line} | {sms} SMs, max SM clock "
          f"{sm_mhz:.0f} MHz | torch {torch.__version__} "
          f"| CUDA {torch.version.cuda} | python {sys.version.split()[0]}",
          flush=True)
    return smi_line, EXP2_PER_CLOCK_PER_SM * sms * sm_mhz * 1e6


def phase_build() -> None:
    from big_linear_algebra_tpu_torch.ops import cuda_utils

    names = ("matmul", "flash_attn", "flash_attn_bwd", "fused_block",
             "flash_attn_bwd_fused", "conv_implicit", "fused_block_tc",
             "adam")
    t0 = time.perf_counter()
    cuda_utils.build(names)
    for name in names:
        cuda_utils.load_library(name)
    print("[2 build] " + ", ".join(f"csrc/{n}.cu" for n in names)
          + f" built in parallel and loaded in "
          f"{time.perf_counter() - t0:.2f} s ("
          + ", ".join(cuda_utils.library_path(n).name for n in names) + ")",
          flush=True)


def _operands(variant, m, k, n, dtype, gen):
    """Stored operands for ``variant``, made on the CPU from ``gen`` at the
    main path's value scale: A like scaled pixels U[0, 1), B like He-uniform
    weights U(±√(6/K)), bias U(±0.5); on the card."""
    limit = (6.0 / k) ** 0.5
    a = torch.rand(m, k, generator=gen)
    b = (torch.rand(k, n, generator=gen) * 2 - 1) * limit
    bias = torch.rand(n, generator=gen) - 0.5
    if variant == "nt":
        b = b.T.contiguous()
    elif variant == "tn":
        a = a.T.contiguous()
    return (a.to("cuda", dtype), b.to("cuda", dtype), bias.to("cuda", dtype))


def f32_bound(a, b, k: int) -> float:
    return (F32_ULPS * k * a.abs().max().item() * b.abs().max().item()
            * 2.0 ** -24)


def train_step_gemms(sizes, batch: int):
    """(variant, M, K, N) of every GEMM of one mnist_nn train step at
    ``batch``, as nn/dense.py issues them: each layer's forward (nn), its
    data gradient (nt; none for the input layer, whose input takes no
    gradient) and its weight gradient (tn)."""
    gemms = []
    for i, (fan_in, fan_out) in enumerate(zip(sizes, sizes[1:])):
        gemms.append(("nn", batch, fan_in, fan_out))
        if i > 0:
            gemms.append(("nt", batch, fan_out, fan_in))
        gemms.append(("tn", fan_in, batch, fan_out))
    return gemms


def k1_train_gemms():
    """The GEMMs of an mnist_nn train step (``Config``'s widths and batch)
    that ``_dispatch`` sends to K1 in f32: 2*M*N*K >= ``_SMALL_FLOPS``."""
    from big_linear_algebra_tpu_torch.models import mnist_nn
    from big_linear_algebra_tpu_torch.ops import matmul as mm

    cfg = mnist_nn.CONFIG
    return [(v, m, k, n) for v, m, k, n in
            train_step_gemms(cfg.sizes, cfg.batch_size)
            if 2 * m * n * k >= mm._SMALL_FLOPS]


def k1_dp_gemms():
    """The GEMMs of a rank's mnist_nn DP step at the per-rank batch of each
    of ``DP_RANK_COUNTS`` and of its DP×TP step on (data ranks/2 x model
    2) that ``_dispatch`` sends to K1 in f32, less those of
    ``k1_train_gemms``."""
    from big_linear_algebra_tpu_torch.models import mnist_nn
    from big_linear_algebra_tpu_torch.ops import matmul as mm

    cfg = mnist_nn.CONFIG
    seen, out = set(k1_train_gemms()), []
    for ranks in DP_RANK_COUNTS:
        for v, m, k, n in (
                train_step_gemms(cfg.sizes, cfg.batch_size // ranks)
                + tp_step_gemms(cfg.sizes, cfg.batch_size // (ranks // 2),
                                2)):
            if 2 * m * n * k >= mm._SMALL_FLOPS and (v, m, k, n) not in seen:
                seen.add((v, m, k, n))
                out.append((v, m, k, n))
    return out


def phase_kernel_vs_plain() -> float:
    """Every case against the plain version; returns the worst f32 max abs
    error."""
    from big_linear_algebra_tpu_torch.ops import matmul as mm

    gen = torch.Generator().manual_seed(0)
    worst_abs = 0.0
    # f32: err / bound; bf16: err / max|ref|
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n_cases = 0
    bad = []
    cases = [(variant, m, k, n, dtype)
             for m, k, n in MAIN_SHAPES + [RAGGED_SHAPE]
             for variant in ("nn", "nt", "tn")
             for dtype in (torch.float32, torch.bfloat16)]
    train = [(v, m, k, n, torch.float32) for v, m, k, n in k1_train_gemms()]
    dp = [(v, m, k, n, torch.float32) for v, m, k, n in k1_dp_gemms()]
    worst_train = worst_dp = 0.0
    for variant, m, k, n, dtype in cases + train + dp:
        a, b, bias = _operands(variant, m, k, n, dtype, gen)
        if dtype == torch.float32:
            tol = f32_bound(a, b, k)
        for use_bias, act in ((False, None), (True, None),
                              (True, "relu")):
            bb = bias if use_bias else None
            got = mm._kernel_mm(a, b, variant, dtype, bb, act)
            want = mm._plain_mm(a, b, variant, dtype, bb, act)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            case = (f"{variant} {str(dtype)[6:]} M={m} K={k} N={n} "
                    f"bias={use_bias} act={act}")
            if dtype == torch.float32:
                if not err <= tol:
                    bad.append(f"{case}: max abs err {err} > "
                               f"{F32_ULPS}*K*max|a|*max|b|*2^-24 "
                               f"= {tol}")
                worst[dtype] = max(worst[dtype], err / tol)
                worst_abs = max(worst_abs, err)
                if (variant, m, k, n, dtype) in train:
                    worst_train = max(worst_train, err / tol)
                if (variant, m, k, n, dtype) in dp:
                    worst_dp = max(worst_dp, err / tol)
            else:
                scale = want.float().abs().max().item()
                rel = err / scale
                if not rel <= BF16_RTOL_OF_MAX:
                    bad.append(f"{case}: err {err} / max|ref| "
                               f"{scale} = {rel} > "
                               f"{BF16_RTOL_OF_MAX}")
                worst[dtype] = max(worst[dtype], rel)
            n_cases += 1
    if bad:
        fail(f"{len(bad)} of {n_cases} kernel cases disagree with the plain "
             "version:\n  " + "\n  ".join(bad))
    train_shapes, dp_shapes = (", ".join(f"{v} M={m} K={k} N={n}"
                                         for v, m, k, n, _ in gemms)
                               for gemms in (train, dp))
    print(f"[3 kernel vs plain] {n_cases} cases pass: f32 max abs err "
          f"{worst_abs:.3e}, worst err / bound {worst[torch.float32]:.3f} "
          f"(bound {F32_ULPS}*K*max|a|*max|b|*2^-24); bf16 max err / "
          f"max|ref| {worst[torch.bfloat16]:.3e} (tol {BF16_RTOL_OF_MAX}); "
          f"of them {3 * len(train)} f32 cases at the mnist_nn train step's "
          f"K1 GEMMs ({train_shapes}), worst err / bound "
          f"{worst_train:.3f}; {3 * len(dp)} f32 cases at a rank's K1 GEMMs "
          f"of the DP and DP x TP steps at {DP_RANK_COUNTS} ranks "
          f"({dp_shapes}), worst err / bound {worst_dp:.3f}", flush=True)
    return worst_abs


def phase_tf32_control() -> None:
    """The f32 bound must reject a TF32 product: the plain nn product at the
    layer shapes with TF32 on, against the same with TF32 off."""
    from big_linear_algebra_tpu_torch.ops import matmul as mm
    from big_linear_algebra_tpu_torch.ops import precision

    gen = torch.Generator().manual_seed(2)
    ratios = []
    for m, k, n in MAIN_SHAPES:
        a, b, _ = _operands("nn", m, k, n, torch.float32, gen)
        want = mm._plain_mm(a, b, "nn", torch.float32, None, None)
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = mm._plain_mm(a, b, "nn", torch.float32, None, None)
        finally:
            precision.apply()
        err = (tf32 - want).abs().max().item()
        ratio = err / f32_bound(a, b, k)
        if not ratio > 1.0:
            fail(f"TF32 product at M={m} K={k} N={n} passes the f32 bound "
                 f"(err / bound {ratio}): the bound cannot tell TF32 from "
                 "true f32")
        ratios.append(f"K={k}: {ratio:.1f}")
    print(f"[3 tf32 control] a TF32 product fails the f32 bound at every "
          f"layer shape: err / bound {', '.join(ratios)}", flush=True)


def _time_ms(fn, iters=100, warmup=10):
    """(device ms, host ms) per call of ``fn``.

    Device: CUDA events around ``iters`` calls queued behind a spin kernel
    (``torch.cuda._sleep``), so the calls run back to back on the card and
    the host's per-call cost is hidden. Host: wall clock per call, ending
    in a synchronise, which includes the wrapper's Python and launch cost."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)  # ~50 ms: longer than enqueueing the calls
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    device_ms = start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    return device_ms, host_ms


def phase_timing() -> dict:
    """f32 nn at the mnist_nn layer shapes with the layer's own epilogue.
    Kernel, plain version (torch.matmul + bias + ReLU) and bare torch.matmul,
    in turns (kernel, plain, matmul, matmul, plain, kernel) within this one
    process; the lower of each pair is kept."""
    from big_linear_algebra_tpu_torch.ops import matmul as mm

    gen = torch.Generator().manual_seed(1)
    names = ("kernel", "plain", "torch.matmul")
    totals = {name: 0.0 for name in names}
    host_totals = {name: 0.0 for name in names}
    for i, (m, k, n) in enumerate(MAIN_SHAPES):
        a, b, bias = _operands("nn", m, k, n, torch.float32, gen)
        act = "relu" if i < 2 else None
        fns = {
            "kernel": lambda: mm._kernel_mm(a, b, "nn", torch.float32,
                                            bias, act),
            "plain": lambda: mm._plain_mm(a, b, "nn", torch.float32,
                                          bias, act),
            "torch.matmul": lambda: torch.matmul(a, b),
        }
        runs = {name: [] for name in names}
        for name in names + names[::-1]:
            runs[name].append(_time_ms(fns[name]))
        ms = {name: min(d for d, _ in runs[name]) for name in names}
        host = {name: min(h for _, h in runs[name]) for name in names}
        for name in names:
            totals[name] += ms[name]
            host_totals[name] += host[name]
        tflops = 2 * m * n * k / (ms["kernel"] * 1e-3) / 1e12
        print(f"[3 timing] f32 nn M={m} K={k} N={n} act={act}: device "
              f"kernel {ms['kernel'] * 1e3:.2f} us ({tflops:.2f} TFLOP/s), "
              f"plain {ms['plain'] * 1e3:.2f} us, torch.matmul "
              f"{ms['torch.matmul'] * 1e3:.2f} us | host per call: kernel "
              f"{host['kernel'] * 1e3:.2f} us, plain {host['plain'] * 1e3:.2f}"
              f" us, torch.matmul {host['torch.matmul'] * 1e3:.2f} us",
              flush=True)
    bound = sum(k1_bound_ms(m, k, n)[0] for m, k, n in MAIN_SHAPES)
    totals["bound"] = bound
    print(f"[3 timing] one mnist_nn forward (3 layers, batch 2048), device: "
          f"kernel {totals['kernel'] * 1e3:.2f} us, plain "
          f"{totals['plain'] * 1e3:.2f} us, torch.matmul "
          f"{totals['torch.matmul'] * 1e3:.2f} us; host per forward: kernel "
          f"{host_totals['kernel'] * 1e3:.2f} us, plain "
          f"{host_totals['plain'] * 1e3:.2f} us; bound "
          + ", ".join(f"{k1_bound_ms(m, k, n)[0] * 1e3:.2f} us "
                      f"({k1_bound_ms(m, k, n)[1]})"
                      for m, k, n in MAIN_SHAPES)
          + f" = {bound * 1e3:.2f} us", flush=True)
    return totals


def phase_train_gemm_timing() -> dict:
    """f32 K1 at each of the mnist_nn train step's K1 GEMMs, the forwards
    with their layer's bias+ReLU epilogue: the kernel, the plain version and
    bare torch.matmul on the same stored operands (the transposes as
    views), in turns (kernel, plain, matmul, matmul, plain, kernel), the
    lower of each pair kept; with each GEMM's bound. Returns the sums over
    one step's K1 GEMMs."""
    from big_linear_algebra_tpu_torch.ops import matmul as mm

    gen = torch.Generator().manual_seed(3)
    names = ("kernel", "plain", "torch.matmul")
    totals = {name: 0.0 for name in names + ("bound",)}
    parts = []
    for variant, m, k, n in k1_train_gemms():
        a, b, bias = _operands(variant, m, k, n, torch.float32, gen)
        fwd = variant == "nn"  # a layer's forward: bias and ReLU fused
        bias, act = (bias, "relu") if fwd else (None, None)
        op_a = a.T if variant == "tn" else a
        op_b = b.T if variant == "nt" else b
        fns = {
            "kernel": lambda: mm._kernel_mm(a, b, variant, torch.float32,
                                            bias, act),
            "plain": lambda: mm._plain_mm(a, b, variant, torch.float32,
                                          bias, act),
            "torch.matmul": lambda: torch.matmul(op_a, op_b),
        }
        runs = {name: [] for name in names}
        for name in names + names[::-1]:
            runs[name].append(_time_ms(fns[name]))
        ms = {name: min(d for d, _ in runs[name]) for name in names}
        host = min(h for _, h in runs["kernel"])
        bound, bound_by = k1_bound_ms(m, k, n, bias=fwd)
        for name in names:
            totals[name] += ms[name]
        totals["bound"] += bound
        parts.append(f"{variant} M={m} K={k} N={n}"
                     f"{' +bias+ReLU' if fwd else ''}: kernel "
                     f"{ms['kernel'] * 1e3:.2f} us (host per call "
                     f"{host * 1e3:.2f} us), plain {ms['plain'] * 1e3:.2f} "
                     f"us, torch.matmul {ms['torch.matmul'] * 1e3:.2f} us, "
                     f"bound {bound * 1e3:.3f} us ({bound_by})")
    print("[3 timing train step] f32 K1 at the mnist_nn train step's K1 "
          "GEMMs (batch 64), device: " + "; ".join(parts)
          + f" | per step: kernel {totals['kernel'] * 1e3:.2f} us, plain "
          f"{totals['plain'] * 1e3:.2f} us, torch.matmul "
          f"{totals['torch.matmul'] * 1e3:.2f} us, bound "
          f"{totals['bound'] * 1e3:.3f} us", flush=True)
    return totals


def phase_k1_bitequal() -> None:
    """Two runs of K1 on the same operands must be bit-equal at each
    mnist_nn layer shape and the ragged one, for nn, nt and tn in f32 with
    the bias+ReLU epilogue (split-K sums the cluster's partial tiles in
    rank order; no atomics)."""
    from big_linear_algebra_tpu_torch.ops import matmul as mm

    gen = torch.Generator().manual_seed(9)
    differ, n_cases = [], 0
    for m, k, n in MAIN_SHAPES + [RAGGED_SHAPE]:
        for variant in ("nn", "nt", "tn"):
            a, b, bias = _operands(variant, m, k, n, torch.float32, gen)
            first = mm._kernel_mm(a, b, variant, torch.float32, bias, "relu")
            second = mm._kernel_mm(a, b, variant, torch.float32, bias,
                                   "relu")
            torch.cuda.synchronize()
            if not torch.equal(first.view(torch.int32),
                               second.view(torch.int32)):
                differ.append(f"{variant} M={m} K={k} N={n}")
            n_cases += 1
    if differ:
        fail(f"two K1 runs differ at {differ}")
    print(f"[3 K1 bit-equal] two f32 runs bit-equal in all {n_cases} cases "
          f"(nn/nt/tn x {MAIN_SHAPES + [RAGGED_SHAPE]})", flush=True)


def phase_k1_build_info() -> None:
    """K1's kernels (wide and thin block shape x nn/nt/tn x f32/bf16 in):
    registers, shared memory and spills from the build's ``-Xptxas -v``,
    blocks per SM of each (occupancy API), and the rule's grid at each
    mnist_nn layer shape, the ragged one and the train step's K1 GEMMs.
    Fails on a spill, a missing
    record, a block that does not fit, or a grid whose clusters do not all
    fit at once for one of the kernels
    (``cudaOccupancyMaxActiveClusters``)."""
    stats = _kernel_stats("matmul", re.compile(
        r"mm_kernelI\w*?(Wide|Thin)ELi(\d)E(f|13__nv_bfloat16)E"))
    blocks_per_sm = _int_fn("matmul", "bla_matmul_blocks_per_sm", 3)
    max_clusters = _int_fn("matmul", "bla_matmul_max_clusters", 4)
    from big_linear_algebra_tpu_torch.ops import cuda_utils

    plan = cuda_utils.load_library("matmul").bla_matmul_plan
    plan.restype = None
    plan.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    variants = ("nn", "nt", "tn")
    dtypes = (("f", "f32"), ("13__nv_bfloat16", "bf16"))
    bad, parts = [], []
    for shape in K1_SHAPES:
        for variant in range(3):
            for dt, (mangled, dname) in enumerate(dtypes):
                st = stats.get((shape, str(variant), mangled), {})
                st["blocks"] = blocks_per_sm(K1_SHAPES.index(shape), variant,
                                             dt)
                what = f"mm_kernel<{shape}, {variants[variant]}, {dname}>"
                why = _check_stats(what, st, False)
                if why:
                    bad.append(why)
                    continue
                parts.append(f"{what} {st['regs']} regs, {st['smem']} B "
                             f"smem, spill {st['spill']} B, {st['blocks']} "
                             f"blocks/SM")
    if bad:
        fail("K1 kernels (spill, incomplete record or no block fits):\n  "
             + "\n  ".join(bad))
    grids = []
    train = [(m, k, n) for _, m, k, n in k1_train_gemms() + k1_dp_gemms()]
    for m, k, n in MAIN_SHAPES + [RAGGED_SHAPE] + list(dict.fromkeys(train)):
        out = (ctypes.c_int * 4)()
        plan(m, n, k, out)
        shape, mt, nt, sp = out
        fit = min(max_clusters(shape, variant, dt, sp)
                  for variant in range(3) for dt in range(2))
        if mt * nt > fit:
            fail(f"K1 at M={m} K={k} N={n}: {mt * nt} clusters of {sp} "
                 f"blocks, but the card holds {fit} at once for one of the "
                 f"{K1_SHAPES[shape]} kernels")
        grids.append(f"M={m} K={k} N={n}: {K1_SHAPES[shape]} tiles {mt}x{nt}"
                     f", {sp} K splits (cluster) -> {mt * nt * sp} blocks "
                     f"({mt * nt} clusters; each of the 6 kernels holds at "
                     f"least {fit} at once)")
    print("[3 K1 build] " + "; ".join(parts) + " | grids: "
          + "; ".join(grids), flush=True)


def _bound(nbytes: float, ops_s: float):
    """(ms, what bounds it): the larger of the bytes over the HBM rate and
    ``ops_s``, the operations' time at their peak rate."""
    bytes_s = nbytes / HBM_BYTES_PER_S
    if bytes_s >= ops_s:
        return bytes_s * 1e3, "bytes"
    return ops_s * 1e3, "operations"


def k1_bound_ms(m: int, k: int, n: int, bias: bool = True):
    """K1 f32 (any variant), with a bias unless ``bias`` is False: A, B and
    the bias read once, C written once; 2·M·N·K flops at the f32 CUDA-core
    peak."""
    nbytes = 4 * (m * k + k * n + n * bias + m * n)
    return _bound(nbytes, 2 * m * n * k / PEAK_FLOPS[torch.float32])


def k2_bound_ms(b: int, n: int, d: int, dtype, exp2_per_s: float):
    """K2: q, k, v read once, o written once (input dtype) and lse (f32);
    4·B·N²·d flops at the dtype's peak and B·N² exp2 at the card's exp2
    rate, whichever takes longer."""
    item = torch.finfo(dtype).bits // 8
    nbytes = 4 * b * n * d * item + 4 * b * n
    ops_s = max(4 * b * n * n * d / PEAK_FLOPS[dtype],
                b * n * n / exp2_per_s)
    return _bound(nbytes, ops_s)


def k2bwd_bound_ms(kernel: str, b: int, n: int, d: int, dtype,
                   exp2_per_s: float):
    """K2c ("dq") or K2d ("dkv"): q, k, v, g read once (input dtype), lse2
    and delta (f32) read once, dq or dk and dv written once; 6·B·N²·d (K2c)
    or 8·B·N²·d (K2d) flops at the dtype's peak and B·N² exp2 at the card's
    exp2 rate, whichever takes longer."""
    item = torch.finfo(dtype).bits // 8
    n_out, flops_per = (1, 6) if kernel == "dq" else (2, 8)
    nbytes = (4 + n_out) * b * n * d * item + 2 * 4 * b * n
    ops_s = max(flops_per * b * n * n * d / PEAK_FLOPS[dtype],
                b * n * n / exp2_per_s)
    return _bound(nbytes, ops_s)


def phase_main_path() -> int:
    from big_linear_algebra_tpu_torch.models import mnist_nn
    from big_linear_algebra_tpu_torch.ops import matmul as mm
    from big_linear_algebra_tpu_torch.data import synth
    from big_linear_algebra_tpu_torch.data.mnist import MnistDataset

    with tempfile.TemporaryDirectory(prefix="bla_smoke_") as tmp:
        os.environ["BLA_DATA_DIR"] = tmp
        out = io.StringIO()
        mm.launch_count = 0
        with contextlib.redirect_stdout(out):
            rc_init = mnist_nn.main(["init"])
            rc_run = mnist_nn.main(["run"])
        launches = mm.launch_count
        text = out.getvalue()
        if rc_init != 0 or rc_run != 0:
            fail(f"mnist_nn init/run exited {rc_init}/{rc_run}:\n{text}")
        if launches < 3:
            fail(f"K1 launched {launches} times during run, expected >= 3")
        got = re.search(r"Got (\d+) correct", text)
        if got is None:
            fail(f"no 'Got N correct' in the run output:\n{text}")
        gpu_correct = int(got.group(1))

        # the same eval from the same checkpoint: kernel logits on the card
        # and the plain path in f64 on the CPU
        params = mnist_nn.load_params_csv()
        _, test_csv = synth.ensure_mnist(tmp)
        data = MnistDataset.from_csv(test_csv)
        n = data.num_examples
        x, onehot, mask = (torch.from_numpy(v) for v in mnist_nn._make_batch(
            data.x, data.y, n, mnist_nn.CONFIG.layer_3))
        cpu = mnist_nn.MnistNN.from_params(params, device="cpu",
                                           dtype=torch.float64)
        cpu_correct, _ = mnist_nn.eval_batch(
            cpu, x.double(), onehot.double(), mask.double())
        cpu_correct = int(cpu_correct)
        gpu = mnist_nn.MnistNN.from_params(params, device="cuda")
        with torch.inference_mode():
            logits_gpu = gpu(x.cuda()).cpu().double()
            logits_cpu = cpu(x.double())
        del os.environ["BLA_DATA_DIR"]
    if not torch.isfinite(logits_gpu).all() or logits_gpu.shape != (n, 10):
        fail(f"logits not finite or of shape {tuple(logits_gpu.shape)}")
    diff = (logits_gpu - logits_cpu).abs().max().item()
    if gpu_correct != cpu_correct:
        fail(f"correct count {gpu_correct} on the card != {cpu_correct} "
             "on the CPU f64 plain path")
    if not diff <= LOGIT_ATOL:
        fail(f"max logit difference {diff} > {LOGIT_ATOL}")
    print(f"[4 main path] mnist_nn init+run on {n} images: K1 launches "
          f"{launches}; Got {gpu_correct} correct on the card, "
          f"{cpu_correct} on the CPU f64 plain path; max logit diff "
          f"{diff:.3e} (tol {LOGIT_ATOL})", flush=True)
    return launches


@contextlib.contextmanager
def _saved(module, name: str):
    """Within the block, each ``module.<name>(params, ...)`` call (a CSV
    save) also keeps a CPU copy of the parameters it writes: the trained
    values bit for bit, before the CSV's six decimals. A dict is kept as a
    dict, a tensor or a list of (w, b) pairs as a flat list."""
    real = getattr(module, name)
    saved = []

    def save(params, *args, **kwargs):
        if isinstance(params, dict):
            saved.append({k: v.detach().cpu().clone()
                          for k, v in params.items()})
        else:
            saved.append([t.detach().cpu().clone() for t in
                          ([params] if isinstance(params, torch.Tensor)
                           else _flat(params))])
        return real(params, *args, **kwargs)

    setattr(module, name, save)
    try:
        yield saved
    finally:
        setattr(module, name, real)


def _flat(params):
    """[(w, b), ...] → [w, b, ...]"""
    return [x for pair in params for x in pair]


def _zero_k1_counts(mm) -> None:
    mm.launch_count = 0
    for variant in mm.variant_launch_counts:
        mm.variant_launch_counts[variant] = 0


def _mnist_eval_f64(mnist_nn, params, data):
    """(correct, CE sum, logits) of ``params`` on ``data`` as one batch, in
    f64 on the CPU (the plain path)."""
    x, onehot, mask = (torch.from_numpy(v).double() for v in
                       mnist_nn._make_batch(data.x, data.y, data.num_examples,
                                            mnist_nn.CONFIG.layer_3))
    model = mnist_nn.MnistNN.from_params(params, device="cpu",
                                         dtype=torch.float64)
    correct, ce_sum = mnist_nn.eval_batch(model, x, onehot, mask)
    with torch.inference_mode():
        logits = model(x)
    return int(correct), float(ce_sum), logits


def phase_mnist_train() -> int:
    """mnist_nn's train path: ``init``, ``train 1`` (the synthesized
    8192-image set, batch 64, on the card), then ``run``, in a temporary
    data directory. Fails unless K1's launches over the epoch are, by
    variant, the steps times the train step's K1 GEMMs
    (``k1_train_gemms``); the epoch's losses are finite and its average
    below the untrained loss; ``train 1 --per-batch`` from the same initial
    CSVs gives bit-equal parameters; every trained leaf lies within
    ``TRAIN_RTOL_OF_UPDATE`` of its update from the same epoch in f64 on the
    CPU; and ``run``'s correct count equals the CPU f64 plain path's on the
    trained checkpoint. Then one epoch's host wall time and a
    ``torch.profiler`` trace of one epoch (device busy share, K1's share).
    Returns K1's launches in the epoch, and for phase 23 the initial and
    trained parameters and K1's launches by variant."""
    import collections
    import shutil

    import numpy as np
    from big_linear_algebra_tpu_torch.data import synth
    from big_linear_algebra_tpu_torch.data.mnist import MnistDataset
    from big_linear_algebra_tpu_torch.models import mnist_nn
    from big_linear_algebra_tpu_torch.ops import matmul as mm

    cfg = mnist_nn.CONFIG
    out = io.StringIO()
    with tempfile.TemporaryDirectory(prefix="bla_smoke_") as tmp:
        main_dir = os.path.join(tmp, "main")
        os.environ["BLA_DATA_DIR"] = main_dir
        with contextlib.redirect_stdout(out):
            rc_init = mnist_nn.main(["init"])
            train_csv, test_csv = synth.ensure_mnist(main_dir)
        if rc_init != 0:
            fail(f"mnist_nn init exited {rc_init}:\n{out.getvalue()}")
        initial = mnist_nn.load_params_csv()
        per_batch_dir = os.path.join(tmp, "per_batch")
        shutil.copytree(main_dir, per_batch_dir)
        data = MnistDataset.from_csv(train_csv)
        n = data.num_examples
        steps = -(-n // cfg.batch_size)
        per_step = collections.Counter(v for v, *_ in k1_train_gemms())
        want = {v: steps * per_step[v] for v in ("nn", "nt", "tn")}
        _, ce0, _ = _mnist_eval_f64(mnist_nn, initial, data)
        untrained = ce0 / n

        runs = {}
        for mode, where in (("resident", main_dir),
                            ("--per-batch", per_batch_dir)):
            os.environ["BLA_DATA_DIR"] = where
            args = ["train", "1"] + ([mode] if mode != "resident" else [])
            out = io.StringIO()
            _zero_k1_counts(mm)
            with _saved(mnist_nn, "save_params_csv") as saved, \
                    contextlib.redirect_stdout(out):
                rc = mnist_nn.main(args)
            counts = dict(mm.variant_launch_counts)
            text = out.getvalue()
            if rc != 0 or len(saved) != 1:
                fail(f"mnist_nn {' '.join(args)} exited {rc}:\n{text}")
            if counts != want or mm.launch_count != sum(want.values()):
                fail(f"mnist_nn {' '.join(args)}: K1 launched {counts} "
                     f"({mm.launch_count} in all), expected {want}: {steps} "
                     f"steps x {dict(per_step)}")
            runs[mode] = (saved[0], _epoch_line(text, 0), counts)
        trained, line, counts = runs["resident"]
        loss = float(line["avg_loss"])
        if not (math.isfinite(loss) and loss < untrained):
            fail(f"train 1: avg_loss {loss} not finite or not below the "
                 f"untrained loss {untrained}")
        for k, v in trained.items():
            if not (torch.isfinite(v).all() and torch.equal(
                    v.view(torch.int32),
                    runs["--per-batch"][0][k].view(torch.int32))):
                fail(f"train 1 --per-batch: {k} not bit-equal to the "
                     "resident epoch's (or not finite)")

        # the same epoch in f64 on the CPU: same CSVs, same permutation
        model64 = mnist_nn.MnistNN.from_params(initial, device="cpu",
                                               dtype=torch.float64)
        perm = mnist_nn.epoch_permutation(np.random.default_rng(cfg.seed), n,
                                          cfg.batch_size)
        mnist_nn.epoch_step_resident(
            model64, torch.from_numpy(data.x).double(),
            torch.from_numpy(data.y), torch.from_numpy(perm), cfg)
        ratios, of_max = {}, {}
        for k, ref in model64.params().items():
            ref = ref.detach()
            err = (trained[k].double() - ref).abs().max().item()
            update = (ref - initial[k].double()).abs().max().item()
            ratios[k] = err / update
            of_max[k] = err / ref.abs().max().item()
        if not max(ratios.values()) <= TRAIN_RTOL_OF_UPDATE:
            fail(f"train 1 on the card against the f64 epoch on the CPU, "
                 f"max|err| / max|update| per leaf {ratios} > "
                 f"{TRAIN_RTOL_OF_UPDATE}")

        os.environ["BLA_DATA_DIR"] = main_dir
        out = io.StringIO()
        _zero_k1_counts(mm)
        with contextlib.redirect_stdout(out):
            rc_run = mnist_nn.main(["run"])
        run_launches = mm.launch_count
        got = re.search(r"Got (\d+) correct", out.getvalue())
        if rc_run != 0 or got is None:
            fail(f"mnist_nn run after train exited {rc_run}:\n"
                 f"{out.getvalue()}")
        test = MnistDataset.from_csv(test_csv)
        checkpoint = mnist_nn.load_params_csv()
        cpu_correct, _, logits_cpu = _mnist_eval_f64(mnist_nn, checkpoint,
                                                     test)
        gpu = mnist_nn.MnistNN.from_params(checkpoint, device="cuda")
        with torch.inference_mode():
            logits_gpu = gpu((torch.from_numpy(test.x) / 255.0).cuda())
        diff = (logits_gpu.cpu().double() - logits_cpu).abs().max().item()
        if int(got.group(1)) != cpu_correct or not diff <= LOGIT_ATOL:
            fail(f"run after train: {got.group(1)} correct on the card, "
                 f"{cpu_correct} on the CPU f64 plain path; max logit diff "
                 f"{diff} (tol {LOGIT_ATOL})")

        # one epoch timed, then one traced, on the trained parameters
        model = mnist_nn.MnistNN.from_params(checkpoint, device="cuda")
        x_dev = torch.from_numpy(data.x).cuda()
        y_dev = torch.from_numpy(data.y).cuda()
        perm_dev = torch.from_numpy(perm).cuda()
        host, busy, summary, per_name = _host_and_trace(
            lambda: mnist_nn.epoch_step_resident(model, x_dev, y_dev,
                                                 perm_dev, cfg,
                                                 graphed=False),
            n_traced=1, warmup=1, timed=2)
        k1_ms = sum(us for name, us in per_name.items()
                    if "mm_kernel" in name) / 1e3
        del os.environ["BLA_DATA_DIR"]
    if not busy > 0:
        fail("the trace of a train epoch shows no device time")
    print(f"[22 mnist_nn train] init + train 1 + run, {n} synthesized "
          f"images, batch {cfg.batch_size}, {steps} steps: K1 launches "
          f"{counts} ({sum(counts.values())}; expected {steps} x "
          f"{dict(per_step)} from the step's GEMMs and _SMALL_FLOPS), the "
          f"same with --per-batch; avg_loss {loss:.5f} (untrained "
          f"{untrained:.5f}, CPU f64), avg_accuracy {line['avg_accuracy']}, "
          f"{float(line['images_per_sec']):.1f} images/s (epoch_seconds "
          f"{line['epoch_seconds']}; --per-batch "
          f"{float(runs['--per-batch'][1]['images_per_sec']):.1f} images/s);"
          f" --per-batch bit-equal; against the CPU f64 epoch, max|err| / "
          f"max|update| per leaf "
          + ", ".join(f"{k} {r:.3e}" for k, r in ratios.items())
          + f" (tol {TRAIN_RTOL_OF_UPDATE}), max|err| / max|ref| "
          + ", ".join(f"{k} {r:.3e}" for k, r in of_max.items())
          + f"; run: K1 launches {run_launches}, Got {got.group(1)} correct "
          f"on the card and on the CPU f64 plain path, max logit diff "
          f"{diff:.3e}", flush=True)
    print(f"[22 mnist_nn train profile] one eager resident epoch on the "
          f"card (phase 27 times the graphed one) "
          f"({steps} steps): host wall {host:.3f} ms (synchronised, no "
          f"profiler) = {host / steps * 1e3:.2f} us per step; device busy "
          f"{busy:.3f} ms = {busy / steps * 1e3:.2f} us per step = "
          f"{busy / host:.1%} of the host time; K1 {k1_ms:.3f} ms = "
          f"{k1_ms / busy:.1%} of the device time; trace of one epoch "
          f"(trace_summary.py):\n    " + summary.replace("\n", "\n    "),
          flush=True)
    return sum(counts.values()), {"initial": initial, "trained": trained,
                                  "counts": counts}


def _k2_inputs(b, n, d, dtype, gen):
    """q, k, v ~ N(0, 1) made on the CPU from ``gen``, on the card."""
    return tuple(torch.randn(b, n, d, generator=gen).to("cuda", dtype)
                 for _ in range(3))


def phase_k2_vs_plain() -> float:
    """Every K2 case against the plain version; returns the worst abs
    error of o over all cases."""
    from big_linear_algebra_tpu_torch.nn import attention as at

    gen = torch.Generator().manual_seed(3)
    cases = [(b, n, d) for d in (16, 64) for b, n in K2_SHAPES]
    cases += [(2, 300, d) for d in at._KERNEL_DIMS if d not in (16, 64)]
    # bf16 views one element past a 16-byte boundary: the wrapper copies
    # them for the tensor-core kernel
    odd = [(torch.bfloat16, b, n, d, True) for b, n, d in K2_ODD_VIEWS]
    worst_abs = 0.0
    worst = {"f32 o err/tol": 0.0, "bf16 o err/max|ref|": 0.0, "lse": 0.0}
    bad = []
    n_cases = 0
    plain_cases = [(dtype, b, n, d, False)
                   for dtype in (torch.float32, torch.bfloat16)
                   for b, n, d in cases + [K2_ADM]]
    for dtype, b, n, d, at_odd in plain_cases + odd:
        q, k, v = _k2_inputs(b, n, d, dtype, gen)
        if at_odd:
            q, k, v = (torch.cat([x.new_zeros(1), x.flatten()])[1:]
                       .view(b, n, d) for x in (q, k, v))
            if any(x.data_ptr() % 16 == 0 for x in (q, k, v)):
                fail("a view one element past an aligned buffer is "
                     "aligned")
        o, lse = at._kernel_flash(q, k, v)
        want_o, want_lse = at._plain_flash(q, k, v)
        torch.cuda.synchronize()
        case = (f"{str(dtype)[6:]} B={b} N={n} d={d}"
                + (" (views at +1 element)" if at_odd else ""))
        if o.shape != want_o.shape or lse.shape != (b, n) \
                or lse.dtype != torch.float32:
            bad.append(f"{case}: shapes o {tuple(o.shape)} lse "
                       f"{tuple(lse.shape)} {lse.dtype}")
            continue
        diff = (o.float() - want_o.float()).abs()
        worst_abs = max(worst_abs, diff.max().item())
        lse_err = (lse - want_lse).abs().max().item()
        worst["lse"] = max(worst["lse"], lse_err)
        if not lse_err <= K2_LSE_ATOL:
            bad.append(f"{case}: lse max abs err {lse_err} > "
                       f"{K2_LSE_ATOL}")
        if dtype == torch.float32:
            ratio = (diff / (K2_F32_ATOL + K2_F32_RTOL
                             * want_o.abs())).max().item()
            worst["f32 o err/tol"] = max(worst["f32 o err/tol"], ratio)
            if not ratio <= 1.0:
                bad.append(f"{case}: o err exceeds atol {K2_F32_ATOL} + "
                           f"rtol {K2_F32_RTOL}*|ref| by {ratio}x")
        else:
            rel = diff.max().item() / want_o.float().abs().max().item()
            worst["bf16 o err/max|ref|"] = max(
                worst["bf16 o err/max|ref|"], rel)
            if not rel <= K2_BF16_RTOL_OF_MAX:
                bad.append(f"{case}: o err / max|ref| {rel} > "
                           f"{K2_BF16_RTOL_OF_MAX}")
        n_cases += 1
    if bad:
        fail(f"{len(bad)} K2 cases disagree with the plain version:\n  "
             + "\n  ".join(bad))
    print(f"[5 K2 vs plain] {n_cases} cases pass (f32/bf16 x d 16, 64 x "
          f"(B, N) {K2_SHAPES}, and d "
          f"{[d for _, _, d in cases[2 * len(K2_SHAPES):]]} at "
          f"(2, 300), and ADM's {K2_ADM}; bf16 q, k, v as views one element past an aligned "
          f"buffer at (B, N, d) {K2_ODD_VIEWS}): worst f32 o err/(atol "
          f"{K2_F32_ATOL} + rtol {K2_F32_RTOL}*|ref|) "
          f"{worst['f32 o err/tol']:.3f}, worst bf16 o "
          f"err/max|ref| {worst['bf16 o err/max|ref|']:.3e} (tol "
          f"{K2_BF16_RTOL_OF_MAX}), worst lse abs err {worst['lse']:.3e} "
          f"(tol {K2_LSE_ATOL}), worst o abs err {worst_abs:.3e}",
          flush=True)
    return worst_abs


def phase_k2_bitequal() -> None:
    """Two bf16 runs of K2 on the same operands must be bit-equal at the
    sampler's (1, 1024, 16) and at the train step's (16, 1024, 16)."""
    from big_linear_algebra_tpu_torch.nn import attention as at

    gen = torch.Generator().manual_seed(10)
    parts = []
    for b, n, d in (K2_MAIN, K2_TRAIN):
        q, k, v = _k2_inputs(b, n, d, torch.bfloat16, gen)
        o1, l1 = at._kernel_flash(q, k, v)
        o2, l2 = at._kernel_flash(q, k, v)
        torch.cuda.synchronize()
        if not (torch.equal(o1.view(torch.int16), o2.view(torch.int16))
                and torch.equal(l1.view(torch.int32), l2.view(torch.int32))):
            fail(f"two bf16 K2 runs at (B, N, d) = {(b, n, d)} differ")
        parts.append(str((b, n, d)))
    print(f"[5 K2 bit-equal] two bf16 runs bit-equal (o and lse) at "
          + ", ".join(parts), flush=True)


def phase_k2_build_info() -> None:
    """K2's bf16 tensor-core kernels (d 16..128): registers, shared memory
    and spills from the build's ``-Xptxas -v``, blocks per SM from the
    occupancy API, and the HMMA/HGMMA instructions in their SASS. Fails on
    a spill or on a kernel without tensor-core instructions."""
    stats = _kernel_stats("flash_attn", re.compile(r"flash_fwd_tcILi(\d+)E"))
    blocks_per_sm = _int_fn("flash_attn", "bla_flash_fwd_tc_blocks_per_sm", 1)
    bad, parts = [], []
    for d in (16, 32, 64, 128):
        st = stats.get((str(d),), {})
        st["blocks"] = blocks_per_sm(d)
        why = _check_stats(f"flash_fwd_tc<{d}>", st, True)
        if why:
            bad.append(why)
            continue
        parts.append(f"d={d} {st['regs']} regs, {st['smem']} B smem, spill "
                     f"{st['spill']} B, {st['blocks']} blocks/SM, "
                     f"{st['mma']} HMMA")
    if bad:
        fail("tensor-core K2 (spill, no HMMA or no block fits):\n  "
             + "\n  ".join(bad))
    print("[5 K2 build] bf16 tensor-core kernels (128 threads, 64 q rows a "
          "block; -Xptxas -v, cudaOccupancy, cuobjdump -sass): "
          + "; ".join(parts), flush=True)


def phase_k2_timing(exp2_per_s: float) -> dict:
    """bf16 at the U-Net's flash shapes (sampling, train step), at (4,
    4096, 64) and at ADM's train step: the kernel, the plain version and
    SDPA (on (B, 1, N, d), one head, so that PyTorch may pick its fused
    backends), in turns within this one process; the lower of each pair is kept. Returns the main
    shape's numbers."""
    import torch.nn.functional as F

    from big_linear_algebra_tpu_torch.nn import attention as at

    gen = torch.Generator().manual_seed(4)
    main = {}
    for b, n, d in K2_TIMED:
        q, k, v = _k2_inputs(b, n, d, torch.bfloat16, gen)
        q4, k4, v4 = (x[:, None] for x in (q, k, v))
        fns = {"kernel": lambda: at._kernel_flash(q, k, v),
               "plain": lambda: at._plain_flash(q, k, v),
               "sdpa": lambda: F.scaled_dot_product_attention(q4, k4, v4)}
        names = tuple(fns)
        runs = {name: [] for name in names}
        for name in names + names[::-1]:
            runs[name].append(_time_ms(fns[name]))
        ms = {name: min(dv for dv, _ in runs[name]) for name in names}
        host = {name: min(h for _, h in runs[name]) for name in names}
        bound, bound_by = k2_bound_ms(b, n, d, torch.bfloat16, exp2_per_s)
        tflops = 4 * b * n * n * d / (ms["kernel"] * 1e-3) / 1e12
        grid = f"grid {(n + 63) // 64}x{b}"
        print(f"[5 K2 timing] bf16 B={b} N={n} d={d}: device kernel "
              f"{ms['kernel'] * 1e3:.2f} us ({tflops:.2f} TFLOP/s, {grid}), "
              f"plain {ms['plain'] * 1e3:.2f} us, SDPA "
              f"{ms['sdpa'] * 1e3:.2f} us; bound {bound * 1e3:.3f} us "
              f"({bound_by}; {b * n * n} exp2, {4 * b * n * n * d} flops) | "
              f"host per call: kernel {host['kernel'] * 1e3:.2f} us, plain "
              f"{host['plain'] * 1e3:.2f} us, SDPA "
              f"{host['sdpa'] * 1e3:.2f} us", flush=True)
        if (b, n, d) == K2_MAIN:
            main = dict(ms, bound=bound, bound_by=bound_by)
    return main


def phase_unet_main_path(tmp: str) -> int:
    """``cifar_unet init`` + ``run 1 --image-size=64`` in ``tmp``; returns
    K2's launches during ``run``."""
    from big_linear_algebra_tpu_torch.data import bmp
    from big_linear_algebra_tpu_torch.models import cifar_unet as cu
    from big_linear_algebra_tpu_torch.nn import attention as at
    from big_linear_algebra_tpu_torch.ops import matmul as mm

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc_init = cu.main(["init"])
    init_s = time.perf_counter() - t0
    at.launch_count = 0
    mm.launch_count = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc_run = cu.main(["run", "1", "--image-size=64", "--sample-seed=0"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches, k1_launches = at.launch_count, mm.launch_count
    if rc_init != 0 or rc_run != 0:
        fail(f"cifar_unet init/run exited {rc_init}/{rc_run}:\n"
             f"{out.getvalue()}")
    steps = cu.CONFIG.timesteps
    if launches < 4 * steps:
        fail(f"K2 launched {launches} times during run, expected >= "
             f"{4 * steps} (4 flash sites x {steps} steps)")
    path = os.path.join(tmp, "cifar_unet", "samples", "sample_0.bmp")
    planes = bmp.read_bmp(path)
    if any(p.shape != (64, 64) for p in planes):
        fail(f"{path}: planes of shape {[p.shape for p in planes]}, "
             "expected 64x64")
    lo = min(int(p.min()) for p in planes)
    hi = max(int(p.max()) for p in planes)
    if lo == hi:
        fail(f"{path}: constant image (every byte {lo})")
    print(f"[6 unet main path] cifar_unet init {init_s:.2f} s; run 1 "
          f"--image-size=64 (1000 steps, full width, bf16 compute) "
          f"{run_s:.2f} s wall: K2 launches {launches} (K1 {k1_launches}); "
          f"samples/sample_0.bmp 64x64, bytes {lo}..{hi}", flush=True)
    return launches


def phase_unet_oracle() -> None:
    """One full-width 64x64 forward from the checkpoint ``run`` used: f32
    through the kernel against f64 (dense attention), bf16 reported; then
    one bf16 forward's time."""
    import dataclasses

    import torch.nn.functional as F

    from big_linear_algebra_tpu_torch.models import cifar_unet as cu
    from big_linear_algebra_tpu_torch.nn import attention as at

    cfg = dataclasses.replace(cu.CONFIG, image_size=64)
    t0 = time.perf_counter()
    params = cu.load_params_csv(cfg)
    load_s = time.perf_counter() - t0
    x = torch.randn(1, 3, 64, 64, generator=torch.Generator().manual_seed(0))
    x, t = x.cuda(), torch.tensor([500], device="cuda")
    outs = {}
    with torch.inference_mode():
        for dt in ("float64", "float32", "bfloat16"):
            c = dataclasses.replace(cfg, compute_dtype=dt)
            p = cu.tree_map(lambda a: a.to("cuda", getattr(torch, dt)),
                             params)
            at.launch_count = 0
            outs[dt] = cu.forward(p, x, t, c).double()
            torch.cuda.synchronize()
            if at.launch_count != (0 if dt == "float64" else 4):
                fail(f"{dt} forward launched K2 {at.launch_count} times")
        ref = outs["float64"]
        if ref.shape != (1, 3, 64, 64) or not all(
                torch.isfinite(o).all() for o in outs.values()):
            fail(f"U-Net outputs not finite or of shape {tuple(ref.shape)}")
        # the kernel's own share: the same forwards with the plain version
        # at the four flash sites
        kernel = at.flash_attention
        at.flash_attention = lambda q, k, v: at._plain_flash(q, k, v)[0]
        try:
            for dt in ("float32", "bfloat16"):
                c = dataclasses.replace(cfg, compute_dtype=dt)
                p = cu.tree_map(lambda a: a.to("cuda", getattr(torch, dt)),
                                 params)
                outs[f"{dt} plain"] = cu.forward(p, x, t, c).double()
        finally:
            at.flash_attention = kernel
        scale = ref.abs().max().item()
        err = {dt: (out - ref).abs().max().item() / scale
               for dt, out in outs.items() if dt != "float64"}
        share = {dt: (outs[dt] - outs[f"{dt} plain"]).abs().max().item()
                 / scale for dt in ("float32", "bfloat16")}
        if not err["float32"] <= UNET_F32_RTOL_OF_MAX:
            fail(f"f32 U-Net forward err / max|f64 ref| {err['float32']} > "
                 f"{UNET_F32_RTOL_OF_MAX}")
        print(f"[7 unet oracle] full-width 64x64 forward, t=500 (params "
              f"loaded in {load_s:.2f} s): f32 through K2 vs f64 (dense "
              f"attention) err/max|ref| {err['float32']:.3e} (tol "
              f"{UNET_F32_RTOL_OF_MAX}); reported, no bound, all /max|ref|: "
              f"f32 with the plain K2 vs f64 {err['float32 plain']:.3e}, "
              f"f32 K2 vs f32 plain {share['float32']:.3e}; bf16 K2 vs f64 "
              f"{err['bfloat16']:.3e}, bf16 plain vs f64 "
              f"{err['bfloat16 plain']:.3e}, bf16 K2 vs bf16 plain "
              f"{share['bfloat16']:.3e}; max|ref| {scale:.3f}", flush=True)
    phase_unet_step(cu, dataclasses.replace(cfg, compute_dtype="bfloat16"),
                    params, x)


def _host_and_trace(fn, n_traced: int, warmup: int = 3, timed: int = 10):
    """(host ms per call, device busy ms per call, trace summary, {device
    entry name: µs per call}) of ``fn``: host wall time per call over
    ``timed`` calls ending in a synchronise, without the profiler; then a
    ``torch.profiler`` trace of ``n_traced`` calls reduced by
    ``trace_summary.py``."""
    import trace_summary

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / timed
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n_traced):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="bla_trace_") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    summary = trace_summary.summarize(trace, top=8)
    busy_ms = float(re.search(r"device busy ([0-9.]+) ms",
                              summary).group(1)) / n_traced
    per_name = {name: us / n_traced for name, us in
                trace_summary.device_by_name(trace).items()}
    return host_ms, busy_ms, summary, per_name


def phase_unet_step(cu, cfg, params, x, n_fwd=5) -> None:
    """One bf16 forward (a sampling step's network): host wall time per
    forward without the profiler, then a ``torch.profiler`` trace of
    ``n_fwd`` forwards reduced by ``trace_summary.py`` (device busy per
    forward and the largest device entries)."""
    p = cu.tree_map(lambda a: a.to("cuda", torch.bfloat16), params)
    tb = torch.tensor([500], dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        host_ms, busy_ms, summary, _ = _host_and_trace(
            lambda: cu.forward(p, x, tb, cfg), n_fwd)
    print(f"[7 unet step] one bf16 full-width 64x64 forward (a sampling "
          f"step's network): host wall {host_ms:.3f} ms per forward "
          f"(synchronised, no profiler); device busy {busy_ms:.3f} ms per "
          f"forward = {busy_ms / host_ms:.1%} of that; trace of {n_fwd} "
          f"forwards (trace_summary.py):\n    "
          + summary.replace("\n", "\n    "), flush=True)


def _k2bwd_inputs(b, n, d, dtype, gen):
    """(q, k, v, o, lse, g) as the backward gets them on the main path: q,
    k, v and the cotangent g ~ N(0, 1) made on the CPU from ``gen``, on the
    card, and K2's o and lse of them."""
    from big_linear_algebra_tpu_torch.nn import attention as at

    q, k, v, g = (torch.randn(b, n, d, generator=gen).to("cuda", dtype)
                  for _ in range(4))
    o, lse = at._kernel_flash(q, k, v)
    return q, k, v, o, lse, g


def phase_k2bwd_vs_plain() -> dict:
    """Every K2c/K2d case against ``_plain_flash_bwd``; returns the worst
    abs error per kernel ({"dq": .., "dkv": ..}) over all cases."""
    from big_linear_algebra_tpu_torch.nn import attention as at

    gen = torch.Generator().manual_seed(5)
    cases = [(b, n, d) for d in (16, 64) for b, n in K2BWD_SHAPES]
    cases += [(2, 300, d) for d in at._KERNEL_DIMS if d not in (16, 64)]
    worst_abs = {"dq": 0.0, "dkv": 0.0}
    # f32: err / (atol + rtol*|ref|); bf16: err / max|ref|
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    bad = []
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for b, n, d in cases + [K2_ADM]:
            args = _k2bwd_inputs(b, n, d, dtype, gen)
            got = at._kernel_flash_bwd(*args)
            want = at._plain_flash_bwd(*args)
            torch.cuda.synchronize()
            case = f"{str(dtype)[6:]} B={b} N={n} d={d}"
            for name, x, y in zip(("dq", "dk", "dv"), got, want):
                if x.shape != y.shape or x.dtype != y.dtype:
                    bad.append(f"{case} {name}: {tuple(x.shape)} {x.dtype}, "
                               f"expected {tuple(y.shape)} {y.dtype}")
                    continue
                diff = (x.float() - y.float()).abs()
                kernel = "dq" if name == "dq" else "dkv"
                worst_abs[kernel] = max(worst_abs[kernel], diff.max().item())
                if dtype == torch.float32:
                    ratio = (diff / (K2BWD_F32_ATOL + K2BWD_F32_RTOL
                                     * y.abs())).max().item()
                    worst[dtype] = max(worst[dtype], ratio)
                    if not ratio <= 1.0:
                        bad.append(f"{case} {name}: err exceeds atol "
                                   f"{K2BWD_F32_ATOL} + rtol {K2BWD_F32_RTOL}"
                                   f"*|ref| by {ratio}x")
                else:
                    rel = diff.max().item() / y.float().abs().max().item()
                    worst[dtype] = max(worst[dtype], rel)
                    if not rel <= K2BWD_BF16_RTOL_OF_MAX:
                        bad.append(f"{case} {name}: err / max|ref| {rel} > "
                                   f"{K2BWD_BF16_RTOL_OF_MAX}")
            n_cases += 1
    if bad:
        fail(f"{len(bad)} K2c/K2d outputs disagree with the plain version:"
             "\n  " + "\n  ".join(bad))
    print(f"[8 K2c/K2d vs plain] {n_cases} cases pass (f32/bf16 x d 16, 64 "
          f"x (B, N) {K2BWD_SHAPES}, and d "
          f"{[d for _, _, d in cases[2 * len(K2BWD_SHAPES):]]} at "
          f"(2, 300), and ADM's {K2_ADM}); dq, dk, dv each: worst f32 err/(atol {K2BWD_F32_ATOL}"
          f" + rtol {K2BWD_F32_RTOL}*|ref|) {worst[torch.float32]:.3f}, "
          f"worst bf16 err/max|ref| {worst[torch.bfloat16]:.3e} (tol "
          f"{K2BWD_BF16_RTOL_OF_MAX}); worst abs err dq "
          f"{worst_abs['dq']:.3e}, dk/dv {worst_abs['dkv']:.3e}", flush=True)
    return worst_abs


def _kernel_stats(lib: str, name_re) -> dict:
    """Per kernel of ``csrc/<lib>.cu`` whose mangled name matches
    ``name_re`` (keyed by the match's groups): registers, shared memory and
    spills from the build's ``-Xptxas -v`` (kept by ``cuda_utils``), the
    HMMA/HGMMA instructions in its SASS (``cuobjdump -sass``), and ptxas's
    lines under ``"ptxas"``."""
    from big_linear_algebra_tpu_torch.ops import cuda_utils

    stats, cur = {}, None
    for line in cuda_utils.build_log(lib).splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\S+?)'?(?: for|$)", line)
        if m:
            k = name_re.search(m.group(1))
            cur = k.groups() if k else None
            if cur:
                stats.setdefault(cur, {"ptxas": []})
            continue
        if cur is None:
            continue
        stats[cur]["ptxas"].append(line.strip())
        if (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", line)):
            stats[cur]["spill"] = int(m.group(1)) + int(m.group(2))
        if (m := re.search(r"Used (\d+) registers", line)):
            stats[cur]["regs"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            stats[cur]["smem"] = int(sm.group(1)) if sm else 0
    cuobjdump = os.path.join(os.path.dirname(cuda_utils.nvcc()), "cuobjdump")
    if not os.path.isfile(cuobjdump):
        fail(f"{cuobjdump} not found: the SASS cannot be checked for "
             "tensor-core instructions")
    sass = subprocess.run(
        [cuobjdump, "-sass", str(cuda_utils.library_path(lib))],
        capture_output=True, text=True, timeout=300)
    if sass.returncode != 0:
        fail(f"cuobjdump -sass failed: {sass.stderr.strip()}")
    for func in re.split(r"\n\s*Function : ", sass.stdout)[1:]:
        k = name_re.search(func.split("\n", 1)[0])
        if k:
            stats.setdefault(k.groups(), {"ptxas": []})["mma"] = (
                len(re.findall(r"\bH(?:G)?MMA\b", func)))
    return stats


def _int_fn(lib: str, entry: str, n_args: int):
    """``entry`` of ``csrc/<lib>.cu``, a C function of ``n_args`` ints that
    returns an int."""
    from big_linear_algebra_tpu_torch.ops import cuda_utils

    fn = getattr(cuda_utils.load_library(lib), entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * n_args
    return fn


def _check_stats(what: str, st: dict, need_mma: bool) -> str:
    """"" if the record is complete, without spills, with a block that fits
    (and with tensor-core instructions if ``need_mma``); else why not."""
    need = {"spill", "regs", "smem", "blocks"} | ({"mma"} if need_mma
                                                  else set())
    if not need <= set(st):
        return f"{what}: incomplete build/SASS record {st}"
    if st["spill"] or st["blocks"] < 1 or (need_mma and not st["mma"]):
        return f"{what}: {st}"
    return ""


def phase_k2bwd_build_info() -> None:
    """The tensor-core kernels of ``flash_attn_bwd.cu`` (bf16, d 16..128):
    registers, shared memory and spills from the build's ``-Xptxas -v``,
    blocks per SM from the occupancy API, and the HMMA/HGMMA instructions
    in their SASS. Fails on a spill or on a kernel without tensor-core
    instructions."""
    stats = _kernel_stats("flash_attn_bwd",
                          re.compile(r"flash_bwd_(dq|dkv)_tcILi(\d+)E"))
    blocks_per_sm = _int_fn("flash_attn_bwd",
                            "bla_flash_bwd_tc_blocks_per_sm", 2)
    bad, parts = [], []
    for kern in ("dq", "dkv"):
        for d in (16, 32, 64, 128):
            st = stats.get((kern, str(d)), {})
            st["blocks"] = blocks_per_sm(d, int(kern == "dkv"))
            why = _check_stats(f"flash_bwd_{kern}_tc<{d}>", st, True)
            if why:
                bad.append(why)
                continue
            parts.append(f"{'K2c' if kern == 'dq' else 'K2d'} d={d} "
                         f"{st['regs']} regs, {st['smem']} B smem, spill "
                         f"{st['spill']} B, {st['blocks']} blocks/SM, "
                         f"{st['mma']} HMMA")
    if bad:
        fail("tensor-core K2c/K2d (spill, no HMMA or no block fits):\n  "
             + "\n  ".join(bad))
    print("[8 K2c/K2d build] bf16 tensor-core kernels (128 threads, 64 "
          "output rows a block; -Xptxas -v, cudaOccupancy, cuobjdump -sass):"
          " " + "; ".join(parts), flush=True)


def phase_k2bwd_bitequal() -> None:
    """Two bf16 runs of K2c and of K2d on the same operands at the train
    step's shape must be bit-equal (each output row has one owner warp;
    no atomics)."""
    from big_linear_algebra_tpu_torch.nn import attention as at

    gen = torch.Generator().manual_seed(8)
    ops = at._kernel_bwd_operands(*_k2bwd_inputs(*K2BWD_MAIN, torch.bfloat16,
                                                 gen))
    first = (at._kernel_bwd_dq(*ops), *at._kernel_bwd_dkv(*ops))
    second = (at._kernel_bwd_dq(*ops), *at._kernel_bwd_dkv(*ops))
    torch.cuda.synchronize()
    differ = [name for name, a, b in zip(("dq", "dk", "dv"), first, second)
              if not torch.equal(a.view(torch.int16), b.view(torch.int16))]
    if differ:
        fail(f"two bf16 K2c/K2d runs at {K2BWD_MAIN} differ in {differ}")
    print(f"[8 K2c/K2d bit-equal] two bf16 runs at (B, N, d) = {K2BWD_MAIN}:"
          " dq, dk, dv bit-equal", flush=True)


def phase_k2bwd_timing(exp2_per_s: float) -> dict:
    """bf16 at the train step's flash shape, at (4, 4096, 64) and at ADM's
    train step: K2c and K2d each on prepared operands, the wrapper (prep +
    both kernels), the plain backward and SDPA's backward
    (``torch.autograd.grad`` through ``F.scaled_dot_product_attention`` on
    (B, 1, N, d)), in turns within this one process; the lower of each pair
    is kept. Returns the main shape's numbers."""
    import torch.nn.functional as F

    from big_linear_algebra_tpu_torch.nn import attention as at

    gen = torch.Generator().manual_seed(6)
    names = ("dq", "dkv", "wrapper", "plain", "sdpa")
    main = {}
    for b, n, d in K2BWD_TIMED:
        args = _k2bwd_inputs(b, n, d, torch.bfloat16, gen)
        ops = at._kernel_bwd_operands(*args)
        q4, k4, v4 = (x[:, None].detach().requires_grad_()
                      for x in args[:3])
        o4 = F.scaled_dot_product_attention(q4, k4, v4)
        g4 = args[5][:, None]
        fns = {"dq": lambda: at._kernel_bwd_dq(*ops),
               "dkv": lambda: at._kernel_bwd_dkv(*ops),
               "wrapper": lambda: at._kernel_flash_bwd(*args),
               "plain": lambda: at._plain_flash_bwd(*args),
               "sdpa": lambda: torch.autograd.grad(o4, (q4, k4, v4), g4,
                                                   retain_graph=True)}
        runs = {name: [] for name in names}
        for name in names + names[::-1]:
            runs[name].append(_time_ms(fns[name]))
        ms = {name: min(dv for dv, _ in runs[name]) for name in names}
        host = {name: min(h for _, h in runs[name]) for name in names}
        bounds = {kern: k2bwd_bound_ms(kern, b, n, d, torch.bfloat16,
                                       exp2_per_s) for kern in ("dq", "dkv")}
        print(f"[8 K2c/K2d timing] bf16 B={b} N={n} d={d}: device K2c "
              f"{ms['dq'] * 1e3:.2f} us (bound {bounds['dq'][0] * 1e3:.3f} "
              f"us, {bounds['dq'][1]}), K2d {ms['dkv'] * 1e3:.2f} us (bound "
              f"{bounds['dkv'][0] * 1e3:.3f} us, {bounds['dkv'][1]}); "
              f"wrapper (prep + K2c + K2d) {ms['wrapper'] * 1e3:.2f} us, "
              f"plain backward {ms['plain'] * 1e3:.2f} us, SDPA backward "
              f"{ms['sdpa'] * 1e3:.2f} us ({b * n * n} exp2, "
              f"{6 * b * n * n * d} + {8 * b * n * n * d} flops) | host per "
              f"call: wrapper {host['wrapper'] * 1e3:.2f} us, plain "
              f"{host['plain'] * 1e3:.2f} us, SDPA {host['sdpa'] * 1e3:.2f} "
              f"us", flush=True)
        if (b, n, d) == K2BWD_MAIN:
            main = dict(ms, bound=bounds)
    return main


def _epoch_line(text: str, epoch: int) -> dict:
    """The ``epoch: <epoch>`` metrics line of ``train`` as {key: value}."""
    for line in text.splitlines():
        if line.startswith(f"epoch: {epoch}\t"):
            return dict(kv.split(": ", 1) for kv in line.split("\t"))
    fail(f"no 'epoch: {epoch}' line in the train output:\n{text}")


def phase_unet_train(tmp: str) -> dict:
    """``ensure_cifar``, ``cifar_unet init``, ``train 1 --image-size=64
    --max-steps=50`` and a resumed ``train 1 ... --max-steps=10`` in
    ``tmp``; returns the launches of K2, K2c and K2d during the first
    ``train``. Each step's loss is read by wrapping ``train_step``."""
    from big_linear_algebra_tpu_torch.ckpt import pytree
    from big_linear_algebra_tpu_torch.data import synth
    from big_linear_algebra_tpu_torch.models import cifar_unet as cu
    from big_linear_algebra_tpu_torch.nn import attention as at
    from big_linear_algebra_tpu_torch.ops import matmul as mm

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        n_ex = sum(os.path.getsize(p) for p in synth.ensure_cifar(tmp)) // 3073
        synth_s = time.perf_counter() - t0
        rc_init = cu.main(["init"])
    init_s = time.perf_counter() - t0 - synth_s
    losses = []
    real_step = cu.train_step

    def step(*a, **kw):
        params, opt_state, loss = real_step(*a, **kw)
        losses.append(loss)
        return params, opt_state, loss

    cu.train_step = step
    try:
        first = io.StringIO()
        at.launch_count = at.bwd_dq_launch_count = 0
        at.bwd_dkv_launch_count = mm.launch_count = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(first):
            rc_train = cu.main(["train", "1", "--image-size=64",
                                f"--max-steps={TRAIN_STEPS}"])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = {"K2": at.launch_count, "K2c": at.bwd_dq_launch_count,
                    "K2d": at.bwd_dkv_launch_count, "K1": mm.launch_count}
        steps = pytree.all_steps(cu.state_dir())
        second = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(second):
            rc_resume = cu.main(["train", "1", "--image-size=64",
                                 f"--max-steps={RESUME_STEPS}"])
        resume_s = time.perf_counter() - t0
    finally:
        cu.train_step = real_step
    text, text2 = first.getvalue(), second.getvalue()
    if (rc_init, rc_train, rc_resume) != (0, 0, 0):
        fail(f"cifar_unet init/train/train exited {rc_init}/{rc_train}/"
             f"{rc_resume}:\n{out.getvalue()}{text}{text2}")
    vals = torch.stack(losses).float().cpu()
    if len(losses) != TRAIN_STEPS + RESUME_STEPS:
        fail(f"{len(losses)} train steps, expected {TRAIN_STEPS} + "
             f"{RESUME_STEPS}")
    if not torch.isfinite(vals).all():
        fail(f"non-finite step losses: {vals.tolist()}")
    per_step = 4 * TRAIN_STEPS  # 4 flash sites, one forward and backward
    for name in ("K2", "K2c", "K2d"):
        if launches[name] != per_step:
            fail(f"{name} launched {launches[name]} times in {TRAIN_STEPS} "
                 f"steps, expected {per_step} (4 flash sites per step)")
    head, tail = (vals[:10].mean().item(),
                  vals[TRAIN_STEPS - 10:TRAIN_STEPS].mean().item())
    if not tail < head:
        fail(f"the loss did not fall: mean of steps 1-10 {head}, of steps "
             f"{TRAIN_STEPS - 9}-{TRAIN_STEPS} {tail}")
    if steps != [TRAIN_STEPS]:
        fail(f"train_state_torch/ holds steps {steps} after the first train, "
             f"expected [{TRAIN_STEPS}]")
    resumed = f"resumed train state at step {TRAIN_STEPS} (epoch 1)"
    if resumed not in text2 or "epoch: 0\t" in text2:
        fail(f"the second train did not resume at epoch 1:\n{text2}")
    ep0, ep1 = _epoch_line(text, 0), _epoch_line(text2, 1)
    print(f"[9 unet train] {n_ex} synthesized CIFAR examples in "
          f"{synth_s:.2f} s; cifar_unet init {init_s:.2f} s; train 1 "
          f"--image-size=64 --max-steps={TRAIN_STEPS} (full width, batch "
          f"16, bf16 compute, f32 masters, Adam) {train_s:.2f} s wall, epoch "
          f"{ep0['epoch_seconds']} s ({ep0['images_per_sec']} images/s): "
          f"launches K2 {launches['K2']}, K2c {launches['K2c']}, K2d "
          f"{launches['K2d']} (K1 {launches['K1']}); loss mean of steps "
          f"1-10 {head:.5f}, of steps {TRAIN_STEPS - 9}-{TRAIN_STEPS} "
          f"{tail:.5f}; first/last {vals[0].item():.5f}/"
          f"{vals[TRAIN_STEPS - 1].item():.5f}; train_state_torch/step_"
          f"{TRAIN_STEPS}. Resumed train 1 --max-steps={RESUME_STEPS} "
          f"{resume_s:.2f} s wall: '{resumed}', epoch 1 avg_loss "
          f"{ep1['avg_loss']}", flush=True)
    return launches


def _unet_grad(cu, params, x0, tt, noise, cfg, device="cuda"):
    """(loss, {path: gradient}) of ``cu.loss_fn`` on ``device`` with the
    draws given, the parameters cast to the compute dtype first."""
    dt = getattr(torch, cfg.compute_dtype)
    leaves = cu.tree_map(
        lambda a: a.to(device, dt).requires_grad_(), params)
    loss = cu.loss_fn(leaves, x0.to(device, dt), tt.to(device),
                      noise.to(device, dt), cfg)
    flat = cu.tree_leaves(leaves)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    return loss.item(), [torch.zeros_like(p) if g is None else g.double()
                         for p, g in zip(flat, grads)]


def _leaf_errors(got, want):
    """(worst over leaves of max|got − want| / that leaf's max|want|, worst
    max|got − want| over all leaves / the largest max|want|, the median of
    the first); a leaf whose reference is all zero counts its absolute
    difference."""
    per_leaf, errs, scales = [], [], []
    for a, b in zip(got, want):
        scale = b.abs().max().item()
        err = (a.double() - b).abs().max().item()
        per_leaf.append(err / scale if scale > 0 else err)
        errs.append(err)
        scales.append(scale)
    return (max(per_leaf), max(errs) / max(scales),
            sorted(per_leaf)[len(per_leaf) // 2])


def _site_share(at, sites) -> float:
    """K2c/K2d against the plain backward on each flash site's captured
    operands, at the f32 bounds of phase 8; returns the worst err/tol."""
    worst = 0.0
    for i, args in enumerate(sites):
        got = at._kernel_flash_bwd(*args)
        want = at._plain_flash_bwd(*args)
        for name, x, y in zip(("dq", "dk", "dv"), got, want):
            ratio = ((x - y).abs() / (K2BWD_F32_ATOL + K2BWD_F32_RTOL
                                      * y.abs())).max().item()
            worst = max(worst, ratio)
            if not ratio <= 1.0:
                fail(f"flash site {i} of the f32 gradient, {name}: K2c/K2d "
                     f"err exceeds atol {K2BWD_F32_ATOL} + rtol "
                     f"{K2BWD_F32_RTOL}*|ref| by {ratio}x")
    return worst


def _score_overshoot(at, q, k, lse):
    """(max|s|, max(s − lse2) with the scores K2c/K2d use, the same with
    the Pallas kernels' scores) at one flash site, s in log2 units. The
    kernels recompute the forward's scores, from q scaled and rounded to its
    dtype; the Pallas backward scales the unrounded f32 score, and where the
    overshoot passes 128, p = exp2(s − lse2) overflows to inf."""
    c = at._qscale(q.shape[-1])
    qf, kt = q.float(), k.float().transpose(-1, -2)
    lse2 = lse[..., None] * at._LOG2E
    s = (qf * c).to(q.dtype).float() @ kt
    s_pallas = (qf @ kt) * c
    return (s.abs().max().item(), (s - lse2).max().item(),
            (s_pallas - lse2).max().item())


def _condition_attention(cu, params, x0, tt, noise, cfg, device="cuda"):
    """A copy of ``params`` on ``device`` with each attention site's q and k
    projections scaled by f = min(1, sqrt(GRAD_SCORE_RANGE / w)), w the
    widest row of its scores q.k^T/sqrt(d) in an f32 forward on the given
    draws. A site's factor is applied in that forward before the sites
    after it are measured. Returns (params, {site: (w, f)})."""
    import math

    params = cu.tree_map(lambda a: a.to(device, torch.float32), params)
    real = cu.self_attention_block
    factors = {}  # id of a site's q → (w, f)

    def block(x, p):
        tokens = x.flatten(2).transpose(1, 2)
        s = (tokens @ p["q"]) @ (tokens @ p["k"]).transpose(-1, -2)
        w = ((s.amax(-1) - s.amin(-1)).max() / math.sqrt(
            p["q"].shape[1])).item()
        f = math.sqrt(GRAD_SCORE_RANGE / w) if w > GRAD_SCORE_RANGE else 1.0
        factors[id(p["q"])] = (w, f)
        return real(x, dict(p, q=p["q"] * f, k=p["k"] * f))

    cu.self_attention_block = block
    try:
        with torch.no_grad():
            cu.loss_fn(params, x0.to(device), tt.to(device),
                       noise.to(device), cfg)
    finally:
        cu.self_attention_block = real
    sites = {}
    for stage, blocks in params.items():
        for name, p in blocks.items() if isinstance(blocks, dict) else ():
            if name.startswith("attn"):
                w, f = sites[f"{stage} {name}"] = factors.pop(id(p["q"]))
                p["q"], p["k"] = p["q"] * f, p["k"] * f
    if factors or len(sites) != 5:
        fail(f"conditioned {len(sites)} attention sites, expected 5")
    return params, sites


def phase_grad_oracle() -> list:
    """From the trained CSV tree: one f32 full-width 64x64 gradient at
    batch 2 on fixed draws (dropout off) through K2c/K2d, on the
    conditioned net (``_condition_attention``); each leaf against the same
    with the plain backward at the four flash sites (bounded) and against
    the f64 gradient (dense attention; reported); the kernels against the
    plain backward on each flash site's operands (bounded). The trained
    net's own bf16 gradient must be finite; its sites' scores are reported.
    Then one bf16 batch-16 train step's time. Returns the f32 gradient's
    flash-site operands (q, k, v, o, lse, g)."""
    import dataclasses

    import torch.nn.functional as F

    from big_linear_algebra_tpu_torch.models import cifar_unet as cu
    from big_linear_algebra_tpu_torch.nn import attention as at

    cfg = dataclasses.replace(cu.CONFIG, image_size=64, dropout_rate=0.0)
    params = cu.load_params_csv(cfg)
    gen = torch.Generator().manual_seed(7)
    x0 = torch.rand(2, 3, 64, 64, generator=gen) * 2 - 1
    tt = torch.randint(0, cfg.timesteps, (2,), generator=gen)
    noise = torch.randn(2, 3, 64, 64, generator=gen)
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    conditioned, factors = _condition_attention(cu, params, x0, tt, noise, f32)
    kernel = at._kernel_flash_bwd
    runs = {"f32": conditioned, "bf16": params, "f64": conditioned}
    dtypes = {"f32": "float32", "bf16": "bfloat16", "f64": "float64"}
    sites = {name: [] for name in runs}  # each run's flash-site operands
    name = "f32"  # the run under way, read by capture

    def capture(*args):
        sites[name].append(tuple(a.detach().clone() for a in args))
        return kernel(*args)

    results = {}
    at._kernel_flash_bwd = capture
    try:
        for name, tree in runs.items():
            at.launch_count = at.bwd_dq_launch_count = 0
            at.bwd_dkv_launch_count = 0
            results[name] = _unet_grad(cu, tree, x0, tt, noise,
                                       dataclasses.replace(
                                           cfg, compute_dtype=dtypes[name]))
            torch.cuda.synchronize()
            counts = (at.launch_count, at.bwd_dq_launch_count,
                      at.bwd_dkv_launch_count)
            if counts != ((0, 0, 0) if name == "f64" else (4, 4, 4)):
                fail(f"{name} gradient launched K2/K2c/K2d {counts} times")
        at._kernel_flash_bwd = at._plain_flash_bwd
        results["f32 plain"] = _unet_grad(cu, conditioned, x0, tt, noise, f32)
    finally:
        at._kernel_flash_bwd = kernel
    grads = {k: g for k, (_, g) in results.items()}
    if not all(torch.isfinite(g).all() for gs in grads.values() for g in gs):
        fail("non-finite gradient leaves (the bf16 gradient included)")
    if len(sites["f32"]) != 4:
        fail(f"{len(sites['f32'])} flash sites in the f32 gradient, "
             "expected 4")
    site = _site_share(at, sites["f32"])
    scores = [_score_overshoot(at, q, k, lse)
              for q, k, _, _, lse, _ in sites["bf16"]]
    share = _leaf_errors(grads["f32"], grads["f32 plain"])
    vs_f64 = _leaf_errors(grads["f32"], grads["f64"])
    plain_vs_f64 = _leaf_errors(grads["f32 plain"], grads["f64"])

    def fmt(e):
        return (f"worst leaf {e[0]:.3e} of its max|ref|, {e[1]:.3e} of the "
                f"largest max|ref|, median leaf {e[2]:.3e}")

    print(f"[10 grad oracle] full-width 64x64 f32 gradient at batch 2, t="
          f"{tt.tolist()}, dropout off, {len(grads['f32'])} leaves, on the "
          f"conditioned net (per attention site, the widest score row "
          f"before and the q, k factor: "
          f"{', '.join(f'{k} {w:.4g}, {f:.4g}' for k, (w, f) in factors.items())}"
          f"): "
          f"gradient through K2c/K2d vs with the plain backward: "
          f"{fmt(share)} (tol {GRAD_SHARE_RTOL_OF_MAX} per leaf); K2c/K2d vs "
          f"plain on the 4 flash sites' operands, worst err/(atol "
          f"{K2BWD_F32_ATOL} + rtol {K2BWD_F32_RTOL}*|ref|) {site:.3e} (tol "
          f"1); reported, no bound: through K2c/K2d vs f64 (dense "
          f"attention): {fmt(vs_f64)}; plain vs f64: {fmt(plain_vs_f64)}; "
          f"losses f32 {results['f32'][0]:.6f}, f32 plain "
          f"{results['f32 plain'][0]:.6f}, f64 {results['f64'][0]:.6f}. "
          f"The trained net's bf16 gradient is finite; at its 4 flash sites, "
          f"in backward order (up_3 attn_2, attn_1, down_2 attn_2, attn_1), "
          f"max|s| in log2 units "
          f"{[round(s[0], 1) for s in scores]}, max(s - lse2) with the "
          f"kernels' scores {[round(s[1], 4) for s in scores]}, with the "
          f"Pallas kernels' scores {[round(s[2], 4) for s in scores]} "
          f"(p overflows past 128)", flush=True)
    if not share[0] <= GRAD_SHARE_RTOL_OF_MAX:
        fail(f"the f32 gradient through K2c/K2d differs from the one with "
             f"the plain backward by {share[0]:.3e} of a leaf's max|ref| "
             f"(tol {GRAD_SHARE_RTOL_OF_MAX})")
    phase_train_step_time(cu, params)
    return sites["f32"]


def phase_train_step_time(cu, params, n_steps=3) -> None:
    """One bf16 train step at batch 16, 64x64 (f32 masters, Adam, dropout
    on): host wall time per step, and the device busy time of a traced
    run of ``n_steps`` steps."""
    import dataclasses

    cfg = dataclasses.replace(cu.CONFIG, image_size=64)
    state = {"p": cu.tree_map(lambda a: a.to("cuda"), params)}
    state["opt"] = cu.adam_init(state["p"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand(cfg.batch_size, 3, 64, 64, generator=gen,
                   device="cuda") * 2 - 1

    def step():
        state["p"], state["opt"], _ = cu.train_step(
            state["p"], state["opt"], x, gen, cfg)

    host_ms, busy_ms, summary, _ = _host_and_trace(step, n_steps)
    print(f"[10 train step] one bf16 train step, batch 16, 64x64, full "
          f"width: host wall {host_ms:.3f} ms per step (synchronised, no "
          f"profiler); device busy {busy_ms:.3f} ms per step = "
          f"{busy_ms / host_ms:.1%} of that; trace of {n_steps} steps "
          f"(trace_summary.py):\n    " + summary.replace("\n", "\n    "),
          flush=True)


def _k5_inputs(b, c, f, h, w, dtype, gen):
    """(x, td, w1, w2, w3 or None, g) made on the CPU from ``gen`` at the
    path's scale (x, td, g ~ N(0, 1); He-normal convs), on the card."""
    x = torch.randn(b, c, h, w, generator=gen)
    td = torch.randn(b, f, generator=gen)
    w1 = torch.randn(f, c, 3, 3, generator=gen) * (2.0 / (9 * c)) ** 0.5
    w2 = torch.randn(f, f, 3, 3, generator=gen) * (2.0 / (9 * f)) ** 0.5
    w3 = (None if c == f else
          torch.randn(f, c, 1, 1, generator=gen) * (1.0 / c) ** 0.5)
    g = torch.randn(b, f, h, w, generator=gen)
    return tuple(None if a is None else a.to("cuda", dtype)
                 for a in (x, td, w1, w2, w3, g))


def _k5_ratio(name: str, got, want) -> float:
    """max over elements of |got − want| / (atol + rtol·|want|), at the f32
    tolerance of the output ``name`` (K5a's "out" or a gradient)."""
    atol, rtol = ((K5_F32_ATOL, K5_F32_RTOL) if name == "out" else
                  (K5_GRAD_ATOL, K5_GRAD_RTOL))
    want = want.double()
    return ((got.double() - want).abs()
            / (atol + rtol * want.abs())).max().item()


def phase_k5_vs_plain() -> dict:
    """K5a and K5b against the plain versions on every case, and the
    kernels' dropout bits against ``_dropout_bits``; returns the worst abs
    error per kernel over the f32 cases ({"K5a": .., "K5b": ..})."""
    from big_linear_algebra_tpu_torch.nn import fused_block as fb

    b, c, f, h, w, _ = K5_SHAPES[0]
    n_bits = f * b * h * w
    got = fb.kernel_dropout_bits(1234567, n_bits, "cuda")
    want = fb._dropout_bits(fb._seed_tensor(1234567, "cuda"), n_bits)
    if not torch.equal(got, want):
        fail(f"the kernels' dropout bits differ from _dropout_bits at "
             f"{int((got != want).sum())} of {n_bits} indices")
    kept = (want >= fb._threshold(K5_RATE)).float().mean().item()
    gen = torch.Generator().manual_seed(8)
    worst_abs = {"K5a": 0.0, "K5b data": 0.0, "K5b wgrad": 0.0}
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    names = ("out", "dx", "d_td", "dw1", "dw2", "dw3")
    worst_f32 = dict.fromkeys(names, 0.0)  # per output, err/tol
    plain_f32 = dict.fromkeys(names, 0.0)  # the plain f32 version's
    bad = []
    n_cases = 0
    _zero_fused_counts(fb)
    for b, c, f, h, w, gsz in K5_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for train in (False, True):
                *ops, g = _k5_inputs(b, c, f, h, w, dtype, gen)
                seed = fb._seed_tensor(77 + n_cases, "cuda")
                args = (*ops, seed, gsz, K5_RATE, train, 1e-8)
                outs = (fb._kernel_fused_fwd(*args),
                        *fb._kernel_fused_bwd(*args, g))
                refs = (fb._plain_fused_fwd(*args),
                        *fb._plain_fused_bwd(*args, g))
                if dtype == torch.float32:
                    plain32 = refs
                    wide = [None if a is None else a.double()
                            for a in (*ops, g)]
                    wargs = (*wide[:5], seed, gsz, K5_RATE, train, 1e-8)
                    refs = (fb._plain_fused_fwd(*wargs),
                            *fb._plain_fused_bwd(*wargs, wide[5]))
                    for name, x, y in zip(names, plain32, refs):
                        if y is not None:
                            plain_f32[name] = max(plain_f32[name],
                                                  _k5_ratio(name, x, y))
                torch.cuda.synchronize()
                case = (f"{str(dtype)[6:]} B={b} C={c} F={f} {h}x{w} "
                        f"train={train}")
                for name, x, y in zip(names, outs, refs):
                    if x is None and y is None:
                        continue
                    if x.shape != y.shape or x.dtype != dtype:
                        bad.append(f"{case} {name}: {tuple(x.shape)} "
                                   f"{x.dtype}, expected {tuple(y.shape)} "
                                   f"{y.dtype}")
                        continue
                    diff = (x.double() - y.double()).abs().max().item()
                    if dtype == torch.float32:
                        kern = ("K5a" if name == "out" else "K5b data"
                                if name in ("dx", "d_td") else "K5b wgrad")
                        worst_abs[kern] = max(worst_abs[kern], diff)
                        ratio = _k5_ratio(name, x, y)
                        worst_f32[name] = max(worst_f32[name], ratio)
                        if not ratio <= 1.0:
                            bad.append(f"{case} {name}: err exceeds its f32 "
                                       f"tolerance by {ratio}x")
                    else:
                        ratio = (diff / y.double().abs().max().item()
                                 / K5_BF16_RTOL_OF_MAX)
                        if not ratio <= 1.0:
                            bad.append(f"{case} {name}: err / max|ref| "
                                       f"{ratio * K5_BF16_RTOL_OF_MAX} > "
                                       f"{K5_BF16_RTOL_OF_MAX}")
                    worst[dtype] = max(worst[dtype], ratio)
                n_cases += 1
    if bad:
        fail(f"{len(bad)} K5a/K5b outputs disagree with the plain version:"
             "\n  " + "\n  ".join(bad))
    routes = (fb.tc_launch_count, fb.launch_count - fb.tc_launch_count,
              fb.bwd_tc_launch_count,
              fb.bwd_launch_count - fb.bwd_tc_launch_count)
    print(f"[11 K5 vs plain] K5a's {n_cases} cases by route: tensor cores "
          f"{routes[0]}, FMA {routes[1]}; K5b's data gradients: tensor "
          f"cores {routes[2]}, FMA {routes[3]}", flush=True)
    print(f"[11 K5 vs plain] dropout bits of {n_bits} indices bit-equal to "
          f"_dropout_bits (kept at rate {K5_RATE}: {kept:.5f}); {n_cases} "
          f"cases pass (f32/bf16 x train on/off x (B, C, F, H, W, group) "
          f"{K5_SHAPES}): worst f32 err/tol against the plain version in "
          f"f64 {worst[torch.float32]:.3f} ("
          + ", ".join(f"{k} {v:.3f}" for k, v in worst_f32.items())
          + "; the plain f32 version's own: "
          + ", ".join(f"{k} {v:.3f}" for k, v in plain_f32.items())
          + f"; out: atol {K5_F32_ATOL} + "
          f"rtol {K5_F32_RTOL}*|ref|; gradients: atol {K5_GRAD_ATOL} + rtol "
          f"{K5_GRAD_RTOL}*|ref|), worst bf16 err/tol "
          f"{worst[torch.bfloat16]:.3f} (tol {K5_BF16_RTOL_OF_MAX} of "
          f"max|ref|); worst f32 abs err K5a {worst_abs['K5a']:.3e}, K5b "
          f"data gradients {worst_abs['K5b data']:.3e}, weight gradients "
          f"{worst_abs['K5b wgrad']:.3e}", flush=True)
    return worst_abs


def _tc_info(b, c, f, h, w, gsz) -> dict:
    """The C side's plan of the tensor-core K5a and its occupancy
    (``bla_fused_block_tc_info``): cluster size, shared-memory bytes,
    blocks per SM, most clusters resident at once."""
    from big_linear_algebra_tpu_torch.ops import cuda_utils

    fn = cuda_utils.load_library("fused_block_tc").bla_fused_block_tc_info
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
    out = (ctypes.c_int * 4)()
    rc = fn(b, c, f, h, w, gsz, out)
    if rc != 0:
        fail(f"bla_fused_block_tc_info{(b, c, f, h, w, gsz)} returned {rc}")
    return dict(zip(("nc", "smem", "blocks", "clusters"), out))


def _tc_split(b, c, f, h, w, gsz) -> str:
    """The tensor-core K5a's plan as a line: split, grid, occupancy."""
    info = _tc_info(b, c, f, h, w, gsz)
    mb = f // info["nc"]
    per_group = max(1, gsz // mb)
    return (f"clusters of {info['nc']} blocks, {mb} output channels a block "
            f"({per_group} block{'s' if per_group > 1 else ''} a GN group), "
            f"grid {info['nc']}x{b} = {info['nc'] * b} blocks of 256 "
            f"threads, {info['smem']} B shared, {info['blocks']} blocks/SM, "
            f"{info['clusters']} clusters resident at once")


def _bwd_tc_info(b, c, f, h, w, gsz) -> dict:
    """The C side's plan of K5b's tensor-core data-gradient kernel and its
    occupancy (``bla_fused_block_bwd_tc_info``): cluster size,
    shared-memory bytes, blocks per SM, most clusters resident at once."""
    from big_linear_algebra_tpu_torch.ops import cuda_utils

    fn = cuda_utils.load_library(
        "fused_block_tc").bla_fused_block_bwd_tc_info
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
    out = (ctypes.c_int * 4)()
    rc = fn(b, c, f, h, w, gsz, out)
    if rc != 0:
        fail(f"bla_fused_block_bwd_tc_info{(b, c, f, h, w, gsz)} returned "
             f"{rc}")
    return dict(zip(("nc", "smem", "blocks", "clusters"), out))


def _bwd_tc_split(b, c, f, h, w, gsz) -> str:
    """K5b's tensor-core data-gradient plan as a line."""
    info = _bwd_tc_info(b, c, f, h, w, gsz)
    nc = info["nc"]
    return (f"clusters of {nc} blocks, {f // nc} channels of F and {c // nc} "
            f"of C a block, grid {nc}x{b} = {nc * b} blocks of 256 threads, "
            f"{info['smem']} B shared, {info['blocks']} blocks/SM, "
            f"{info['clusters']} clusters resident at once")


def _dp_fused_shapes(listed) -> list:
    """The fused blocks of a U-Net DP rank's ``--fused-block`` forward at
    32x32 (``Config``, at the per-rank batch of each of
    ``DP_RANK_COUNTS``) as (B, C, F, H, W, group size), less those in
    ``listed``."""
    from big_linear_algebra_tpu_torch.models import cifar_unet as cu

    cfg, out = cu.CONFIG, []
    for ranks in DP_RANK_COUNTS:
        for block in _unet_fused_blocks(cfg, cfg.batch_size // ranks):
            shape = (*block, cfg.group_size)
            if shape not in listed and shape not in out:
                out.append(shape)
    return out


def phase_k5a_tc_vs_plain() -> float:
    """The tensor-core K5a alone at K5_TC_SHAPES and a U-Net DP rank's
    blocks (``_dp_fused_shapes``), bf16 x train on/off,
    against ``_plain_fused_fwd`` (2e-2 of max|ref|), every case on that
    route and its Python plan equal to the C side's; two runs bit-equal at
    the train step's and the sampler's largest block. Returns the worst
    abs error over its cases and phase 11's bf16 full-width ones."""
    from big_linear_algebra_tpu_torch.nn import fused_block as fb

    gen = torch.Generator().manual_seed(12)
    bad, worst, worst_abs, n_cases = [], 0.0, 0.0, 0
    fb.launch_count = fb.tc_launch_count = 0
    shapes = K5_TC_SHAPES + [s for s in K5_SHAPES if fb._fwd_route(
        torch.bfloat16, *s[:5], 3, s[5]) == "tc"]
    shapes += _dp_fused_shapes(shapes)
    for b, c, f, h, w, gsz in shapes:
        plan = fb._tc_plan(b, c, f, h, w, 3, gsz)
        info = _tc_info(b, c, f, h, w, gsz)
        if plan != (info["nc"], info["smem"]):
            bad.append(f"B={b} C={c} F={f} {h}x{w}: Python plan {plan}, C "
                       f"plan {(info['nc'], info['smem'])}")
        for train in (False, True):
            *ops, _ = _k5_inputs(b, c, f, h, w, torch.bfloat16, gen)
            args = (*ops, fb._seed_tensor(300 + n_cases, "cuda"), gsz,
                    K5_RATE, train, 1e-8)
            got = fb._kernel_fused_fwd(*args)
            want = fb._plain_fused_fwd(*args)
            torch.cuda.synchronize()
            n_cases += 1
            case = f"B={b} C={c} F={f} {h}x{w} train={train}"
            if got.shape != want.shape or got.dtype != torch.bfloat16:
                bad.append(f"{case}: {tuple(got.shape)} {got.dtype}")
                continue
            diff = (got.double() - want.double()).abs().max().item()
            ratio = diff / want.double().abs().max().item()
            worst, worst_abs = max(worst, ratio), max(worst_abs, diff)
            if not ratio <= K5_BF16_RTOL_OF_MAX:
                bad.append(f"{case}: err / max|ref| {ratio:.3e} > "
                           f"{K5_BF16_RTOL_OF_MAX}")
    if (fb.tc_launch_count, fb.launch_count) != (n_cases, n_cases):
        bad.append(f"{fb.tc_launch_count} of {fb.launch_count} launches on "
                   f"the tensor-core route, expected all {n_cases}")
    equal = []
    for b, c, f, h, w, gsz in (K5_SHAPES[0], K5_SHAPES[2]):
        *ops, _ = _k5_inputs(b, c, f, h, w, torch.bfloat16, gen)
        args = (*ops, fb._seed_tensor(5, "cuda"), gsz, K5_RATE, b > 1, 1e-8)
        one, two = fb._kernel_fused_fwd(*args), fb._kernel_fused_fwd(*args)
        if not torch.equal(one, two):
            bad.append(f"B={b} C={c} F={f} {h}x{w}: two runs differ")
        equal.append(f"B={b} C={c} {h}x{w}")
    if bad:
        fail("tensor-core K5a:\n  " + "\n  ".join(bad))
    print(f"[11 K5a tensor cores] {n_cases} bf16 cases, all on the "
          f"tensor-core route (train on/off at (B, C, F, H, W, group) "
          f"{shapes}), worst err/max|ref| {worst:.3e} (tol "
          f"{K5_BF16_RTOL_OF_MAX}), worst abs err {worst_abs:.3e}; Python "
          f"plans equal the C side's; two runs bit-equal at "
          f"{', '.join(equal)}", flush=True)
    return worst_abs


def phase_k5a_tc_build_info() -> None:
    """The tensor-core K5a's kernels (H·W 64 and 16): registers, shared
    memory and spills from the build's ``-Xptxas -v``, blocks per SM and
    clusters resident at once from the occupancy API at each timed shape,
    and the HMMA instructions in their SASS. Fails on a spill, on no HMMA
    or on a plan that no SM can hold."""
    stats = _kernel_stats("fused_block_tc",
                          re.compile(r"fused_block_fwd_tcILi(\d+)E"))
    bad, parts = [], []
    for nt, shapes in (("8", K5_TIMED + [K5_WAVE, K5_SHAPES[2]]),
                       ("2", [K5_SHAPES[1], K5_TC_SHAPES[2]])):
        st = dict(stats.get((nt,), {}))
        occ = [(s, _tc_info(*s)) for s in shapes]
        st["blocks"] = min(i["blocks"] for _, i in occ)
        why = _check_stats(f"fused_block_fwd_tc<{nt}>", st, True)
        if why or min(i["clusters"] for _, i in occ) < 1:
            bad.append(why or f"fused_block_fwd_tc<{nt}>: {occ}")
            continue
        parts.append(
            f"H·W {int(nt) * 8}: {st['regs']} regs, {st['spill']} B spill, "
            f"{st['mma']} HMMA; " + ", ".join(
                f"(B={s[0]}, C={s[1]}): {i['smem']} B shared, {i['blocks']} "
                f"blocks/SM, clusters of {i['nc']}, {i['clusters']} resident"
                for s, i in occ))
    if bad:
        fail("tensor-core K5a (spill, no HMMA or no cluster fits):\n  "
             + "\n  ".join(bad))
    print("[11 K5a build] tensor-core kernels (256 threads, dynamic shared "
          "memory; -Xptxas -v, cudaOccupancy, cuobjdump -sass): "
          + "; ".join(parts), flush=True)


def phase_k5b_tc_vs_plain() -> dict:
    """K5b on the tensor-core route (both kernels), alone at K5B_TC_SHAPES
    and a U-Net DP rank's blocks (``_dp_fused_shapes``), bf16 x train
    on/off, against ``_plain_fused_bwd`` (every output within
    2e-2 of its max|ref|), every case on that route and its Python plan
    equal to the C side's; two runs bit-equal at the train
    step's 8x8 block and the 512 -> 256 4x4 one. Returns the worst abs
    error over its cases of each kernel's outputs ({"K5b tc": dx and d_td,
    "K5b tc wgrad": dw1, dw2, dw3})."""
    from big_linear_algebra_tpu_torch.nn import fused_block as fb

    gen = torch.Generator().manual_seed(14)
    names = ("dx", "d_td", "dw1", "dw2", "dw3")
    bad, n_cases = [], 0
    worst_abs = {"K5b tc": 0.0, "K5b tc wgrad": 0.0}
    worst = dict.fromkeys(names, 0.0)
    _zero_fused_counts(fb)
    shapes = K5B_TC_SHAPES + _dp_fused_shapes(K5B_TC_SHAPES)
    for b, c, f, h, w, gsz in shapes:
        plan = fb._bwd_tc_plan(b, c, f, h, w, 3, gsz)
        info = _bwd_tc_info(b, c, f, h, w, gsz)
        if plan != (info["nc"], info["smem"]):
            bad.append(f"B={b} C={c} F={f} {h}x{w}: Python plan {plan}, C "
                       f"plan {(info['nc'], info['smem'])}")
        for train in (False, True):
            *ops, g = _k5_inputs(b, c, f, h, w, torch.bfloat16, gen)
            args = (*ops, fb._seed_tensor(400 + n_cases, "cuda"), gsz,
                    K5_RATE, train, 1e-8)
            got = fb._kernel_fused_bwd(*args, g)
            want = fb._plain_fused_bwd(*args, g)
            torch.cuda.synchronize()
            n_cases += 1
            case = f"B={b} C={c} F={f} {h}x{w} train={train}"
            for name, x, y in zip(names, got, want):
                if x is None and y is None:
                    continue
                if x.shape != y.shape or x.dtype != torch.bfloat16:
                    bad.append(f"{case} {name}: {tuple(x.shape)} {x.dtype}")
                    continue
                diff = (x.double() - y.double()).abs().max().item()
                ratio = diff / y.double().abs().max().item()
                worst[name] = max(worst[name], ratio)
                kern = "K5b tc" if name in ("dx", "d_td") else "K5b tc wgrad"
                worst_abs[kern] = max(worst_abs[kern], diff)
                if not ratio <= K5_BF16_RTOL_OF_MAX:
                    bad.append(f"{case} {name}: err / max|ref| {ratio:.3e} "
                               f"> {K5_BF16_RTOL_OF_MAX}")
    counts = (fb.bwd_tc_launch_count, fb.bwd_launch_count,
              fb.wgrad_tc_launch_count, fb.wgrad_launch_count)
    if counts != (n_cases,) * 4:
        bad.append(f"{counts[0]} of {counts[1]} data-gradient and {counts[2]} "
                   f"of {counts[3]} weight-gradient launches on the "
                   f"tensor-core route, expected all {n_cases}")
    equal = []
    for b, c, f, h, w, gsz in (K5B_TC_SHAPES[0], K5B_TC_SHAPES[1]):
        *ops, g = _k5_inputs(b, c, f, h, w, torch.bfloat16, gen)
        args = (*ops, fb._seed_tensor(6, "cuda"), gsz, K5_RATE, True, 1e-8)
        one, two = fb._kernel_fused_bwd(*args, g), fb._kernel_fused_bwd(
            *args, g)
        if not all(x is None or torch.equal(x, y) for x, y in zip(one, two)):
            bad.append(f"B={b} C={c} F={f} {h}x{w}: two runs differ")
        equal.append(f"B={b} C={c} {h}x{w}")
    if bad:
        fail("tensor-core K5b:\n  " + "\n  ".join(bad))
    print(f"[11 K5b tensor cores] {n_cases} bf16 cases, every data-gradient "
          f"and weight-gradient launch on the tensor-core route (train "
          f"on/off at (B, C, F, H, "
          f"W, group) {shapes}), worst err/max|ref| "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
          + f" (tol {K5_BF16_RTOL_OF_MAX}), worst abs err of dx and d_td "
          f"{worst_abs['K5b tc']:.3e}, of the weight gradients "
          f"{worst_abs['K5b tc wgrad']:.3e}; Python plans equal the C "
          f"side's; two runs bit-equal at {', '.join(equal)}", flush=True)
    return worst_abs


def phase_k5b_tc_build_info() -> None:
    """K5b's tensor-core kernels (H·W 64 and 16): registers, shared memory
    and spills from the build's ``-Xptxas -v``, blocks per SM (and, for the
    data-gradient kernel, clusters resident at once at each of
    K5B_TC_SHAPES), and the HMMA instructions in their SASS. Fails on a
    spill, on no HMMA or on a plan that no SM can hold."""
    stats = _kernel_stats("fused_block_tc",
                          re.compile(r"fused_block_bwd_tcILi(\d+)E"))
    bad, parts = [], []
    for nt, hw in (("8", 8), ("2", 4)):
        st = dict(stats.get((nt,), {}))
        occ = [(s, _bwd_tc_info(*s)) for s in K5B_TC_SHAPES if s[3] == hw]
        st["blocks"] = min(i["blocks"] for _, i in occ)
        why = _check_stats(f"fused_block_bwd_tc<{nt}>", st, True)
        if why or min(i["clusters"] for _, i in occ) < 1:
            bad.append(why or f"fused_block_bwd_tc<{nt}>: {occ}")
            continue
        parts.append(
            f"H·W {hw * hw}: {st['regs']} regs, {st['spill']} B spill, "
            f"{st['mma']} HMMA; " + ", ".join(
                f"(B={s[0]}, C={s[1]}): {i['smem']} B shared, {i['blocks']} "
                f"blocks/SM, clusters of {i['nc']}, {i['clusters']} resident"
                for s, i in occ))
    wstats = _kernel_stats("fused_block_tc",
                           re.compile(r"fused_block_wgrad_tcILi(\d+)E"))
    info = _int_fn("fused_block_tc", "bla_fused_block_wgrad_tc_info", 1)
    info.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    for nt, hw in (("8", 8), ("2", 4)):
        st = dict(wstats.get((nt,), {}))
        blocks = ctypes.c_int(0)
        if info(hw, ctypes.byref(blocks)) != 0:
            fail(f"bla_fused_block_wgrad_tc_info({hw}) failed")
        st["blocks"] = blocks.value
        why = _check_stats(f"fused_block_wgrad_tc<{nt}>", st, True)
        if why:
            bad.append(why)
            continue
        parts.append(f"weight gradients H·W {hw * hw}: {st['regs']} regs, "
                     f"{st['smem']} B static shared, {st['spill']} B spill, "
                     f"{st['mma']} HMMA, {st['blocks']} blocks/SM")
    if bad:
        fail("tensor-core K5b (spill, no HMMA or no cluster fits):\n  "
             + "\n  ".join(bad))
    print("[11 K5b build] tensor-core data-gradient kernels (256 threads, "
          "dynamic shared memory) and weight-gradient kernels (256 threads; "
          "-Xptxas -v, cudaOccupancy, cuobjdump -sass): " + "; ".join(parts),
          flush=True)


def k5_bound_ms(kernel: str, b, c, f, h, w, dtype):
    """K5a ("fwd") or K5b ("bwd") at a block with no 1x1 residual: every
    input read once and every output written once, in the dtype, and the
    conv products the function does at the dtype's peak. K5a: conv_1 and
    conv_2 (2·B·HW·C_in·C_out·k² flops each); K5b: conv_1 again, and
    conv_2's and conv_1's dx and weight gradients. (The TPU kernel's cost
    estimate counts twice K5b's products: five times K5a's.)"""
    item = torch.finfo(dtype).bits // 8
    hw = h * w
    conv1, conv2 = 9 * c * f, 9 * f * f
    if kernel == "fwd":
        flops = 2 * b * hw * (conv1 + conv2)
        nbytes = item * (b * c * hw + b * f + conv1 + conv2 + b * f * hw)
    else:
        flops = 2 * b * hw * (3 * conv1 + 2 * conv2)
        # x, td, w1, w2 and g in; dx, d_td, dw1 and dw2 out
        nbytes = item * (2 * (b * c * hw + b * f + conv1 + conv2)
                         + b * f * hw)
    return _bound(nbytes, flops / PEAK_FLOPS[dtype])


def k5b_bound_ms(kernel: str, b, c, f, h, w, dtype, w3: bool,
                 ws_item: int):
    """One of K5b's two kernels: "data" (conv_1 recomputed, conv_2's and
    conv_1's dx, and w3ᵀ·g where the block has w3: 2·B·HW·9·(2·C·F + F·F)
    flops, + 2·B·HW·C·F) reading x, td, w1, w2 (w3) and g once and writing
    dx, d_td (f32) and the workspaces a1, d and dh1t (``ws_item`` bytes an
    element: 2 on the tensor-core route, 4 on the FMA route) once; or
    "wgrad" (dw1, dw2 and dw3: 2·B·HW·9·(C·F + F·F) flops, + 2·B·HW·C·F)
    reading the workspaces, x and g once and writing the f32 weight
    gradients. The two add up to ``k5_bound_ms("bwd", ...)``'s
    operations."""
    item = torch.finfo(dtype).bits // 8
    hw = h * w
    conv1, conv2, one = 9 * c * f, 9 * f * f, (c * f if w3 else 0)
    ws = ws_item * b * hw * (c + 2 * f)
    if kernel == "data":
        flops = 2 * b * hw * (2 * conv1 + conv2 + one)
        nbytes = (item * (b * c * hw + b * f + conv1 + conv2 + one
                          + b * f * hw + b * c * hw) + 4 * b * f + ws)
    else:
        flops = 2 * b * hw * (conv1 + conv2 + one)
        nbytes = item * b * hw * (c + f) + ws + 4 * (conv1 + conv2 + one)
    return _bound(nbytes, flops / PEAK_FLOPS[dtype])


def _unfused_block(x, td, w1, w2, w3, gen, train, gsz):
    """The port's unfused resnet block (the path without --fused-block)."""
    from big_linear_algebra_tpu_torch.nn.conv import conv2d
    from big_linear_algebra_tpu_torch.nn.dropout import dropout
    from big_linear_algebra_tpu_torch.nn.norm import group_norm
    from big_linear_algebra_tpu_torch.ops.activations import relu

    h = conv2d(relu(group_norm(x, gsz)), w1, 1) + td[:, :, None, None]
    h = dropout(relu(group_norm(h, gsz)), K5_RATE, gen,
                deterministic=not train)
    h = conv2d(h, w2, 1)
    return h + (x if w3 is None else conv2d(x, w3, 1))


def phase_k5_timing() -> dict:
    """bf16 at the train step's 8x8 block (B=16, train), the sampler's
    (B=1, eval) and K5_WAVE (15 examples, train): K5a on its tensor-core
    route and on the FMA route forced on the same input, K5b (both of its
    kernels), the plain versions and the port's unfused block forward and
    backward (autograd through its hand-written VJPs), in turns within this
    one process; the lower of each pair is kept. Returns the train shape's
    numbers."""
    from big_linear_algebra_tpu_torch.nn import fused_block as fb

    gen = torch.Generator().manual_seed(9)
    main = {}
    for b, c, f, h, w, gsz in K5_TIMED + [K5_WAVE]:
        train = b > 1
        x, td, w1, w2, w3, g = _k5_inputs(b, c, f, h, w, torch.bfloat16, gen)
        args = (x, td, w1, w2, w3, fb._seed_tensor(5, "cuda"), gsz, K5_RATE,
                train, 1e-8)
        cgen = torch.Generator(device="cuda").manual_seed(0)
        leaves = [a.detach().requires_grad_() for a in (x, td, w1, w2)]
        out = _unfused_block(*leaves, None, cgen, train, gsz)
        fns = {"K5a": lambda: fb._kernel_fused_fwd(*args, route="tc"),
               "K5a fma": lambda: fb._kernel_fused_fwd(*args, route="fma"),
               "plain fwd": lambda: fb._plain_fused_fwd(*args),
               "unfused fwd": lambda: _unfused_block(
                   x, td, w1, w2, w3, cgen, train, gsz),
               "K5b": lambda: fb._kernel_fused_bwd(*args, g),
               "plain bwd": lambda: fb._plain_fused_bwd(*args, g),
               "unfused bwd": lambda: torch.autograd.grad(
                   out, leaves, g, retain_graph=True)}
        names = tuple(fns)
        runs = {name: [] for name in names}
        for name in names + names[::-1]:
            runs[name].append(_time_ms(fns[name], iters=50, warmup=5))
        ms = {name: min(d for d, _ in runs[name]) for name in names}
        host = {name: min(hh for _, hh in runs[name]) for name in names}
        bounds = {k: k5_bound_ms(k, b, c, f, h, w, torch.bfloat16)
                  for k in ("fwd", "bwd")}
        wave = (" (one example fewer than the train step)"
                if (b, c, f, h, w, gsz) == K5_WAVE else "")
        print(f"[12 K5 timing] bf16 B={b} C={c} F={f} {h}x{w} train={train}"
              f"{wave}: device K5a tensor cores {ms['K5a'] * 1e3:.2f} us, "
              f"FMA route (clusters of {fb._plan(b, c, f, h, w, 3, gsz)[0]}) "
              f"{ms['K5a fma'] * 1e3:.2f} us (bound "
              f"{bounds['fwd'][0] * 1e3:.3f} us, {bounds['fwd'][1]}), plain "
              f"{ms['plain fwd'] * 1e3:.2f} us, unfused block "
              f"{ms['unfused fwd'] * 1e3:.2f} us; K5b (data + weight "
              f"gradients) {ms['K5b'] * 1e3:.2f} us (bound "
              f"{bounds['bwd'][0] * 1e3:.3f} us, {bounds['bwd'][1]}), plain "
              f"{ms['plain bwd'] * 1e3:.2f} us, unfused backward "
              f"{ms['unfused bwd'] * 1e3:.2f} us | host per call: K5a "
              f"tensor cores {host['K5a'] * 1e3:.2f} us, FMA route "
              f"{host['K5a fma'] * 1e3:.2f} us, K5b {host['K5b'] * 1e3:.2f} "
              f"us, unfused fwd {host['unfused fwd'] * 1e3:.2f} us, bwd "
              f"{host['unfused bwd'] * 1e3:.2f} us | tensor-core plan: "
              f"{_tc_split(b, c, f, h, w, gsz)}", flush=True)
        if (b, c, f, h, w, gsz) == K5_TIMED[0]:
            main = dict(ms, bound=bounds)
    return main


def _conv_weight_grads(work, w1, w2, w3):
    """dw1, dw2 (and dw3) by ``torch.nn.grad.conv2d_weight`` on the bf16
    rounded a1, dh1t, d, g and x that K5b's weight-gradient kernel reads
    (``work``), the library yardstick of that kernel (the port never calls
    it)."""
    x, g, a1, d, dh = work
    b, c, h, w = x.shape
    f = g.shape[1]
    a1, d, dh = (t.to(x.dtype).reshape(b, -1, h, w) for t in (a1, d, dh))
    grad = torch.nn.grad.conv2d_weight
    out = [grad(a1, w1.shape, dh, padding=1), grad(d, w2.shape, g, padding=1)]
    if w3 is not None:
        out.append(grad(x, (f, c, 1, 1), g))
    return out


def phase_k5b_timing() -> dict:
    """K5b's two kernels apart, bf16 train at K5B_TIMED: each on its
    tensor-core route and on the FMA route forced on the same input (the
    weight gradients on the workspaces of the data-gradient kernel of their
    route), the whole K5b (the Function's backward), the plain backward and
    ``conv2d_weight`` (the weight gradients' library yardstick) in turns
    within this one process, the lower of each pair kept; with the split
    bounds and host time per call (the tensor-core route's flipped weight
    copies included). Returns the train step's 8x8 block's numbers."""
    from big_linear_algebra_tpu_torch.nn import fused_block as fb

    gen = torch.Generator().manual_seed(13)
    main = {}
    for b, c, f, h, w, gsz in K5B_TIMED:
        x, td, w1, w2, w3, g = _k5_inputs(b, c, f, h, w, torch.bfloat16, gen)
        args = (x, td, w1, w2, w3, fb._seed_tensor(5, "cuda"), gsz, K5_RATE,
                True, 1e-8)
        tc = fb._bwd_route(torch.bfloat16, b, c, f, h, w, 3, gsz) == "tc"
        work = {r: fb._kernel_bwd_data(*args, g, route=r)[2]
                for r in (("tc", "fma") if tc else ("fma",))}
        fns = {"data tc": lambda: fb._kernel_bwd_data(*args, g, route="tc"),
               "data fma": lambda: fb._kernel_bwd_data(*args, g,
                                                       route="fma"),
               "wgrad tc": lambda: fb._kernel_bwd_wgrad(
                   work["tc"], 3, w3 is not None),
               "wgrad fma": lambda: fb._kernel_bwd_wgrad(
                   work["fma"], 3, w3 is not None),
               "K5b": lambda: fb._kernel_fused_bwd(*args, g),
               "plain bwd": lambda: fb._plain_fused_bwd(*args, g),
               "conv2d_weight": lambda: _conv_weight_grads(
                   work["fma"], w1, w2, w3)}
        if not tc:
            del fns["data tc"], fns["wgrad tc"]
        names = tuple(fns)
        runs = {name: [] for name in names}
        for name in names + names[::-1]:
            runs[name].append(_time_ms(fns[name], iters=50, warmup=5))
        ms = {name: min(d for d, _ in runs[name]) for name in names}
        host = {name: min(hh for _, hh in runs[name]) for name in names}
        bounds = {f"{k} {r}": k5b_bound_ms(k, b, c, f, h, w, torch.bfloat16,
                                          w3 is not None, item)
                  for k in ("data", "wgrad")
                  for r, item in (("tc", 2), ("fma", 4))}

        def us(name, table=ms):
            return (f"{table[name] * 1e3:.2f} us" if name in table else
                    "not taken")

        def bound(name):
            return (f"{bounds[name][0] * 1e3:.3f} us, {bounds[name][1]}")

        print(f"[12 K5b timing] bf16 B={b} C={c} F={f} {h}x{w} train=True"
              f"{' (w3)' if w3 is not None else ''}: device data gradients "
              f"tensor cores {us('data tc')} (bound {bound('data tc')}), "
              f"FMA route {us('data fma')} (bound {bound('data fma')}); "
              f"weight gradients tensor cores {us('wgrad tc')} (bound "
              f"{bound('wgrad tc')}), FMA route {us('wgrad fma')} (bound "
              f"{bound('wgrad fma')}), conv2d_weight "
              f"{us('conv2d_weight')}; K5b (both kernels, the route's) "
              f"{us('K5b')}, plain {us('plain bwd')} | host per call: data "
              f"tensor cores {us('data tc', host)} (with the weight copies), "
              f"FMA {us('data fma', host)}, weight gradients tensor cores "
              f"{us('wgrad tc', host)}, FMA {us('wgrad fma', host)}, K5b "
              f"{us('K5b', host)}"
              + (f" | plan: {_bwd_tc_split(b, c, f, h, w, gsz)}" if tc
                 else ""), flush=True)
        if (b, c, f, h, w, gsz) == K5B_TIMED[0]:
            main = dict(ms, bound=bounds)
    return main


def _fused_counts(fb) -> tuple:
    return fb.launch_count, fb.bwd_launch_count, fb.wgrad_launch_count


def _zero_fused_counts(fb) -> None:
    fb.launch_count = fb.bwd_launch_count = fb.wgrad_launch_count = 0
    fb.tc_launch_count = fb.bwd_tc_launch_count = 0
    fb.wgrad_tc_launch_count = 0


def phase_unet_fused_run(tmp: str) -> int:
    """``cifar_unet run 1 --fused-block`` at 32x32 from phase 6's checkpoint
    in ``tmp``; returns K5a's launches."""
    from big_linear_algebra_tpu_torch.data import bmp
    from big_linear_algebra_tpu_torch.models import cifar_unet as cu
    from big_linear_algebra_tpu_torch.nn import attention as at
    from big_linear_algebra_tpu_torch.nn import fused_block as fb

    out = io.StringIO()
    _zero_fused_counts(fb)
    at.launch_count = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cu.main(["run", "1", "--fused-block", "--sample-seed=0"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    k5a, k5b, wgrad = _fused_counts(fb)
    tc = fb.tc_launch_count
    if rc != 0:
        fail(f"cifar_unet run --fused-block exited {rc}:\n{out.getvalue()}")
    steps = cu.CONFIG.timesteps
    if (k5a, tc, k5b, wgrad) != (FUSED_PER_RUN_STEP * steps,) * 2 + (0, 0):
        fail(f"run --fused-block launched K5a/its tensor-core route/K5b/"
             f"weight gradients {(k5a, tc, k5b, wgrad)} times, expected "
             f"({FUSED_PER_RUN_STEP * steps}, {FUSED_PER_RUN_STEP * steps}, "
             f"0, 0)")
    path = os.path.join(tmp, "cifar_unet", "samples", "sample_0.bmp")
    planes = bmp.read_bmp(path)
    if any(p.shape != (32, 32) for p in planes):
        fail(f"{path}: planes of shape {[p.shape for p in planes]}, "
             "expected 32x32")
    lo = min(int(p.min()) for p in planes)
    hi = max(int(p.max()) for p in planes)
    if lo == hi:
        fail(f"{path}: constant image (every byte {lo})")
    print(f"[13 unet fused run] run 1 --fused-block (32x32, full width, 1000 "
          f"steps, bf16 compute) {run_s:.2f} s wall: K5a launches {k5a}, "
          f"all on the tensor-core route ({FUSED_PER_RUN_STEP} per step; "
          f"K2 {at.launch_count}); "
          f"samples/sample_0.bmp 32x32, bytes {lo}..{hi}", flush=True)
    return k5a


def phase_fused_oracle() -> int:
    """From phase 6's checkpoint at 32x32: the f32 forward (batch 1) with
    the fused blocks against the same forward unfused (bounded) and against
    f64 (reported); the bf16 forward with the fused blocks against the bf16
    forward unfused (bounded by K5_UNET_BF16_FACTOR times the unfused one's
    distance from f64); then one f32 train-mode gradient at batch 16 with
    the fused blocks, K5b against the plain backward on each fused block's
    operands (bounded), and its leaves against the gradient with the plain
    backward at those blocks, on the same dropout seeds (reported); then
    one bf16 train-mode gradient at batch 16, K5b (its data gradients on
    the tensor-core route) against the plain backward on each fused block's
    operands (2e-2 of max|ref|). Returns the FMA routes' launches (the f32
    forward and gradient): K5a's, and K5b's (its data-gradient kernel's,
    its weight-gradient kernel's)."""
    import dataclasses

    import torch.nn.functional as F

    from big_linear_algebra_tpu_torch.models import cifar_unet as cu
    from big_linear_algebra_tpu_torch.nn import fused_block as fb

    params = cu.load_params_csv(cu.CONFIG)
    gen = torch.Generator().manual_seed(10)
    x = torch.randn(1, 3, 32, 32, generator=gen).cuda()
    tb = torch.tensor([500], device="cuda")
    outs = {}
    fma_launches = 0
    with torch.inference_mode():
        for name, dt, fused in (("fused", "float32", True),
                                ("unfused", "float32", False),
                                ("f64", "float64", False),
                                ("bf16 fused", "bfloat16", True),
                                ("bf16 unfused", "bfloat16", False)):
            cfg = dataclasses.replace(cu.CONFIG, compute_dtype=dt,
                                      fused_block=fused)
            p = cu.tree_map(lambda a: a.to("cuda", getattr(torch, dt)),
                             params)
            _zero_fused_counts(fb)
            outs[name] = cu.forward(p, x, tb, cfg).double()
            torch.cuda.synchronize()
            want = FUSED_PER_RUN_STEP if fused else 0
            want_tc = want if dt == "bfloat16" else 0
            if (fb.launch_count, fb.tc_launch_count) != (want, want_tc):
                fail(f"the {name} forward launched K5a "
                     f"{fb.launch_count} times, {fb.tc_launch_count} on the "
                     f"tensor-core route, expected {want}, {want_tc}")
            fma_launches += fb.launch_count - fb.tc_launch_count
    if not all(torch.isfinite(o).all() for o in outs.values()):
        fail("non-finite U-Net outputs")
    scale = outs["unfused"].abs().max().item()
    share = (outs["fused"] - outs["unfused"]).abs().max().item() / scale
    f64_scale = outs["f64"].abs().max().item()
    vs_f64 = {k: (outs[k] - outs["f64"]).abs().max().item() / f64_scale
              for k in ("fused", "unfused", "bf16 fused", "bf16 unfused")}
    bf16_share = (outs["bf16 fused"] - outs["bf16 unfused"]).abs().max() \
        .item() / f64_scale
    if not share <= K5_UNET_RTOL_OF_MAX:
        fail(f"f32 forward with the fused blocks differs from the unfused "
             f"one by {share:.3e} of max|ref| (tol {K5_UNET_RTOL_OF_MAX})")
    if not bf16_share <= K5_UNET_BF16_FACTOR * vs_f64["bf16 unfused"]:
        fail(f"bf16 forward with the fused blocks differs from the unfused "
             f"one by {bf16_share:.3e} of max|f64 ref|, more than "
             f"{K5_UNET_BF16_FACTOR} x the unfused one's distance from f64 "
             f"({vs_f64['bf16 unfused']:.3e})")

    # the gradient: batch 16, train mode (dropout on), f32
    cfg = dataclasses.replace(cu.CONFIG, compute_dtype="float32",
                              fused_block=True)
    x0 = (torch.rand(16, 3, 32, 32, generator=gen) * 2 - 1).cuda()
    tt = torch.randint(0, cfg.timesteps, (16,), generator=gen).cuda()
    noise = torch.randn(16, 3, 32, 32, generator=gen).cuda()
    kernel = fb._kernel_fused_bwd
    sites = []

    def capture(*args, **kw):
        sites.append(tuple(a.detach().clone() if isinstance(a, torch.Tensor)
                           else a for a in args))
        return kernel(*args, **kw)

    def grad():
        leaves = cu.tree_map(lambda a: a.to("cuda").requires_grad_(),
                             params)
        step_gen = torch.Generator(device="cuda").manual_seed(11)
        loss = cu.loss_fn(leaves, x0, tt, noise, cfg, step_gen)
        flat = cu.tree_leaves(leaves)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        return loss.item(), [torch.zeros_like(p) if gr is None else
                             gr.double() for p, gr in zip(flat, grads)]

    fb._kernel_fused_bwd = capture
    try:
        _zero_fused_counts(fb)
        loss_k, grads_k = grad()
        torch.cuda.synchronize()
        counts = (*_fused_counts(fb), fb.bwd_tc_launch_count,
                  fb.wgrad_tc_launch_count)
        fma_launches += fb.launch_count - fb.tc_launch_count
        fma_bwd_launches = (fb.bwd_launch_count - fb.bwd_tc_launch_count,
                            fb.wgrad_launch_count - fb.wgrad_tc_launch_count)
        fb._kernel_fused_bwd = fb._plain_fused_bwd
        loss_p, grads_p = grad()
    finally:
        fb._kernel_fused_bwd = kernel
    per = FUSED_PER_TRAIN_STEP
    if counts != (per, per, per, 0, 0) or len(sites) != per:
        fail(f"the f32 train-mode gradient launched K5a/K5b's data "
             f"gradients/its weight gradients/each of those two on the "
             f"tensor cores {counts} times over {len(sites)} fused blocks, "
             f"expected {per}, {per}, {per}, 0, 0")
    if not all(torch.isfinite(gr).all() for gr in grads_k + grads_p):
        fail("non-finite gradient leaves")
    worst_site = 0.0
    for i, args in enumerate(sites):
        got = kernel(*args)
        want = fb._plain_fused_bwd(*args)
        for name, a, b in zip(("dx", "d_td", "dw1", "dw2", "dw3"), got,
                              want):
            if a is None:
                continue
            ratio = _k5_ratio(name, a, b)
            worst_site = max(worst_site, ratio)
            if not ratio <= 1.0:
                fail(f"fused block {i} of the f32 gradient, {name}: K5b err "
                     f"exceeds atol {K5_GRAD_ATOL} + rtol {K5_GRAD_RTOL}"
                     f"*|ref| by {ratio}x")
    leaves = _leaf_errors(grads_k, grads_p)

    # the bf16 gradient (the train step's compute dtype): K5b's data
    # gradients on the tensor-core route, each fused block's against the
    # plain backward on its operands
    del sites[:]
    cfg = dataclasses.replace(cu.CONFIG, compute_dtype="bfloat16",
                              fused_block=True)
    fb._kernel_fused_bwd = capture
    try:
        _zero_fused_counts(fb)
        loss_b = grad()[0]
        torch.cuda.synchronize()
        counts = (*_fused_counts(fb), fb.bwd_tc_launch_count,
                  fb.wgrad_tc_launch_count)
    finally:
        fb._kernel_fused_bwd = kernel
    if counts != (per,) * 5 or len(sites) != per or not math.isfinite(
            loss_b):
        fail(f"the bf16 train-mode gradient launched K5a/K5b's data "
             f"gradients/its weight gradients/each of those two on the "
             f"tensor cores {counts} times over {len(sites)} fused blocks, "
             f"expected {per} each; loss {loss_b}")
    worst_bf16 = dict.fromkeys(("dx", "d_td", "dw1", "dw2", "dw3"), 0.0)
    for i, args in enumerate(sites):
        got = kernel(*args)
        want = fb._plain_fused_bwd(*args)
        for name, a, b in zip(worst_bf16, got, want):
            if a is None:
                continue
            ratio = ((a.double() - b.double()).abs().max()
                     / b.double().abs().max()).item()
            worst_bf16[name] = max(worst_bf16[name], ratio)
            if not ratio <= K5_BF16_RTOL_OF_MAX:
                fail(f"fused block {i} of the bf16 gradient, {name}: K5b "
                     f"err / max|ref| {ratio:.3e} > {K5_BF16_RTOL_OF_MAX}")
    del sites[:]
    print(f"[14 fused oracle] full-width 32x32 f32 forward, t=500: with the "
          f"10 fused blocks vs unfused err/max|ref| {share:.3e} (tol "
          f"{K5_UNET_RTOL_OF_MAX}); reported, no bound: fused vs f64 "
          f"{vs_f64['fused']:.3e}, unfused vs f64 {vs_f64['unfused']:.3e} "
          f"of max|ref| {f64_scale:.3f}. bf16 forward with the 10 fused "
          f"blocks (tensor-core K5a) vs unfused {bf16_share:.3e} of max|f64 "
          f"ref| (tol {K5_UNET_BF16_FACTOR} x unfused vs f64 "
          f"{vs_f64['bf16 unfused']:.3e}); fused vs f64 "
          f"{vs_f64['bf16 fused']:.3e}. f32 train-mode gradient at batch "
          f"16, {per} fused blocks: K5b vs plain on each block's operands, "
          f"worst err/(atol {K5_GRAD_ATOL} + rtol {K5_GRAD_RTOL}*|ref|) "
          f"{worst_site:.3e} (tol 1); reported, no bound: the gradient "
          f"through K5b vs with the plain backward at the fused blocks, "
          f"worst leaf {leaves[0]:.3e} of its max|ref|, {leaves[1]:.3e} of "
          f"the largest max|ref|, median leaf {leaves[2]:.3e}; losses "
          f"{loss_k:.6f}, {loss_p:.6f}. bf16 train-mode gradient at batch "
          f"16 (loss {loss_b:.6f}), {per} fused blocks, every data-gradient "
          f"launch on the tensor-core route: K5b vs plain on each block's "
          f"operands, worst err/max|ref| "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst_bf16.items())
          + f" (tol {K5_BF16_RTOL_OF_MAX}; every K5b launch on the "
          f"tensor-core route)", flush=True)
    return fma_launches, fma_bwd_launches


def phase_unet_fused_train() -> dict:
    """``train 1 --fused-block --max-steps=30`` at 32x32 from phase 6's
    checkpoint (the CIFAR batches synthesized on first use), then a resumed
    ``--max-steps=1``; returns the launches during the first ``train``."""
    from big_linear_algebra_tpu_torch.models import cifar_unet as cu
    from big_linear_algebra_tpu_torch.nn import fused_block as fb

    losses = []
    real_step = cu.train_step

    def step(*a, **kw):
        params, opt_state, loss = real_step(*a, **kw)
        losses.append(loss)
        return params, opt_state, loss

    cu.train_step = step
    try:
        first = io.StringIO()
        _zero_fused_counts(fb)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(first):
            rc_train = cu.main(["train", "1", "--fused-block",
                                f"--max-steps={FUSED_TRAIN_STEPS}"])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        k5a, k5b, wgrad = _fused_counts(fb)
        tc, bwd_tc = fb.tc_launch_count, fb.bwd_tc_launch_count
        wgrad_tc = fb.wgrad_tc_launch_count
        second = io.StringIO()
        with contextlib.redirect_stdout(second):
            rc_resume = cu.main(["train", "1", "--fused-block",
                                 "--max-steps=1"])
    finally:
        cu.train_step = real_step
    text, text2 = first.getvalue(), second.getvalue()
    if (rc_train, rc_resume) != (0, 0):
        fail(f"cifar_unet train --fused-block exited {rc_train}/{rc_resume}:"
             f"\n{text}{text2}")
    vals = torch.stack(losses).float().cpu()
    if len(losses) != FUSED_TRAIN_STEPS + 1:
        fail(f"{len(losses)} train steps, expected {FUSED_TRAIN_STEPS} + 1")
    if not torch.isfinite(vals).all():
        fail(f"non-finite step losses: {vals.tolist()}")
    want = FUSED_PER_TRAIN_STEP * FUSED_TRAIN_STEPS
    got = (k5a, tc, k5b, bwd_tc, wgrad, wgrad_tc)
    if got != (want,) * 6:
        fail(f"train --fused-block launched K5a/its tensor-core route/K5b's "
             f"data gradients/their tensor-core route/K5b's weight "
             f"gradients/their tensor-core route {got} times in "
             f"{FUSED_TRAIN_STEPS} steps, expected {want} each "
             f"({FUSED_PER_TRAIN_STEP} per step)")
    head = vals[:10].mean().item()
    tail = vals[FUSED_TRAIN_STEPS - 10:FUSED_TRAIN_STEPS].mean().item()
    if not tail < head:
        fail(f"the loss did not fall: mean of steps 1-10 {head}, of steps "
             f"{FUSED_TRAIN_STEPS - 9}-{FUSED_TRAIN_STEPS} {tail}")
    resumed = f"resumed train state at step {FUSED_TRAIN_STEPS} (epoch 1)"
    if resumed not in text2:
        fail(f"the second train did not resume at epoch 1:\n{text2}")
    ep0 = _epoch_line(text, 0)
    print(f"[15 unet fused train] train 1 --fused-block --max-steps="
          f"{FUSED_TRAIN_STEPS} (32x32, full width, batch 16, bf16 compute, "
          f"f32 masters, Adam) {train_s:.2f} s wall with the CIFAR "
          f"synthesis, epoch {ep0['epoch_seconds']} s "
          f"({ep0['images_per_sec']} images/s): launches K5a {k5a} (all on "
          f"the tensor-core route), K5b's data gradients {k5b} (all on the "
          f"tensor-core route), K5b's weight gradients {wgrad} (all on "
          f"the tensor-core route); loss mean "
          f"of steps 1-10 "
          f"{head:.5f}, of steps {FUSED_TRAIN_STEPS - 9}-{FUSED_TRAIN_STEPS} "
          f"{tail:.5f}; then '{resumed}', step loss "
          f"{vals[-1].item():.5f}", flush=True)
    return {"K5a": k5a, "K5b": k5b, "wgrad": wgrad}


def phase_fused_step_profile(params, n_steps: int = 3) -> dict:
    """One bf16 train step at batch 16, 32x32, full width, with the fused
    blocks (phase 15's configuration, Adam, dropout on): host wall time
    per step, and a ``torch.profiler`` trace of ``n_steps`` steps: the
    card's busy share and K5b's two kernels' share of the device time, with
    K5b on its route and forced onto the FMA route (its data-gradient
    kernel, which the weight gradients follow), in turns (route, FMA, FMA,
    route; the lower host time of each kept).
    Returns {mode: (host ms, busy ms, K5b ms)} per step."""
    import dataclasses
    import functools

    from big_linear_algebra_tpu_torch.models import cifar_unet as cu
    from big_linear_algebra_tpu_torch.nn import fused_block as fb

    cfg = dataclasses.replace(cu.CONFIG, fused_block=True)
    state = {"p": cu.tree_map(lambda a: a.to("cuda"), params)}
    state["opt"] = cu.adam_init(state["p"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand(cfg.batch_size, 3, cfg.image_size, cfg.image_size,
                   generator=gen, device="cuda") * 2 - 1

    def step():
        state["p"], state["opt"], _ = cu.train_step(
            state["p"], state["opt"], x, gen, cfg)

    real = fb._kernel_bwd_data
    runs = {"route": [], "fma": []}
    for mode in ("route", "fma", "fma", "route"):
        if mode == "fma":
            fb._kernel_bwd_data = functools.partial(real, route="fma")
        try:
            host, busy, summary, per = _host_and_trace(step, n_steps)
        finally:
            fb._kernel_bwd_data = real
        k5b = sum(us for name, us in per.items()
                  if re.search(r"fused_block_(bwd|wgrad)", name)) / 1e3
        k5a = sum(us for name, us in per.items()
                  if re.search(r"fused_block_fwd", name)) / 1e3
        runs[mode].append((host, busy, k5b, k5a, summary))
    out = {}
    for mode, got in runs.items():
        host, busy, k5b, k5a, summary = min(got, key=lambda r: r[0])
        out[mode] = (host, busy, k5b)
        what = ("on its route" if mode == "route" else
                "forced onto the FMA route")
        print(f"[15 fused step profile] one bf16 train step, batch 16, "
              f"32x32, --fused-block, K5b {what}: host "
              f"wall {host:.3f} ms per step (synchronised, no profiler; the "
              f"lower of two turns: {got[0][0]:.3f}, {got[1][0]:.3f}); "
              f"device busy {busy:.3f} ms per step = {busy / host:.1%} of "
              f"it; K5b's kernels {k5b:.3f} ms = {k5b / busy:.1%} of the "
              f"device time, K5a {k5a:.3f} ms; trace of {n_steps} steps "
              f"(trace_summary.py):\n    "
              + summary.replace("\n", "\n    "), flush=True)
    return out


def _k4_inputs(b, c, h, w, f, k, dtype, gen):
    """x ~ N(0, 1) (B, C, H, W), He-normal kernels (F, C, k, k) and a
    cotangent g ~ N(0, 1) (B, F, H, W), made on the CPU from ``gen``, on the
    card."""
    x = torch.randn(b, c, h, w, generator=gen)
    kr = torch.randn(f, c, k, k, generator=gen) * (2.0 / (k * k * c)) ** 0.5
    g = torch.randn(b, f, h, w, generator=gen)
    return tuple(a.to("cuda", dtype) for a in (x, kr, g))


def _odd_view(t):
    """A copy of ``t`` as a view one element past an aligned buffer (not
    16-byte aligned)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:].copy_(t.flatten())
    return buf[1:].view(t.shape)


def _conv_grads(fn, x, kr, g):
    """(out, dx, dk) of ``fn(x, kr)`` through autograd on the card."""
    xs = [x.detach().clone().requires_grad_(),
          kr.detach().clone().requires_grad_()]
    out = fn(*xs)
    return (out.detach(), *torch.autograd.grad(out, xs, g))


def phase_k4_vs_plain() -> float:
    """K4 through ``conv2d_implicit`` and ``conv2d_packed`` (forward and
    dx, two launches each) against the plain tap sum on every case; returns
    the worst f32 abs error."""
    from big_linear_algebra_tpu_torch.nn import conv_implicit as ci

    gen = torch.Generator().manual_seed(15)
    worst_abs = 0.0
    # f32: err / bound; bf16: err / max|ref| / tol
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    bad = []
    n_cases = 0
    for b, c, h, w, f, k in K4_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x, kr, g = _k4_inputs(b, c, h, w, f, k, dtype, gen)
            k_t = torch.flip(kr, dims=(-2, -1)).transpose(0, 1)
            want = (ci._plain_conv(x, kr), ci._plain_conv(g, k_t))
            for name, counter in (("conv2d_implicit", "implicit_launch_count"),
                                  ("conv2d_packed", "packed_launch_count")):
                before = getattr(ci, counter)
                out, dx, _ = _conv_grads(getattr(ci, name), x, kr, g)
                torch.cuda.synchronize()
                launched = getattr(ci, counter) - before
                case = (f"{name} {str(dtype)[6:]} B={b} C={c} {h}x{w} F={f} "
                        f"k={k}")
                if launched != 2:
                    bad.append(f"{case}: K4 launched {launched} times, "
                               "expected 2 (forward, dx)")
                    continue
                for what, got, ref, a, bb, kk in (
                        ("out", out, want[0], x, kr, c * k * k),
                        ("dx", dx, want[1], g, kr, f * k * k)):
                    if got.shape != ref.shape or got.dtype != dtype:
                        bad.append(f"{case} {what}: {tuple(got.shape)} "
                                   f"{got.dtype}, expected "
                                   f"{tuple(ref.shape)} {dtype}")
                        continue
                    err = (got.float() - ref.float()).abs().max().item()
                    if dtype == torch.float32:
                        ratio = err / f32_bound(a, bb, kk)
                        worst_abs = max(worst_abs, err)
                    else:
                        ratio = (err / ref.float().abs().max().item()
                                 / BF16_RTOL_OF_MAX)
                    worst[dtype] = max(worst[dtype], ratio)
                    if not ratio <= 1.0:
                        bad.append(f"{case} {what}: err {err} exceeds its "
                                   f"tolerance by {ratio}x")
                n_cases += 1
    for b, c, h, w, f, k in K4_ODD_VIEWS:
        x, kr, g = (_odd_view(a) for a in _k4_inputs(b, c, h, w, f, k,
                                                      torch.bfloat16, gen))
        k_t = torch.flip(kr, dims=(-2, -1)).transpose(0, 1)
        want = (ci._plain_conv(x, kr), ci._plain_conv(g, k_t))
        before = ci.implicit_launch_count
        out, dx, _ = _conv_grads(ci.conv2d_implicit, x, kr, g)
        torch.cuda.synchronize()
        case = f"bf16 views at +1 element B={b} C={c} {h}x{w} F={f} k={k}"
        if ci.implicit_launch_count - before != 2:
            bad.append(f"{case}: K4 launched "
                       f"{ci.implicit_launch_count - before} times")
        for what, got, ref in (("out", out, want[0]), ("dx", dx, want[1])):
            ratio = ((got.float() - ref.float()).abs().max().item()
                     / ref.float().abs().max().item() / BF16_RTOL_OF_MAX)
            worst[torch.bfloat16] = max(worst[torch.bfloat16], ratio)
            if not ratio <= 1.0:
                bad.append(f"{case} {what}: err exceeds its tolerance by "
                           f"{ratio}x")
        n_cases += 1
    if bad:
        fail(f"{len(bad)} K4 outputs disagree with the plain version:\n  "
             + "\n  ".join(bad))
    print(f"[16 K4 vs plain] {n_cases} cases pass (conv2d_implicit and "
          f"conv2d_packed x f32/bf16 x (B, C, H, W, F, k) {K4_SHAPES}; "
          f"forward and dx; and conv2d_implicit on bf16 views one element "
          f"past an aligned buffer at {K4_ODD_VIEWS}): worst f32 err/bound "
          f"{worst[torch.float32]:.3f} "
          f"(bound {F32_ULPS}*K*max|a|*max|b|*2^-24, K = C*k^2 or F*k^2), "
          f"worst bf16 err/max|ref| "
          f"{worst[torch.bfloat16] * BF16_RTOL_OF_MAX:.3e} (tol "
          f"{BF16_RTOL_OF_MAX}); worst f32 abs err {worst_abs:.3e}",
          flush=True)
    return worst_abs


def k4_bound_ms(b, c, h, w, f, k, dtype):
    """The JAX kernel's cost estimate (nn/conv_implicit.py:100-104):
    2·B·F·H·W·C·k² flops at the dtype's peak, and x, the taps and the
    output moved once in the dtype, whichever takes longer."""
    item = torch.finfo(dtype).bits // 8
    nbytes = (b * c * h * w + k * k * c * f + b * f * h * w) * item
    return _bound(nbytes, 2 * b * f * h * w * c * k * k / PEAK_FLOPS[dtype])


def _k4_plan(dtype, b, c, h, w, f, k) -> dict:
    """K4's tile rule at a shape for an input type (``bla_conv_plan``)."""
    from big_linear_algebra_tpu_torch.ops import cuda_utils

    fn = cuda_utils.load_library("conv_implicit").bla_conv_plan
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
    out = (ctypes.c_int * 9)()
    if fn(int(dtype == torch.bfloat16), b, c, h, w, f, k, out) != 0:
        fail(f"K4 has no tile for (B, C, H, W, F, k) = {(b, c, h, w, f, k)}")
    return dict(zip(("examples", "rows", "cols", "splits", "grid_x",
                     "grid_y", "fast", "smem", "blocks"), out))


def phase_k4_build_info() -> None:
    """K4's kernels, bf16 on the tensor cores (conv_tc: 16-byte or element
    staging) and f32 on the CUDA cores (conv_f32: with or without the row
    reuse), each for f32 and bf16 output: registers, shared memory and
    spills from the build's ``-Xptxas -v``, blocks per SM from the
    occupancy API at the U-Net's 32x32 (the fast forms) and 4x4 maps, and
    the HMMA instructions in their SASS. Fails on a spill, or on a bf16
    kernel without tensor-core instructions."""
    stats = _kernel_stats(
        "conv_implicit",
        re.compile(r"conv_(tc|f32)I(f|13__nv_bfloat16)Lb([01])E"))
    bad, parts = [], []
    for kern, dtype in (("tc", torch.bfloat16), ("f32", torch.float32)):
        blocks = {"1": _k4_plan(dtype, *K4_SHAPES[0])["blocks"],
                  "0": _k4_plan(dtype, *K4_SHAPES[3])["blocks"]}
        for out in ("13__nv_bfloat16", "f"):
            for fast in ("1", "0"):
                st = stats.get((kern, out, fast), {})
                st["blocks"] = blocks[fast]
                form = ({"1": "16-byte staging", "0": "element staging"}
                        if kern == "tc" else
                        {"1": "row reuse", "0": "per-tap loads"})[fast]
                name = (f"conv_{kern}<{'f32' if out == 'f' else 'bf16'} "
                        f"out, {form}>")
                why = _check_stats(name, st, kern == "tc")
                if why:
                    bad.append(why)
                    continue
                parts.append(f"{name} {st['regs']} regs, {st['spill']} B "
                             f"spill, {st['blocks']} blocks/SM"
                             + (f", {st['mma']} HMMA" if kern == "tc" else ""))
    if bad:
        fail("K4 (spill, no HMMA or no block fits):\n  " + "\n  ".join(bad))
    print("[17 K4 build] 256 threads, 64 output channels x 256 positions a "
          "block, dynamic shared memory (-Xptxas -v, cudaOccupancy, cuobjdump "
          "-sass): " + "; ".join(parts), flush=True)


def phase_k4_timing() -> dict:
    """K4 (through ``conv2d_implicit``'s wrapper), the plain tap sum and
    ``F.conv2d`` (cuDNN, TF32 off for f32) as the library call, at the
    U-Net's 32x32 and 16x16 maps in bf16 and f32, in turns within this one
    process; the lower of each pair is kept; two K4 runs at each must be
    bit-equal. Returns the bf16 32x32 numbers."""
    import torch.nn.functional as F

    from big_linear_algebra_tpu_torch.nn import conv_implicit as ci

    gen = torch.Generator().manual_seed(16)
    names = ("K4", "plain", "F.conv2d")
    main = {}
    for b, c, h, w, f, k in K4_TIMED:
        for dtype in (torch.bfloat16, torch.float32):
            x, kr, _ = _k4_inputs(b, c, h, w, f, k, dtype, gen)
            first, second = ci._kernel_implicit(x, kr), ci._kernel_implicit(x,
                                                                          kr)
            torch.cuda.synchronize()
            if not torch.equal(first, second):
                fail(f"two {str(dtype)[6:]} K4 runs at (B, C, H, W, F, k) = "
                     f"{(b, c, h, w, f, k)} differ")
            fns = {"K4": lambda: ci._kernel_implicit(x, kr),
                   "plain": lambda: ci._plain_conv(x, kr),
                   "F.conv2d": lambda: F.conv2d(x, kr, padding=k // 2)}
            runs = {name: [] for name in names}
            for name in names + names[::-1]:
                runs[name].append(_time_ms(fns[name], iters=20, warmup=3))
            ms = {name: min(d for d, _ in runs[name]) for name in names}
            bound, bound_by = k4_bound_ms(b, c, h, w, f, k, dtype)
            flops = 2 * b * f * h * w * c * k * k
            plan = _k4_plan(dtype, b, c, h, w, f, k)
            tile = (f"tile {plan['examples']} x {plan['rows']} x "
                    f"{plan['cols']}, {plan['splits']} splits, grid "
                    f"{plan['grid_x']} x {plan['grid_y']}")
            print(f"[17 K4 timing] {str(dtype)[6:]} B={b} C={c} {h}x{w} F={f} "
                  f"k={k}: device K4 {ms['K4'] * 1e3:.2f} us "
                  f"({flops / (ms['K4'] * 1e-3) / 1e12:.2f} TFLOP/s; {tile}; "
                  f"two runs bit-equal), plain {ms['plain'] * 1e3:.2f} us, "
                  f"F.conv2d {ms['F.conv2d'] * 1e3:.2f} us; bound "
                  f"{bound * 1e3:.3f} us ({bound_by}; {flops} flops)",
                  flush=True)
            if (b, c, h, w, f, k) == K4_TIMED[0] and dtype == torch.bfloat16:
                main = dict(ms, bound=bound, bound_by=bound_by)
    return main


def phase_k4_unet_sites() -> dict:
    """From phase 6's checkpoint at 32x32: the activations and kernels of
    every stride-1 3x3 conv site of one f32 forward at batch 16 (random t,
    dropout off). At each site, with K4's counts set to 0 before the sites
    and read after them (against what the gates admit): ``conv2d_implicit``
    and ``conv2d_packed`` forward and backward on a N(0, 1) cotangent,
    bounded against the port's ``conv2d`` (cuDNN) evaluated in f64 on the
    same f32 operands (the f32 bound, K = C*9 for the output, F*9 for dx,
    B*H*W for dk); the f32 ``conv2d`` (TF32 off) is reported beside it.
    Then K4's forward at every site, f32 and bf16, timed beside
    ``F.conv2d`` and summed over the sites (device time). Then
    ``conv2d_im2col`` forward and backward at the first 32x32 site whose
    input and output channels match (128 at full width), bounded the same
    way, with K1's launches and variants.
    Returns {"K4": launches, "K1": launches}."""
    import dataclasses

    import torch.nn.functional as F

    from big_linear_algebra_tpu_torch.models import cifar_unet as cu
    from big_linear_algebra_tpu_torch.nn import conv_implicit as ci
    from big_linear_algebra_tpu_torch.nn import conv_pallas as cp
    from big_linear_algebra_tpu_torch.nn.conv import conv2d
    from big_linear_algebra_tpu_torch.ops import matmul as mm

    cfg = dataclasses.replace(cu.CONFIG, compute_dtype="float32")
    params = cu.tree_map(lambda a: a.to("cuda", torch.float32),
                         cu.load_params_csv(cu.CONFIG))
    gen = torch.Generator().manual_seed(17)
    x0 = (torch.rand(16, 3, 32, 32, generator=gen) * 2 - 1).cuda()
    tt = torch.randint(0, cfg.timesteps, (16,), generator=gen).cuda()
    sites = []
    real = cu.conv2d

    def capture(h, w, stride):
        if stride == 1 and tuple(w.shape[-2:]) == (3, 3):
            sites.append((h.detach().clone(), w.detach()))
        return real(h, w, stride)

    cu.conv2d = capture
    try:
        with torch.no_grad():
            cu.forward(params, x0, tt, cfg)
    finally:
        cu.conv2d = real
    del params
    expect = {"implicit": 0, "packed": 0}
    for h, w in sites:
        g_shape = (h.shape[0], w.shape[0], *h.shape[2:])
        t_shape = (w.shape[1], w.shape[0], *w.shape[2:])
        for name, gate in (("implicit", ci.supported),
                           ("packed", ci.packed_supported)):
            expect[name] += (int(gate(h.shape, w.shape, 1))
                             + int(gate(g_shape, t_shape, 1)))

    def reference(h, w, g):
        """conv2d's (out, dx, dk) in f64 and in f32 on the same operands."""
        return [_conv_grads(lambda a, b: conv2d(a, b, 1), h.to(dt), w.to(dt),
                            g.to(dt)) for dt in (torch.float64, torch.float32)]

    def ratios(got, h, w, g, ref):
        """err / bound of (out, dx, dk) against ``ref``."""
        b, c, hh, ww = h.shape
        f = w.shape[0]
        bounds = (f32_bound(h, w, c * 9), f32_bound(g, w, f * 9),
                  f32_bound(h, g, b * hh * ww))
        return [(x.double() - y.double()).abs().max().item() / bnd
                for x, y, bnd in zip(got, ref, bounds)]

    worst = {"K4": 0.0, "conv2d f32": 0.0, "im2col": 0.0}
    ci.implicit_launch_count = ci.packed_launch_count = 0
    for i, (h, w) in enumerate(sites):
        g = torch.randn(h.shape[0], w.shape[0], *h.shape[2:],
                        generator=gen).cuda()
        ref64, ref32 = reference(h, w, g)
        worst["conv2d f32"] = max(worst["conv2d f32"],
                                  *ratios(ref32, h, w, g, ref64))
        for fn in (ci.conv2d_implicit, ci.conv2d_packed):
            got = _conv_grads(fn, h, w, g)
            r = ratios(got, h, w, g, ref64)
            worst["K4"] = max(worst["K4"], *r)
            if not max(r) <= 1.0:
                fail(f"U-Net conv site {i} (x {tuple(h.shape)}, kernels "
                     f"{tuple(w.shape)}), {fn.__name__}: out/dx/dk err / "
                     f"bound {r}")
    torch.cuda.synchronize()
    launches = {"implicit": ci.implicit_launch_count,
                "packed": ci.packed_launch_count}
    if launches != expect or not all(launches.values()):
        fail(f"K4 launched {launches} times over {len(sites)} conv sites, "
             f"expected {expect} (forward and dx where the gates admit)")

    # K4's main path in one number: its forward summed over the sites
    summed = {}
    for dtype in (torch.float32, torch.bfloat16):
        summed[dtype] = {"K4": 0.0, "F.conv2d": 0.0}
        for h, w in sites:
            hx, wx = h.to(dtype), w.to(dtype)
            for name, fn in (
                    ("K4", lambda: ci._kernel_implicit(hx, wx)),
                    ("F.conv2d", lambda: F.conv2d(hx, wx, padding=1))):
                summed[dtype][name] += _time_ms(fn, iters=10, warmup=2)[0]

    h, w = next((h, w) for h, w in sites
                if h.shape[1] == w.shape[0] and h.shape[-1] == 32)
    g = torch.randn(h.shape[0], w.shape[0], *h.shape[2:],
                    generator=gen).cuda()
    variants = []
    real_mm = mm._kernel_mm

    def record(a, b, variant, *rest):
        variants.append(variant)
        return real_mm(a, b, variant, *rest)

    mm._kernel_mm = record
    mm.launch_count = 0
    try:
        got = _conv_grads(lambda a, b: cp.conv2d_im2col(a, b, 1), h, w, g)
        torch.cuda.synchronize()
    finally:
        mm._kernel_mm = real_mm
    k1 = mm.launch_count
    if k1 != 3 or variants != ["nn", "tn", "nt"]:
        fail(f"conv2d_im2col launched K1 {k1} times ({variants}), expected "
             "3 (nn, tn, nt)")
    r = ratios(got, h, w, g, reference(h, w, g)[0])
    worst["im2col"] = max(r)
    if not max(r) <= 1.0:
        fail(f"conv2d_im2col at x {tuple(h.shape)}: out/dx/dk err / bound "
             f"{r}")
    shapes = sorted({(tuple(h.shape[1:]), w.shape[0]) for h, w in sites})
    print(f"[18 K4 unet sites] {len(sites)} stride-1 3x3 conv sites of an "
          f"f32 full-width 32x32 forward at batch 16 ((C, H, W), F: "
          f"{shapes}): K4 launches conv2d_implicit {launches['implicit']}, "
          f"conv2d_packed {launches['packed']} (as the gates admit); "
          f"forward, dx and dk of both against conv2d in f64, worst err/"
          f"bound {worst['K4']:.3e} (tol 1; the f32 bound, K = C*9, F*9, "
          f"B*H*W); reported, no bound: conv2d in f32 (cuDNN, TF32 off) vs "
          f"f64, worst err/bound {worst['conv2d f32']:.3e}. conv2d_im2col at "
          f"x {tuple(h.shape)}, kernels {tuple(w.shape)}: K1 launches {k1} "
          f"({', '.join(variants)}), worst err/bound vs conv2d in f64 "
          f"{worst['im2col']:.3e} (tol 1). K4's forward (conv2d_implicit's "
          f"wrapper) summed over the {len(sites)} sites, device time: "
          + ", ".join(f"{str(dt)[6:]} {t['K4'] * 1e3:.2f} us (F.conv2d "
                      f"{t['F.conv2d'] * 1e3:.2f} us)"
                      for dt, t in summed.items()), flush=True)
    return {"K4": launches["implicit"] + launches["packed"], "K1": k1}


def _k3_counts(at) -> tuple:
    """Launches of (K2, K3a, K2c, K2d)."""
    return (at.launch_count, at.bwd_fused_launch_count,
            at.bwd_dq_launch_count, at.bwd_dkv_launch_count)


def _zero_k3_counts(at) -> None:
    at.launch_count = at.bwd_fused_launch_count = 0
    at.bwd_dq_launch_count = at.bwd_dkv_launch_count = 0


def _flash_grads(at, q, k, v, g, block_q=512, block_k=1024):
    """(dq, dk, dv) of ``flash_attention(q, k, v, block_q, block_k,
    stream=False)`` through autograd on the card."""
    xs = [a.detach().clone().requires_grad_() for a in (q, k, v)]
    out = at.flash_attention(*xs, block_q, block_k, False)
    return torch.autograd.grad(out, xs, g)


def _k3_ratio(got, want) -> float:
    """err / tolerance of one gradient against ``want`` at phase 8's
    tolerances (f32: elementwise atol + rtol*|ref|; bf16: of max|ref|)."""
    diff = (got.float() - want.float()).abs()
    if got.dtype == torch.float32:
        return (diff / (K2BWD_F32_ATOL + K2BWD_F32_RTOL
                        * want.float().abs())).max().item()
    return (diff.max().item() / want.float().abs().max().item()
            / K2BWD_BF16_RTOL_OF_MAX)


def _with_budget(at, budget, fn):
    """``fn()`` with the fused backward's budget set to ``budget``."""
    saved = at._BWD_FUSED_VMEM_BUDGET
    at._BWD_FUSED_VMEM_BUDGET = budget
    try:
        return fn()
    finally:
        at._BWD_FUSED_VMEM_BUDGET = saved


def _plain_flash_bwd_f64_sums(at, q, k, v, o, lse, g):
    """``_plain_flash_bwd``'s (dq, dk, dv) with its roundings (q^, p and ds
    to the input type, delta in f32) and every sum in f64, unrounded."""
    import math

    d = q.shape[-1]
    g, lse2, delta = at._bwd_prepare(g, o, lse, q.dtype)
    qa, ka, va, ga = (x.double() for x in (q, k, v, g))
    qs = (q.float() * at._qscale(d)).to(q.dtype).double()
    p = torch.exp2(qs @ ka.transpose(-1, -2) - lse2.double()[..., None])
    dp = ga @ va.transpose(-1, -2)
    ds = (p * (dp - delta.double()[..., None])).to(q.dtype).double()
    dv = p.to(q.dtype).double().transpose(-1, -2) @ ga
    return ((ds @ ka) / math.sqrt(d), (ds.transpose(-1, -2) @ qa)
            / math.sqrt(d), dv)


def phase_k3_vs_plain() -> dict:
    """``flash_attention(..., stream=False)`` through autograd against
    ``_plain_flash_bwd`` on every case, on the fused route (K3a) and with
    the budget at 0 on the two-pass route (K2c/K2d standing for the TPU's
    K3b/K3c), each call's launches checked; two K3a runs bit-equal; K3a
    alone against the plain backward at more than one cluster of keys
    (K3_CLUSTER_SHAPES), two runs bit-equal; a bf16 case at |s| ~ 1e5
    finite, equal to K2c + K2d within the bf16 tolerance, and its dv
    within it of the plain backward with f64 sums. Returns the worst abs
    errors ({"K3a": .., "K3bc": ..})."""
    from big_linear_algebra_tpu_torch.nn import attention as at
    from big_linear_algebra_tpu_torch.ops import cuda_utils

    gen = torch.Generator().manual_seed(13)
    worst_abs = {"K3a": 0.0, "K3bc": 0.0}
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    bad = []
    n_cases = 0
    routes = (("fused", "K3a", at._BWD_FUSED_VMEM_BUDGET, (1, 1, 0, 0)),
              ("two_pass", "K3bc", 0, (1, 0, 1, 1)))
    for dtype in (torch.float32, torch.bfloat16):
        for d in (16, 64):
            for b, n in K3_SHAPES:
                for bq, bk in K3_BLOCKS:
                    q, k, v, o, lse, g = _k2bwd_inputs(b, n, d, dtype, gen)
                    want = at._plain_flash_bwd(q, k, v, o, lse, g)
                    case = (f"{str(dtype)[6:]} B={b} N={n} d={d} blocks "
                            f"({bq}, {bk})")
                    for route, kern, budget, expect in routes:
                        def run():
                            _zero_k3_counts(at)
                            grads = _flash_grads(at, q, k, v, g, bq, bk)
                            torch.cuda.synchronize()
                            return (at._bwd_route(q.shape, dtype, bq, bk,
                                                  False), grads,
                                    _k3_counts(at))
                        got_route, got, counts = _with_budget(at, budget, run)
                        if got_route != route or counts != expect:
                            bad.append(f"{case}: route {got_route}, launches "
                                       f"K2/K3a/K2c/K2d {counts}, expected "
                                       f"{route}, {expect}")
                            continue
                        for name, x, y in zip(("dq", "dk", "dv"), got, want):
                            if x.shape != y.shape or x.dtype != y.dtype:
                                bad.append(f"{case} {route} {name}: "
                                           f"{tuple(x.shape)} {x.dtype}")
                                continue
                            worst_abs[kern] = max(
                                worst_abs[kern],
                                (x.float() - y.float()).abs().max().item())
                            ratio = _k3_ratio(x, y)
                            worst[dtype] = max(worst[dtype], ratio)
                            if not ratio <= 1.0:
                                bad.append(f"{case} {route} {name}: err "
                                           f"exceeds its tolerance by "
                                           f"{ratio}x")
                    n_cases += 1
    equal = []
    for dtype in (torch.float32, torch.bfloat16):
        ops = at._kernel_bwd_operands(*_k2bwd_inputs(*K3_MAIN, dtype, gen))
        first = at._kernel_bwd_fused(*ops)
        second = at._kernel_bwd_fused(*ops)
        torch.cuda.synchronize()
        equal.append(all(torch.equal(a, b) for a, b in zip(first, second)))
        if not equal[-1]:
            bad.append(f"{str(dtype)[6:]} {K3_MAIN}: two K3a runs differ")
    q, k, v, g = (torch.randn(2, 256, 16, generator=gen) for _ in range(4))
    q, k, v, g = (a.to("cuda", torch.bfloat16) for a in
                  (q * K3_LARGE_SCALE, k * K3_LARGE_SCALE, v, g))
    o, lse = at._kernel_flash(q, k, v)
    got = at._kernel_flash_bwd_fused(q, k, v, o, lse, g)
    two_pass = at._kernel_flash_bwd(q, k, v, o, lse, g)
    want = at._plain_flash_bwd(q, k, v, o, lse, g)
    exact = _plain_flash_bwd_f64_sums(at, q, k, v, o, lse, g)
    max_s = _score_overshoot(at, q, k, lse)[0]
    # held: against K2c + K2d (dq, dk, dv), and dv against the f64 sums
    vs_pair = [_k3_ratio(x, y) for x, y in zip(got, two_pass)]
    dv_exact = ((got[2].double() - exact[2]).abs().max().item()
                / exact[2].abs().max().item() / K2BWD_BF16_RTOL_OF_MAX)
    for name, ratio in (*zip(("dq", "dk", "dv"), vs_pair),
                        ("dv (f64 sums)", dv_exact)):
        if not ratio <= 1.0:
            bad.append(f"bf16 at max|s| {max_s:.4g}, {name}: K3a err "
                       f"exceeds its tolerance by {ratio}x")
    # reported: each version's err/max|ref| against the f64 sums, and the
    # ratio against the plain f32 version
    large_errs = []
    for name, *xs, z in zip(("dq", "dk", "dv"), got, two_pass, want, exact):
        scale = z.abs().max().item()
        large_errs.append((name, *((x.double() - z).abs().max().item()
                                   / scale for x in xs)))
    large = max(_k3_ratio(x, y) for x, y in zip(got, want))
    if not all(bool(torch.isfinite(x).all()) for x in got):
        bad.append(f"bf16 at max|s| {max_s:.4g}: K3a finite "
                   f"{[bool(torch.isfinite(x).all()) for x in got]}")
    slots = cuda_utils.load_library(
        "flash_attn_bwd_fused").bla_flash_bwd_fused_slots
    slots.restype = ctypes.c_int
    slots.argtypes = [ctypes.c_int] * 3
    cluster_worst, cluster_slots = 0.0, set()
    for b, n in K3_CLUSTER_SHAPES:
        for d in (16, 32, 64, 128):
            args = _k2bwd_inputs(b, n, d, torch.bfloat16, gen)
            first = at._kernel_flash_bwd_fused(*args)
            second = at._kernel_flash_bwd_fused(*args)
            torch.cuda.synchronize()
            want = at._plain_flash_bwd(*args)
            case = f"bf16 B={b} N={n} d={d}"
            cluster_slots.add(slots(1, n, d))
            if not all(torch.equal(x, y) for x, y in zip(first, second)):
                bad.append(f"{case}: two K3a runs differ")
            for name, x, y in zip(("dq", "dk", "dv"), first, want):
                ratio = _k3_ratio(x, y)
                cluster_worst = max(cluster_worst, ratio)
                if not ratio <= 1.0:
                    bad.append(f"{case} {name}: K3a err exceeds its "
                               f"tolerance by {ratio}x")
            del args, first, second, want
    if bad:
        fail(f"{len(bad)} K3 checks failed:\n  " + "\n  ".join(bad))
    print(f"[19 K3 vs plain] {n_cases} cases pass through flash_attention("
          f"..., stream=False) (f32/bf16 x d 16, 64 x (B, N) {K3_SHAPES} x "
          f"blocks {K3_BLOCKS}), each on the fused route (K3a, 1 launch) and "
          f"with the budget at 0 on the two-pass route (K2c + K2d): dq, dk, "
          f"dv worst f32 err/(atol {K2BWD_F32_ATOL} + rtol {K2BWD_F32_RTOL}"
          f"*|ref|) {worst[torch.float32]:.3f}, worst bf16 err/max|ref| "
          f"{worst[torch.bfloat16] * K2BWD_BF16_RTOL_OF_MAX:.3e} (tol "
          f"{K2BWD_BF16_RTOL_OF_MAX}); worst abs err K3a "
          f"{worst_abs['K3a']:.3e}, two-pass {worst_abs['K3bc']:.3e}. Two "
          f"K3a runs at {K3_MAIN} bit-equal (f32, bf16): {equal}. K3a alone "
          f"at bf16 (B, N) {K3_CLUSTER_SHAPES} x d 16, 32, 64, 128 (dq "
          f"workspace slots {sorted(cluster_slots)}): worst err/max|ref| "
          f"{cluster_worst * K2BWD_BF16_RTOL_OF_MAX:.3e}, two runs "
          f"bit-equal. bf16 at max|s| {max_s:.4g} (log2 units): finite; "
          f"err/max|ref| against K2c + K2d dq, dk, dv "
          + ", ".join(f"{r * K2BWD_BF16_RTOL_OF_MAX:.3e}" for r in vs_pair)
          + f", dv against the f64 sums "
          f"{dv_exact * K2BWD_BF16_RTOL_OF_MAX:.3e} (tol "
          f"{K2BWD_BF16_RTOL_OF_MAX}); reported, err/max|ref| against the "
          f"f64 sums, K3a / K2c + K2d / the plain f32 version: "
          + ", ".join(f"{n} {a:.3e} / {b:.3e} / {c:.3e}"
                      for n, a, b, c in large_errs)
          + f"; K3a against the plain f32 version: err/tol {large:.3e}",
          flush=True)
    return worst_abs


def k3_bound_ms(b: int, n: int, d: int, dtype, exp2_per_s: float):
    """K3a: q, k, v, g read once (input dtype), lse2 and delta (f32) read
    once, dq, dk and dv written once; 10·B·N²·d flops (five products) at
    the dtype's peak and B·N² exp2 at the card's exp2 rate, whichever takes
    longer. The workspace is the kernel's own traffic, not the function's."""
    item = torch.finfo(dtype).bits // 8
    nbytes = 7 * b * n * d * item + 2 * 4 * b * n
    ops_s = max(10 * b * n * n * d / PEAK_FLOPS[dtype],
                b * n * n / exp2_per_s)
    return _bound(nbytes, ops_s)


def phase_k3_build_info() -> None:
    """K3a's bf16 tensor-core kernels (d 16..128): registers, shared memory
    and spills from the build's ``-Xptxas -v``, blocks per SM and the
    cluster size limit from the occupancy API, and the HMMA instructions in
    their SASS. Fails on a spill or on a kernel without tensor-core
    instructions."""
    from big_linear_algebra_tpu_torch.ops import cuda_utils

    stats = _kernel_stats("flash_attn_bwd_fused",
                          re.compile(r"flash_bwd_fused_tcILi(\d+)E"))
    fn = cuda_utils.load_library(
        "flash_attn_bwd_fused").bla_flash_bwd_fused_tc_blocks_per_sm
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    bad, parts = [], []
    for d in (16, 32, 64, 128):
        cluster = ctypes.c_int(0)
        st = stats.get((str(d),), {})
        st["blocks"] = fn(d, ctypes.byref(cluster))
        why = _check_stats(f"flash_bwd_fused_tc<{d}>", st, True)
        if why:
            bad.append(why)
            continue
        parts.append(f"d={d} {st['regs']} regs, {st['spill']} B spill, "
                     f"{st['blocks']} blocks/SM, clusters of up to "
                     f"{cluster.value}, {st['mma']} HMMA")
    if bad:
        fail("tensor-core K3a (spill, no HMMA or no block fits):\n  "
             + "\n  ".join(bad))
    print("[20 K3a build] bf16 tensor-core kernels (128 threads, 64 keys a "
          "block, dynamic shared memory; -Xptxas -v, cudaOccupancy, "
          "cuobjdump -sass): " + "; ".join(parts), flush=True)


def phase_k3_timing(exp2_per_s: float) -> dict:
    """bf16 at the train step's flash shape and at (4, 4096, 64): K3a and
    K2c + K2d on prepared operands, the plain backward and SDPA's backward,
    in turns within this one process; the lower of each pair is kept; then
    K3a beside K2c + K2d in f32 at the train step's shape. Returns the main
    shape's numbers."""
    import torch.nn.functional as F

    from big_linear_algebra_tpu_torch.nn import attention as at
    from big_linear_algebra_tpu_torch.ops import cuda_utils

    slots = cuda_utils.load_library(
        "flash_attn_bwd_fused").bla_flash_bwd_fused_slots
    slots.restype = ctypes.c_int
    slots.argtypes = [ctypes.c_int] * 3
    gen = torch.Generator().manual_seed(14)
    names = ("K3a", "K2c+K2d", "plain", "sdpa")
    main = {}
    for b, n, d in K3_TIMED:
        args = _k2bwd_inputs(b, n, d, torch.bfloat16, gen)
        ops = at._kernel_bwd_operands(*args)
        q4, k4, v4 = (x[:, None].detach().requires_grad_()
                      for x in args[:3])
        o4 = F.scaled_dot_product_attention(q4, k4, v4)
        g4 = args[5][:, None]
        fns = {"K3a": lambda: at._kernel_bwd_fused(*ops),
               "K2c+K2d": lambda: (at._kernel_bwd_dq(*ops),
                                   at._kernel_bwd_dkv(*ops)),
               "plain": lambda: at._plain_flash_bwd(*args),
               "sdpa": lambda: torch.autograd.grad(o4, (q4, k4, v4), g4,
                                                   retain_graph=True)}
        iters = 50 if n <= 1024 else 10
        runs = {name: [] for name in names}
        for name in names + names[::-1]:
            runs[name].append(_time_ms(fns[name], iters=iters, warmup=2))
        ms = {name: min(dv for dv, _ in runs[name]) for name in names}
        bound = k3_bound_ms(b, n, d, torch.bfloat16, exp2_per_s)
        pair = [k2bwd_bound_ms(kern, b, n, d, torch.bfloat16, exp2_per_s)
                for kern in ("dq", "dkv")]
        pair = (pair[0][0] + pair[1][0], max(pair)[1])
        ws = slots(1, n, d) * b * n * d * 4
        print(f"[20 K3 timing] bf16 B={b} N={n} d={d}: device K3a "
              f"{ms['K3a'] * 1e3:.2f} us (bound {bound[0] * 1e3:.3f} us, "
              f"{bound[1]}; dq workspace {ws / 1e6:.1f} MB), K2c + K2d "
              f"{ms['K2c+K2d'] * 1e3:.2f} us (bound "
              f"{pair[0] * 1e3:.3f} us), plain backward "
              f"{ms['plain'] * 1e3:.2f} us, SDPA backward "
              f"{ms['sdpa'] * 1e3:.2f} us ({b * n * n} exp2, "
              f"{10 * b * n * n * d} flops)", flush=True)
        if (b, n, d) == K3_MAIN:
            main = dict(ms, bound=bound, pair_bound=pair)
    ops = at._kernel_bwd_operands(*_k2bwd_inputs(*K3_MAIN, torch.float32,
                                                 gen))
    fns = {"K3a": lambda: at._kernel_bwd_fused(*ops),
           "K2c+K2d": lambda: (at._kernel_bwd_dq(*ops),
                               at._kernel_bwd_dkv(*ops))}
    runs = {name: [] for name in fns}
    for name in (*fns, *reversed(fns)):
        runs[name].append(_time_ms(fns[name], iters=20, warmup=2)[0])
    ms = {name: min(r) for name, r in runs.items()}
    ws = slots(0, K3_MAIN[1], K3_MAIN[2]) * K3_MAIN[0] * K3_MAIN[1] * K3_MAIN[2]
    print(f"[20 K3 timing] f32 B={K3_MAIN[0]} N={K3_MAIN[1]} d={K3_MAIN[2]}:"
          f" device K3a {ms['K3a'] * 1e3:.2f} us (FMA kernel; dq workspace "
          f"{ws * 4 / 1e6:.1f} MB), K2c + K2d {ms['K2c+K2d'] * 1e3:.2f} us",
          flush=True)
    return main


def phase_k3_unet_sites(sites) -> dict:
    """The four flash sites of phase 10's conditioned full-width 64x64 f32
    gradient, through ``flash_attention(..., stream=False)`` with the
    launch counts set to 0 before and read after: K3a; then, with the
    budget at 0, the two-pass route (K2c/K2d). K3a against the plain
    backward and against K2c/K2d on each site's operands, and the two-pass
    route against the plain backward, at phase 8's f32 tolerances. Returns
    the launches ({"K3a": .., "K3bc": ..})."""
    from big_linear_algebra_tpu_torch.nn import attention as at

    def run():
        _zero_k3_counts(at)
        grads = [_flash_grads(at, q, k, v, g) for q, k, v, _, _, g in sites]
        torch.cuda.synchronize()
        return grads, _k3_counts(at)

    fused, fused_counts = run()
    two_pass, two_counts = _with_budget(at, 0, run)
    n = len(sites)
    if fused_counts != (n, n, 0, 0) or two_counts != (n, 0, n, n):
        fail(f"flash_attention(..., stream=False) at the {n} U-Net sites "
             f"launched K2/K3a/K2c/K2d {fused_counts}, with the budget at 0 "
             f"{two_counts}; expected {(n, n, 0, 0)} and {(n, 0, n, n)}")
    worst = {"K3a vs plain": 0.0, "K3a vs K2c/K2d": 0.0,
             "two-pass vs plain": 0.0}
    for i, (site, a, b) in enumerate(zip(sites, fused, two_pass)):
        want = at._plain_flash_bwd(*site)
        for name, x, y, z in zip(("dq", "dk", "dv"), a, b, want):
            for key, got, ref in (("K3a vs plain", x, z),
                                  ("K3a vs K2c/K2d", x, y),
                                  ("two-pass vs plain", y, z)):
                ratio = _k3_ratio(got, ref)
                worst[key] = max(worst[key], ratio)
                if not ratio <= 1.0:
                    fail(f"flash site {i} of the f32 gradient, {name}: "
                         f"{key} err exceeds atol {K2BWD_F32_ATOL} + rtol "
                         f"{K2BWD_F32_RTOL}*|ref| by {ratio}x")
    print(f"[21 K3 unet sites] the {n} flash sites (q {tuple(sites[0][0].shape)}"
          f") of phase 10's conditioned f32 gradient through flash_attention("
          f"..., stream=False): launches K2/K3a/K2c/K2d {fused_counts}; with "
          f"the budget at 0 {two_counts}; worst err/(atol {K2BWD_F32_ATOL} + "
          f"rtol {K2BWD_F32_RTOL}*|ref|): "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
          + " (tol 1)", flush=True)
    return {"K3a": fused_counts[1], "K3bc": two_counts[2]}


# ---------------------------------------------------------------------------
# Phase 23: the remaining programs (my_first_model, legacy mnist,
# mnist_hinge, smoke) and the debug flags. No kernel of the port is on their
# path: the Layer graph's products are matrix-vector products and the hinge
# ensemble's are two full-batch GEMMs, which the JAX package computes with
# jnp.matmul outside any Pallas kernel (cuBLAS here, TF32 off); smoke's one
# ops.matmul is a 3x3 product under _SMALL_FLOPS in both packages.
# ---------------------------------------------------------------------------

F32_UNIT = 2.0 ** -24  # f32 unit roundoff
# The CPU's f32 plain path stands in for the card when
# tools/legacy_programs_check.py --device=cpu runs these checks; the numbers
# below are that script's.
#
# my_first_model train 800 0.1 (2->3->2 ReLU) on the card against the same
# 800 steps in f64 on the CPU (same CSVs, same numpy stream), leaf by leaf:
#     max|card - f64| <= MFM_RTOL_OF_UPDATE * max|f64 - initial|,
# and each step's cost within MFM_COST_ATOL. The CPU's f32 run is 7.1e-8 to
# 2.4e-7 of each leaf's update from f64 and its costs 1.1e-6 from f64's.
# Fixed before the first run at about 400x those: room for a ReLU mask that
# flips between f32 and f64 (3 hidden units, 800 steps) while a step whose
# gradient were off by 0.1% would fail.
MFM_RTOL_OF_UPDATE = 1e-4
MFM_COST_ATOL = 5e-4
# Legacy mnist (784->200->200->10, per-example SGD) and mnist_hinge are
# chaotic: rounding differences grow step after step (the reference's init
# saturates mnist's layers; each hinge iteration's violation set jumps), so
# no bound on their trajectories can hold. On the CPU's plain path the same
# 1000 mnist steps in f32 end 1.3 times the largest leaf update away from
# f64 (0.12 from --he-init), and 100 hinge iterations 0.17. So each step or
# iteration is held teacher-forced: the card's from the card's own state,
# in f64 on the CPU, with the card's discrete decisions (ReLU masks,
# violation sets), elementwise within F32_BOUND_MARGIN times the
# first-order bound of the roundings an f32 evaluation makes
# (``_layer_graph_step_check``, ``_hinge_iteration_check``): the bound is
# the reckoning, and 2 covers the terms of second order.
F32_BOUND_MARGIN = 2.0
# f32 softmax of 10 values (exp, sum, divide) against f64's on the same
# logits: a few units of u; 1e-5 leaves room for exp's error of a few ulp.
SOFTMAX_ATOL = 1e-5
LEGACY_MNIST_STEPS, LEGACY_MNIST_LR, LEGACY_MNIST_RUN = 1000, 0.05, 200
HINGE_ITERATIONS, HINGE_LR = 100, 0.0005
# smoke: its printed values against the f64 values from the same fixtures:
# the print's 6 decimals round by up to 5e-7, and f32 adds ~1e-7 at values
# near 1.
SMOKE_ATOL = 1e-6


def _cli(module, args, where: str, device: str):
    """``module.main(args + --device)`` with ``BLA_DATA_DIR=where``:
    (stdout, host seconds); fails on a non-zero exit."""
    os.environ["BLA_DATA_DIR"] = where
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = module.main([*args, f"--device={device}"])
    seconds = time.perf_counter() - t0
    if rc != 0:
        fail(f"{module.__name__} {' '.join(args)} exited {rc}:\n"
             f"{out.getvalue()}")
    return out.getvalue(), seconds


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def phase_my_first_model(tmp: str, device: str = "cuda") -> dict:
    """``my_first_model init``, ``train 800 0.1`` and ``run`` on a same-sign
    and a different-sign input; the trained leaves and each step's cost
    against the same steps in f64 on the CPU (same CSVs, same stream); the
    loop replayed on the device bit-equal to the CLI's."""
    import numpy as np

    from big_linear_algebra_tpu_torch.data.csv import write_csv_matrix
    from big_linear_algebra_tpu_torch.models import my_first_model as mfm
    from big_linear_algebra_tpu_torch.nn import layer_graph as lg

    steps, lr = 800, 0.1
    _cli(mfm, ["init"], tmp, device)
    initial = mfm.load_params()
    with _saved(mfm, "save_params") as saved:
        text, seconds = _cli(mfm, ["train", str(steps), str(lr)], tmp, device)
    if len(saved) != 1 or "Finished training" not in text:
        fail(f"my_first_model train:\n{text}")
    xs, ys = mfm.synth_stream(steps)
    run_steps = lg.make_sgd_scan(mfm.ACTS)
    dev = [(w.to(device), b.to(device)) for w, b in initial]
    xs_d, ys_d = torch.from_numpy(xs).to(device), torch.from_numpy(ys).to(device)
    _sync(device)
    t0 = time.perf_counter()
    card, costs = run_steps(dev, xs_d, ys_d, lr)
    _sync(device)
    loop_s = time.perf_counter() - t0
    if not all(torch.equal(a.cpu(), b) for a, b in zip(_flat(card), saved[0])):
        fail("my_first_model: the replayed steps are not bit-equal to train's")
    ref, ref_costs = run_steps([(w.double(), b.double()) for w, b in initial],
                               torch.from_numpy(xs).double(),
                               torch.from_numpy(ys).double(), lr)
    ratios = {}
    for name, got, want, start in zip(("w1", "b1", "w2", "b2"), saved[0],
                                      _flat(ref), _flat(initial)):
        ratios[name] = ((got.double() - want).abs().max()
                        / (want - start.double()).abs().max()).item()
    cost_err = (costs.cpu().double() - ref_costs).abs().max().item()
    if not (max(ratios.values()) <= MFM_RTOL_OF_UPDATE
            and cost_err <= MFM_COST_ATOL
            and torch.isfinite(costs).all()):
        fail(f"my_first_model train {steps} {lr}: max|err| / max|update| per "
             f"leaf {ratios} (tol {MFM_RTOL_OF_UPDATE}), costs {cost_err} "
             f"(tol {MFM_COST_ATOL}) against the CPU f64 steps")
    verdicts = []
    for pair, want in (((0.7, 0.8), "Same sign!"),
                       ((-0.7, 0.8), "Different signs!")):
        write_csv_matrix(os.path.join(tmp, "my_first_model",
                                      "input_nodes.csv"),
                         np.array([pair], np.float32))
        out, _ = _cli(mfm, ["run"], tmp, device)
        if out.splitlines()[-1] != want:
            fail(f"my_first_model run on {pair}: expected {want!r}:\n{out}")
        verdicts.append(f"{pair} -> {want}")
    return dict(steps=steps, cli_s=seconds, loop_s=loop_s, ratios=ratios,
                cost_err=cost_err, verdicts=verdicts)


def _ratio(err, bound) -> float:
    """max of err / bound elementwise; where the bound is 0, err must be."""
    if bool((err[bound == 0] > 0).any()):
        return math.inf
    return (err / torch.where(bound > 0, bound, 1.0)).max().item()


# The Layer graph's activations written out again for the f64 reference of
# phase 23: (forward, derivative from (raw, activated), the derivative's f32
# rounding on the card in units of u).
_REF_ACTIVATIONS = {
    "relu": (lambda r: torch.clamp_min(r, 0.0),
             lambda r, a: (r > 0).double(), 0),
    "linear": (lambda r: r, lambda r, a: torch.ones_like(r), 0),
    "scale_0.1": (lambda r: 0.1 * r, lambda r, a: torch.full_like(r, 0.1), 1),
    "softmax_legacy": (lambda r: torch.exp(r - r.max()) / torch.exp(
        r - r.max()).sum(), lambda r, a: a * (1.0 - a), 2),
}


def _layer_graph_step_check(card_prev, card_next, acts, x, y, lr):
    """One legacy step on the card held teacher-forced, in f64 on the CPU:
    the card's forward (``feed_forward`` again on the card: the same ops,
    the same values) layer by layer against ``W a + b`` from the card's own
    input to that layer; ReLU exact; the softmax within ``SOFTMAX_ATOL``;
    then the card's new parameters against the f64 backward and update from
    the card's forward values (its masks, its softmax), written out here
    (``_REF_ACTIVATIONS``) and not taken from the port. Each elementwise
    within ``F32_BOUND_MARGIN`` times the first-order bound of the f32
    roundings the card makes (``n u sum|terms|`` for a sum of n terms, u
    per product, subtraction and f32 ``lr``; the backward's errors carried
    through ``|W|^T``). Returns (the forward's largest error over its
    bound, the update's, whether the step moved a weight past its f32
    rounding)."""
    from big_linear_algebra_tpu_torch.nn import layer_graph as lg

    u = F32_UNIT

    def f64(t):
        return t.detach().cpu().double()

    with torch.no_grad():
        a_c, r_c = lg.feed_forward(card_prev, acts, x)
    prev = [(f64(w), f64(b)) for w, b in card_prev]
    a_c, r_c = [f64(a) for a in a_c], [f64(r) for r in r_c]
    fwd = 0.0
    for (w, b), name, a_in, raw, a_out in zip(prev, acts, a_c, r_c, a_c[1:]):
        bound = (w.shape[1] + 2) * u * (w.abs() @ a_in.abs() + b.abs())
        fwd = max(fwd, _ratio((raw - (w @ a_in + b)).abs(),
                              F32_BOUND_MARGIN * bound))
        want = _REF_ACTIVATIONS[name][0](raw)
        if name == "relu":
            if not torch.equal(a_out, want):
                fail("legacy step: ReLU on the card differs from max(raw, 0)")
        else:
            fwd = max(fwd, (a_out - want).abs().max().item() / SOFTMAX_ATOL)
    # _sgd_step_cost's backward and update from the card's forward values;
    # e: the bound on the card's dC/da
    diff = a_c[-1] - f64(y)
    dCda, e = 2.0 * diff, 2.0 * u * diff.abs()
    upd, moved_any = 0.0, False
    for i in reversed(range(len(prev))):
        w, b = prev[i]
        _, ddx_fn, ulps = _REF_ACTIVATIONS[acts[i]]
        ddx = ddx_fn(r_c[i], a_c[i + 1])
        e_ddx = ulps * u * ddx.abs()
        delta = ddx * dCda
        e_delta = ddx.abs() * e + dCda.abs() * e_ddx + u * delta.abs()
        step_w = lr * torch.outer(delta, a_c[i])
        for got, old, want, bound in (
                (card_next[i][0], w, w - step_w,
                 lr * torch.outer(e_delta, a_c[i].abs())
                 + 3 * u * step_w.abs() + u * (w - step_w).abs()),
                (card_next[i][1], b, b - lr * delta,
                 lr * e_delta + 2 * u * lr * delta.abs()
                 + u * (b - lr * delta).abs())):
            err = (f64(got) - want).abs()
            upd = max(upd, _ratio(err, F32_BOUND_MARGIN * bound))
            moved_any |= bool(((want - old).abs() > 2 * u * want.abs()).any())
        if i:
            e = w.abs().T @ e_delta + (w.shape[0] + 1) * u * (
                w.abs().T @ delta.abs())
            dCda = w.T @ delta
    return fwd, upd, moved_any


def phase_legacy_mnist(tmp: str, device: str = "cuda") -> dict:
    """Legacy ``mnist init``, ``train 1000 0.05 0`` and ``run 200 0`` on the
    synthesized set; the CLI's steps replayed on the device one by one,
    bit-equal to the CLI's, each held teacher-forced in f64
    (``_layer_graph_step_check``); the run's correct count equal to the CPU
    f64 path's on the trained checkpoint."""
    import numpy as np

    from big_linear_algebra_tpu_torch.data import synth
    from big_linear_algebra_tpu_torch.data.mnist import MnistDataset
    from big_linear_algebra_tpu_torch.models import mnist as legacy
    from big_linear_algebra_tpu_torch.nn import layer_graph as lg

    steps, lr = LEGACY_MNIST_STEPS, LEGACY_MNIST_LR
    os.environ["BLA_DATA_DIR"] = tmp
    with contextlib.redirect_stdout(io.StringIO()):
        train_csv, test_csv = synth.ensure_mnist(tmp)
    _cli(legacy, ["init"], tmp, device)
    initial = legacy.load_params()
    with _saved(legacy, "save_params") as saved:
        text, seconds = _cli(legacy, ["train", str(steps), str(lr), "0"], tmp,
                             device)
    avg = re.search(r"Final batch avg: ([0-9.]+)", text)
    if len(saved) != 1 or avg is None or not math.isfinite(
            float(avg.group(1))):
        fail(f"mnist train:\n{text}")
    xs, ys = legacy.stream_examples(train_csv, steps)
    xs_d, ys_d = torch.from_numpy(xs).to(device), torch.from_numpy(ys).to(device)
    card = [(w.to(device), b.to(device)) for w, b in initial]
    fwd, step, rel = [], [], []
    for k in range(steps):
        with torch.no_grad():
            nxt, _ = lg._sgd_step_cost(card, legacy.ACTS, xs_d[k], ys_d[k], lr)
        f, s, r = _layer_graph_step_check(card, nxt, legacy.ACTS, xs_d[k],
                                          ys_d[k], lr)
        fwd.append(f)
        step.append(s)
        rel.append(r)
        card = nxt
    if not all(torch.equal(a.cpu(), b) for a, b in zip(_flat(card), saved[0])):
        fail("mnist: the replayed steps are not bit-equal to train's")
    fwd, step, rel = np.asarray(fwd), np.asarray(step), np.asarray(rel, bool)
    if not (fwd.max() <= 1.0 and step.max() <= 1.0):
        fail(f"mnist train, teacher-forced against f64: forward at "
             f"{fwd.max()} of its bound (step {int(fwd.argmax())}), update at "
             f"{step.max()} of its bound (step {int(step.argmax())})")
    run_text, _ = _cli(legacy, ["run", str(LEGACY_MNIST_RUN), "0"], tmp,
                       device)
    got = re.search(r"Got (\d+) correct out of (\d+)", run_text)
    test = MnistDataset.from_csv(test_csv)
    x64 = torch.from_numpy(test.x[:LEGACY_MNIST_RUN] / 255.0).double()
    ckpt = [(w.double(), b.double()) for w, b in legacy.load_params()]
    f64_correct = int((lg.predict_batch(ckpt, legacy.ACTS, x64).argmax(1)
                       == torch.from_numpy(test.y[:LEGACY_MNIST_RUN]).long()
                       ).sum())
    if got is None or int(got.group(1)) != f64_correct or int(
            got.group(2)) != LEGACY_MNIST_RUN:
        fail(f"mnist run {LEGACY_MNIST_RUN}: {got and got.group(0)}, the CPU "
             f"f64 path {f64_correct} correct:\n{run_text[-400:]}")
    return dict(steps=steps, cli_s=seconds, avg=avg.group(1),
                fwd=float(fwd.max()), step=float(step.max()),
                moved=int(rel.sum()),
                correct=f64_correct, xs=xs_d, ys=ys_d, params=card)


def _hinge_iteration_check(w_prev, w_next, x, y, lr, margins=None):
    """One mnist_hinge iteration on the card held teacher-forced, in f64 on
    the CPU: the card's margins (``y * (x @ w)`` again on the card: the same
    op, the same values; or ``margins`` as the card computed them, the DP
    ranks' gathered) against f64's from the card's weights, then the
    card's next weights against the f64 update from the card's violation
    set; each elementwise within ``F32_BOUND_MARGIN`` times the first-order
    bound of the card's f32 roundings (``n u sum|terms|`` for the sums over
    784 pixels and over the N examples, u for the f32 ``lr``, the product
    and the subtraction). Returns the largest error over its bound."""
    u = F32_UNIT
    if margins is None:
        with torch.no_grad():
            margins = y * (x @ w_prev)
    margins = margins.cpu().double()
    w, x64, y64 = (t.cpu().double() for t in (w_prev, x, y))
    bound = (x64.shape[1] + 1) * u * (x64.abs() @ w.abs())
    ratio = _ratio((margins - y64 * (x64 @ w)).abs(), F32_BOUND_MARGIN * bound)
    vy = (margins < 1.0).double() * y64
    grads = -(x64.T @ vy)
    want = w - lr * grads
    bound = (lr * (x64.shape[0] + 1) * u * (x64.abs().T @ vy.abs())
             + 2 * u * lr * grads.abs() + u * want.abs())
    return max(ratio, _ratio((w_next.cpu().double() - want).abs(),
                             F32_BOUND_MARGIN * bound))


def phase_mnist_hinge(tmp: str, mnist_dir: str, device: str = "cuda") -> dict:
    """``mnist_hinge init``, ``train 100 0.0005`` and ``run -1 0`` on the
    8192-image set (copied from ``mnist_dir``); the printed convergence
    iteration, or its absence, equal to the f64 run's on the CPU; the CLI's
    iterations replayed on the device one by one, bit-equal to the CLI's,
    each held teacher-forced in f64 (``_hinge_iteration_check``); the
    accuracy equal to the CPU f64 path's on the trained checkpoint."""
    import shutil

    import numpy as np

    from big_linear_algebra_tpu_torch.data.mnist import MnistDataset
    from big_linear_algebra_tpu_torch.models import mnist_hinge as hinge

    iters, lr = HINGE_ITERATIONS, HINGE_LR
    shutil.copytree(mnist_dir, os.path.join(tmp, "mnist"))
    _cli(hinge, ["init"], tmp, device)
    w0 = hinge.load_weights()
    with _saved(hinge, "save_weights") as saved:
        text, seconds = _cli(hinge, ["train", str(iters), str(lr)], tmp,
                             device)
    conv = re.search(r"converged < epsilon after iteration (\d+)", text)
    conv = None if conv is None else int(conv.group(1))
    if len(saved) != 1 or "Finished training" not in text:
        fail(f"mnist_hinge train:\n{text}")
    data = MnistDataset.from_csv(os.path.join(tmp, "mnist", "mnist_train.csv"))
    x32 = torch.from_numpy(data.x / 255.0)
    x64, y64 = x32.double(), hinge.signed_targets(torch.from_numpy(data.y),
                                                  torch.float64)
    # the f64 trajectory from the same weights: its convergence iteration
    w, ref_conv = w0.double(), None
    for start in range(0, iters, hinge.CHUNK):
        w, norms = hinge.train_chunk(w, x64, y64, lr,
                                     min(hinge.CHUNK, iters - start))
        hit = (norms.sum(dim=1) < hinge.EPSILON).nonzero()
        if len(hit):
            ref_conv = start + int(hit[0])
            break
    if conv != ref_conv:
        fail(f"mnist_hinge train: converged at {conv} on the card, at "
             f"{ref_conv} in f64 on the CPU")
    x_d = x32.to(device)
    y_d = hinge.signed_targets(torch.from_numpy(data.y).to(device),
                               torch.float32)
    card = w0.to(device)
    ratios = []
    for _ in range(iters if conv is None else conv + 1):
        nxt, _ = hinge.train_chunk(card, x_d, y_d, lr, 1)
        ratios.append(_hinge_iteration_check(card, nxt, x_d, y_d, lr))
        card = nxt
    if not torch.equal(card.cpu(), saved[0][0]):
        fail("mnist_hinge: the replayed iterations are not bit-equal to "
             "train's")
    ratios = np.asarray(ratios)
    if not ratios.max() <= 1.0:
        fail(f"mnist_hinge train, teacher-forced against f64: iteration "
             f"{int(ratios.argmax())} at {ratios.max()} of its bound")
    run_text, _ = _cli(hinge, ["run", "-1", "0"], tmp, device)
    acc = re.search(r"accuracy ([0-9.]+)", run_text)
    test = MnistDataset.from_csv(os.path.join(tmp, "mnist", "mnist_test.csv"))
    scores = (torch.from_numpy(test.x / 255.0).double()
              @ hinge.load_weights().double())
    hits = scores.argmax(1) == torch.from_numpy(test.y).long()
    f64_acc = f"{int(hits.sum()) / len(hits):.5f}"
    if acc is None or acc.group(1) != f64_acc:
        fail(f"mnist_hinge run: accuracy {acc and acc.group(1)} on the card, "
             f"{f64_acc} on the CPU f64 path")
    return dict(iters=iters, cli_s=seconds, conv=conv, accuracy=f64_acc,
                ratio=(float(np.median(ratios)), float(ratios.max())),
                x=x_d, y=y_d, w=card)


def phase_smoke(tmp: str, device: str = "cuda") -> dict:
    """``smoke``: the printed 3x3 product and the one-layer net before and
    after one step against the f64 values from the same fixtures
    (``SMOKE_ATOL``); K1 launched no time (the product is under
    ``_SMALL_FLOPS``)."""
    import numpy as np

    from big_linear_algebra_tpu_torch.data.csv import read_csv_matrix
    from big_linear_algebra_tpu_torch.models import smoke
    from big_linear_algebra_tpu_torch.nn import layer_graph as lg
    from big_linear_algebra_tpu_torch.ops import matmul as mm

    _zero_k1_counts(mm)
    text, _ = _cli(smoke, [], tmp, device)
    if mm.launch_count:
        fail(f"smoke launched K1 {mm.launch_count} times")
    lines = text.splitlines()
    printed = {}
    for i, line in enumerate(lines):
        head = re.fullmatch(r"(.+) \((\d+)x(\d+)\):", line)
        if head:
            rows = lines[i + 1:i + 1 + int(head.group(2))]
            printed[head.group(1)] = np.array(
                [[float(v) for v in row.split()] for row in rows])

    def load(name, r, c):
        return torch.from_numpy(read_csv_matrix(os.path.join(tmp, name), r,
                                                c)).double()

    x = load("inputs.csv", 3, 1)[:, 0]
    params = [(load("weights.csv", 2, 3), load("biases.csv", 2, 1)[:, 0])]
    acts = ("scale_0.1",)
    with torch.no_grad():
        before = lg.predict(params, acts, x)
        after = lg.predict(lg.sgd_step(params, acts, x, torch.tensor(
            [1.0, 0.0], dtype=torch.float64), 0.5), acts, x)
    want = {"a @ b": (load("a.csv", 3, 3) @ load("b.csv", 3, 3)).numpy(),
            "output before": before.reshape(-1, 1).numpy(),
            "output after one step": after.reshape(-1, 1).numpy()}
    if sorted(printed) != sorted(want):
        fail(f"smoke printed {sorted(printed)}:\n{text}")
    errs = {k: float(np.abs(printed[k] - want[k]).max()) for k in want}
    if not max(errs.values()) <= SMOKE_ATOL:
        fail(f"smoke against f64: {errs} (tol {SMOKE_ATOL}):\n{text}")
    return errs


def phase_debug_flags(p22: dict, tmp: str, device: str = "cuda") -> str:
    """``mnist_nn train 1 --debug-nans --disable-jit`` from phase 22's
    initial CSVs: K1's launches by variant as in phase 22, the trained
    leaves bit-equal to phase 22's ``train 1``. Then one ``train_step``
    under ``debug_nans()`` with one NaN pixel in its batch must raise
    ``FloatingPointError`` naming K1's launch, the first op that sees it,
    and one whose w1 gradient hook makes a NaN must raise in the backward.
    Returns the run's host seconds, K1's launches and that message."""
    from big_linear_algebra_tpu_torch.data import synth
    from big_linear_algebra_tpu_torch.models import mnist_nn
    from big_linear_algebra_tpu_torch.ops import matmul as mm
    from big_linear_algebra_tpu_torch.utils import debug

    os.environ["BLA_DATA_DIR"] = tmp
    with contextlib.redirect_stdout(io.StringIO()):
        synth.ensure_mnist(tmp)
    mnist_nn.save_params_csv(p22["initial"])
    _zero_k1_counts(mm)
    with _saved(mnist_nn, "save_params_csv") as saved:
        text, seconds = _cli(mnist_nn, ["train", "1", "--debug-nans",
                                        "--disable-jit"], tmp, device)
    counts = dict(mm.variant_launch_counts)
    if counts != p22["counts"]:
        fail(f"train 1 --debug-nans --disable-jit: K1 launched {counts}, "
             f"phase 22's train 1 {p22['counts']}")
    for k, v in saved[0].items():
        if not torch.equal(v.view(torch.int32),
                           p22["trained"][k].view(torch.int32)):
            fail(f"train 1 --debug-nans --disable-jit: {k} not bit-equal to "
                 "phase 22's train 1")
    cfg = mnist_nn.CONFIG
    model = mnist_nn.MnistNN.from_params(p22["initial"], device=device)
    gen = torch.Generator().manual_seed(23)
    x = torch.rand((cfg.batch_size, cfg.input_size), generator=gen)
    x[3, 400] = float("nan")
    onehot = torch.nn.functional.one_hot(
        torch.arange(cfg.batch_size) % 10, 10).float()
    batch = [v.to(device) for v in (x, onehot, torch.ones(cfg.batch_size))]
    try:
        with debug.debug_nans():
            mnist_nn.train_step(model, *batch, cfg)
    except FloatingPointError as e:
        message = str(e)
    else:
        fail("train_step under debug_nans() with a NaN pixel did not raise")
    want = ("matmul_nn kernel launch" if device == "cuda"
            else "aten.mm.default")
    if want not in message:
        fail(f"debug_nans raised {message!r}, expected it to name {want!r}")
    # the mode sees the ops that autograd's backward runs (on a CUDA device
    # in autograd's own thread): a NaN made in w1's gradient hook raises
    model.layers[0].weight.register_hook(lambda g: g * float("nan"))
    batch[0] = torch.nan_to_num(batch[0])
    try:
        with debug.debug_nans():
            mnist_nn.train_step(model, *batch, cfg)
    except FloatingPointError as e:
        backward = str(e)
    else:
        fail("a NaN made in the backward under debug_nans() did not raise")
    return dict(seconds=seconds, counts=counts, message=message,
                backward=backward)


def phase_legacy_profile(mnist_run: dict, hinge_run: dict) -> dict:
    """Host wall time and a ``torch.profiler`` trace (``trace_summary.py``)
    of 100 legacy mnist steps and of one mnist_hinge chunk (10 iterations)
    on the trained parameters, both eager (phase 28 times the graphs): the
    card's busy share."""
    from big_linear_algebra_tpu_torch.models import mnist as legacy
    from big_linear_algebra_tpu_torch.models import mnist_hinge as hinge
    from big_linear_algebra_tpu_torch.nn import layer_graph as lg

    run_steps = lg.make_sgd_scan(legacy.ACTS, graphed=False)
    xs, ys = mnist_run["xs"][:100], mnist_run["ys"][:100]
    out = {}
    out["mnist"] = _host_and_trace(
        lambda: run_steps(mnist_run["params"], xs, ys, LEGACY_MNIST_LR),
        n_traced=1, warmup=1, timed=3)
    out["hinge"] = _host_and_trace(
        lambda: hinge.train_chunk(hinge_run["w"], hinge_run["x"],
                                  hinge_run["y"], HINGE_LR, hinge.CHUNK),
        n_traced=1, warmup=1, timed=3)
    return out


def phase_legacy_programs(p22: dict, device: str = "cuda") -> None:
    """Phase 23: the remaining programs and the debug flags, each in a fresh
    temporary data directory; then their train loops timed and profiled."""
    dirs = {}
    with tempfile.TemporaryDirectory(prefix="bla_smoke_") as tmp:
        for part in ("my_first_model", "mnist", "mnist_hinge", "smoke",
                     "debug"):
            dirs[part] = os.path.join(tmp, part)
            os.makedirs(dirs[part])
        mfm = phase_my_first_model(dirs["my_first_model"], device)
        print(f"[23 my_first_model] init + train {mfm['steps']} 0.1 + run: "
              f"{' ; '.join(mfm['verdicts'])}; against the CPU f64 steps, "
              f"max|err| / max|update| per leaf "
              + ", ".join(f"{k} {r:.3e}" for k, r in mfm["ratios"].items())
              + f" (tol {MFM_RTOL_OF_UPDATE}), costs max|err| "
              f"{mfm['cost_err']:.3e} (tol {MFM_COST_ATOL}); train "
              f"{mfm['cli_s']:.3f} s of host wall, its loop "
              f"{mfm['loop_s']:.3f} s = {mfm['steps'] / mfm['loop_s']:.1f} "
              f"steps/s", flush=True)
        lm = phase_legacy_mnist(dirs["mnist"], device)
        print(f"[23 mnist legacy] init + train {lm['steps']} "
              f"{LEGACY_MNIST_LR} 0 (Final batch avg {lm['avg']}) + run "
              f"{LEGACY_MNIST_RUN} 0: Got {lm['correct']} correct on the card "
              f"and on the CPU f64 path; the {lm['steps']} steps replayed "
              f"bit-equal, each teacher-forced against f64: forward at most "
              f"{lm['fwd']:.3e} of its f32 bound, update at most "
              f"{lm['step']:.3e} of its ({lm['moved']} steps moved a weight "
              f"past its f32 rounding); "
              f"train {lm['cli_s']:.3f} s of host wall "
              f"= {lm['steps'] / lm['cli_s']:.1f} steps/s", flush=True)
        hg = phase_mnist_hinge(dirs["mnist_hinge"],
                               os.path.join(dirs["mnist"], "mnist"), device)
        print(f"[23 mnist_hinge] init + train {hg['iters']} {HINGE_LR} + run "
              f"-1 0 on 8192 images: converged "
              f"{'at ' + str(hg['conv']) if hg['conv'] is not None else 'never'}"
              f" on the card and in f64; accuracy {hg['accuracy']} on the "
              f"card and on the CPU f64 path; the iterations replayed "
              f"bit-equal, each teacher-forced against f64 at median "
              f"{hg['ratio'][0]:.3e}, max {hg['ratio'][1]:.3e} of its f32 "
              f"bound; train {hg['cli_s']:.3f} s of host wall = "
              f"{hg['iters'] / hg['cli_s']:.1f} iterations/s", flush=True)
        sm = phase_smoke(dirs["smoke"], device)
        print("[23 smoke] printed against f64: "
              + ", ".join(f"{k} {v:.2e}" for k, v in sm.items())
              + f" (tol {SMOKE_ATOL}); K1 launches 0", flush=True)
        dbg = phase_debug_flags(p22, dirs["debug"], device)
        print(f"[23 debug flags] mnist_nn train 1 --debug-nans --disable-jit:"
              f" K1 launches {dbg['counts']} as in phase 22, the trained "
              f"leaves bit-equal to phase 22's, {dbg['seconds']:.3f} s of "
              f"host wall; a NaN pixel under debug_nans(): "
              f"FloatingPointError({dbg['message']!r}); a NaN made in the "
              f"backward: FloatingPointError({dbg['backward']!r})",
              flush=True)
        if device == "cuda":
            prof = phase_legacy_profile(lm, hg)
            for name, what, n_steps in (("mnist", "100 legacy mnist steps",
                                         100),
                                        ("hinge", "one mnist_hinge chunk",
                                         10)):
                host, busy, summary, _ = prof[name]
                print(f"[23 profile] {what} on the card: host wall "
                      f"{host:.3f} ms = {host / n_steps * 1e3:.2f} us per "
                      f"step; device busy {busy:.3f} ms = {busy / host:.1%} "
                      f"of the host time; trace (trace_summary.py):\n    "
                      + summary.replace("\n", "\n    "), flush=True)
        del os.environ["BLA_DATA_DIR"]


# ---------------------------------------------------------------------------
# Phase 24: the data- and sequence-parallel modes, P24_RANKS ranks under
# torch.distributed.run (they share the one card over gloo, or get a card
# each over NCCL where there are as many).
# ---------------------------------------------------------------------------

P24_RANKS = 2
# cifar_unet train --dp: steps at 64x64, then at 32x32 with --fused-block
P24_UNET_STEPS, P24_FUSED_STEPS = 20, 10
# ring attention: (B, N, d, dtype) over the ranks' "seq" axis (on the CPU
# rehearsal, smaller)
P24_RING = {"cuda": [(4, 8192, 64, torch.bfloat16),
                     (2, 2048, 16, torch.float32)],
            "cpu": [(2, 256, 64, torch.bfloat16),
                    (2, 128, 16, torch.float32)]}
# bf16 ring outputs against the plain flash over the whole sequence: the
# same bf16 roundings of q^ and P, but P is rounded against each visiting
# block's running max and merged, so single probabilities may round a
# bf16 step (2**-8) apart; phase 5's and phase 8's bf16 tolerance.
RING_BF16_RTOL_OF_MAX = 2e-2
# The whole launch of the ranks; it ends well inside this.
P24_TIMEOUT_S = 900


def tp_step_gemms(sizes, batch: int, tp: int):
    """(variant, M, K, N) of every GEMM of one mnist_nn DP×TP step on one
    rank: ``train_step_gemms`` with each layer's output dim split over
    ``tp`` model shards (the column-parallel weights)."""
    gemms = []
    for i, (fan_in, fan_out) in enumerate(zip(sizes, sizes[1:])):
        out = fan_out // tp
        gemms.append(("nn", batch, fan_in, out))
        if i > 0:
            gemms.append(("nt", batch, out, fan_in))
        gemms.append(("tn", fan_in, batch, out))
    return gemms


def _k1_counts(gemms, steps: int = 1) -> dict:
    """K1's launches by variant for ``steps`` steps of ``gemms``: those of
    at least ``_SMALL_FLOPS`` (the rest take the plain product)."""
    from big_linear_algebra_tpu_torch.ops import matmul as mm

    counts = {"nn": 0, "nt": 0, "tn": 0}
    for v, m, k, n in gemms:
        if 2 * m * n * k >= mm._SMALL_FLOPS:
            counts[v] += steps
    return counts


def _unet_fused_blocks(cfg, batch: int) -> list:
    """The fused blocks of ``cfg``'s U-Net forward with ``--fused-block`` at
    ``batch``, in bf16, as (B, C, F, H, W): the model's wiring and the
    gate, with every conv, attention site and fused block replaced by zeros
    of its output's shape (nothing is computed at full width)."""
    import dataclasses

    from big_linear_algebra_tpu_torch.models import cifar_unet as cu
    from big_linear_algebra_tpu_torch.nn import fused_block as fb

    cfg = dataclasses.replace(cfg, fused_block=True,
                              compute_dtype="bfloat16")
    blocks = []

    def block(x, td, w1, w2, w3, seed, gsz, rate, train, eps=1e-8,
              bits=None):
        blocks.append((*x.shape[:2], w1.shape[0], *x.shape[2:]))
        return x.new_zeros(x.shape[0], w1.shape[0], *x.shape[2:])

    def conv(x, k, stride=1):
        return x.new_zeros(x.shape[0], k.shape[0], -(-x.shape[2] // stride),
                           -(-x.shape[3] // stride))

    real = cu.conv2d, cu.self_attention_block, fb.fused_resnet_block
    cu.conv2d, cu.self_attention_block = conv, (lambda h, p: h)
    fb.fused_resnet_block = block
    try:
        params = cu.init_params(torch.Generator().manual_seed(0), cfg)
        x = torch.zeros(batch, cfg.in_channels, cfg.image_size,
                        cfg.image_size)
        with torch.inference_mode():
            cu.forward(params, x, torch.zeros(batch, dtype=torch.int64), cfg)
    finally:
        cu.conv2d, cu.self_attention_block, fb.fused_resnet_block = real
    return blocks


def _params_hash(tree) -> str:
    """sha256 of every leaf's bytes, in the tree's order."""
    import hashlib

    from big_linear_algebra_tpu_torch.nn.optim import tree_leaves

    digest = hashlib.sha256()
    for leaf in tree_leaves(tree):
        digest.update(leaf.detach().contiguous().cpu().view(
            torch.uint8).numpy().tobytes())
    return digest.hexdigest()


@contextlib.contextmanager
def _wrapped(module, name: str, wrap):
    """``module.<name>`` replaced by ``wrap(original)`` within the block."""
    real = getattr(module, name)
    setattr(module, name, wrap(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def _profile(fn, device: str, n_calls_timed: int = 3) -> dict:
    """A rank's host wall and collectives per call of ``fn``, over
    ``n_calls_timed`` calls after one warm-up, ending in a synchronise; on
    the card then the busy share of one call traced by ``torch.profiler``
    (``_host_and_trace``)."""
    from big_linear_algebra_tpu_torch.parallel import spmd

    fn()
    _sync(device)
    calls0 = spmd.collective_calls
    t0 = time.perf_counter()
    for _ in range(n_calls_timed):
        fn()
    _sync(device)
    host = (time.perf_counter() - t0) * 1e3 / n_calls_timed
    calls = spmd.collective_calls
    busy, summary = None, ""
    if device == "cuda":
        _, busy, summary, _ = _host_and_trace(fn, n_traced=1, warmup=0,
                                              timed=1)
    return {"host_ms": host, "busy_ms": busy, "summary": summary,
            "coll_calls": (calls - calls0) / n_calls_timed}


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 ``t`` truncated to TF32's 10-bit mantissa."""
    return (t.contiguous().view(torch.int32) & -8192).view(torch.float32)


def _of_max(got, ref) -> float:
    """max|got - ref| / max|ref|, ``ref`` in f64 on the CPU."""
    return ((got.detach().cpu().double() - ref).abs().max()
            / ref.abs().max()).item()


def _with_decisions(model, fn):
    """``fn()`` with forward hooks on ``model``'s layers 1 and 2: (its
    result, their ReLU decisions (outputs > 0), in call order)."""
    decisions = []
    hooks = [model.layers[i].register_forward_hook(
        lambda _m, _i, out: decisions.append(out.detach() > 0))
        for i in (0, 1)]
    try:
        return fn(), decisions
    finally:
        for hook in hooks:
            hook.remove()


def _mlp_grads_f64(params, x, onehot, mask, decisions, cfg) -> dict:
    """The gradient of mnist_nn's loss (``loss_and_metrics``: softmax CE
    summed over the batch, over ``input_size``) in f64 on the CPU, with
    layers 1 and 2's ReLU decisions given: where the card decided, so that
    a pre-activation within rounding of 0 cannot part the two."""
    p = {k: v.detach().cpu().double() for k, v in params.items()}
    masks = [d.cpu().double() for d in decisions]
    acts = [x.detach().cpu().double()]
    for i in (1, 2, 3):
        z = acts[-1] @ p[f"w{i}"] + p[f"b{i}"]
        acts.append(z * masks[i - 1] if i < 3 else z)
    g = ((torch.softmax(acts[3], dim=-1) - onehot.cpu().double())
         * mask.cpu().double()[:, None] / cfg.input_size)
    out = {}
    for i in (3, 2, 1):
        out[f"w{i}"], out[f"b{i}"] = acts[i - 1].T @ g, g.sum(0)
        if i > 1:
            g = (g @ p[f"w{i}"].T) * masks[i - 2]
    return out


def _p24_mnist_replay(mesh, initial, x_dev, y_dev, perm, want) -> dict:
    """The resident DP epoch of ``train 1 --dp`` replayed from the initial
    CSVs on the same permutation, every step's local gradient (the
    all-reduce's input) held against ``_mlp_grads_f64`` of this rank's rows
    at the same parameters with the card's ReLU decisions: the worst
    max|err| / max|ref| per leaf over the steps, and its step. Then the
    control: the first step's gradient from the operands truncated to TF32
    (``_tf32``) against the f64 gradient of the exact operands. ``want``:
    the CLI's trained leaves, which the replay must equal bit for bit."""
    from big_linear_algebra_tpu_torch.models import mnist_nn
    from big_linear_algebra_tpu_torch.parallel import spmd

    cfg = mnist_nn.CONFIG
    model = mnist_nn.MnistNN.from_params(initial, device=mesh.device)
    seen, worst, steps = {}, {}, [0]

    def decide(real):
        def wrapped(m, x, onehot, mask, cfg_):
            out, decisions = _with_decisions(
                m, lambda: real(m, x, onehot, mask, cfg_))
            seen.update(params={k: v.detach().cpu() for k, v in
                                m.params().items()},
                        batch=(x, onehot, mask), decisions=decisions)
            seen.setdefault("first", (x, onehot, mask))
            return out
        return wrapped

    def check(real):
        def wrapped(tree, *a, **kw):
            ref = _mlp_grads_f64(seen["params"], *seen["batch"],
                                 seen["decisions"], cfg)
            for k, g in tree["grads"].items():
                r = _of_max(g, ref[k])
                if r > worst.get(k, (-1.0, 0))[0]:
                    worst[k] = (r, steps[0])
            steps[0] += 1
            return real(tree, *a, **kw)
        return wrapped

    with _wrapped(mnist_nn, "loss_and_metrics", decide), \
            _wrapped(spmd, "psum_tree", check):
        mnist_nn.make_epoch_resident_dp(mesh, cfg)(model, x_dev, y_dev,
                                                   perm)
    bit_equal = all(torch.equal(v.detach().cpu(), want[k])
                    for k, v in model.params().items())
    x, onehot, mask = seen["first"]
    ctl = mnist_nn.MnistNN.from_params(
        {k: _tf32(v) for k, v in initial.items()}, device=mesh.device)

    def grads():
        ctl.zero_grad(set_to_none=True)
        with torch.enable_grad():
            mnist_nn.loss_and_metrics(ctl, _tf32(x), onehot, mask,
                                      cfg)[0].backward()

    _, decisions = _with_decisions(ctl, grads)
    ref = _mlp_grads_f64(initial, x, onehot, mask, decisions, cfg)
    control = {k: _of_max(v.grad, ref[k]) for k, v in ctl.params().items()}
    return {"worst": worst, "steps": steps[0], "control": control,
            "bit_equal": bit_equal}


def _p24_mnist(tmp: str, device: str) -> dict:
    """mnist_nn ``train 1 --dp`` and ``train 1 --dp --per-batch`` (each in
    its copy of the initial CSVs), K1's launches by variant around each;
    this rank's trained parameters; one resident DP epoch profiled; then
    the DP×TP step on (data 1 x model 2) beside the single-device step on
    the same batch."""
    import numpy as np

    from big_linear_algebra_tpu_torch.data.mnist import MnistDataset
    from big_linear_algebra_tpu_torch.models import mnist_nn
    from big_linear_algebra_tpu_torch.ops import matmul as mm
    from big_linear_algebra_tpu_torch.parallel import (batch_sharding,
                                                       default_mesh,
                                                       make_mesh, spmd)

    cfg = mnist_nn.CONFIG
    models = []

    def spy(real):
        def make(*a, **kw):
            step = real(*a, **kw)

            def wrapped(model, *batch):
                models.append(model)
                return step(model, *batch)
            return wrapped
        return make

    out = {}
    with _wrapped(mnist_nn, "make_train_step_dp", spy):
        for mode, where in (("resident", "mnist"),
                            ("--per-batch", "mnist_pb")):
            args = ["train", "1", "--dp"] + (
                [mode] if mode != "resident" else [])
            _zero_k1_counts(mm)
            models.clear()
            text, secs = _cli(mnist_nn, args, os.path.join(tmp, where),
                              device)
            out[mode] = {
                "counts": dict(mm.variant_launch_counts),
                "total": mm.launch_count, "text": text, "seconds": secs,
                "steps": len(models),
                "params": {k: v.detach().cpu().clone()
                           for k, v in models[-1].params().items()}}
    del os.environ["BLA_DATA_DIR"]

    initial = torch.load(os.path.join(tmp, "mnist_initial.pt"))
    data = MnistDataset.from_csv(os.path.join(tmp, "mnist", "mnist",
                                              "mnist_train.csv"))
    mesh = default_mesh()
    model = mnist_nn.MnistNN.from_params(out["resident"]["params"],
                                         device=mesh.device)
    x_dev = torch.from_numpy(data.x).to(mesh.device)
    y_dev = torch.from_numpy(data.y).to(mesh.device)
    perm = torch.from_numpy(mnist_nn.epoch_permutation(
        np.random.default_rng(1), data.num_examples,
        cfg.batch_size)).to(mesh.device)
    out["replay"] = _p24_mnist_replay(
        mesh, initial, x_dev, y_dev,
        torch.from_numpy(mnist_nn.epoch_permutation(
            np.random.default_rng(cfg.seed), data.num_examples,
            cfg.batch_size)).to(mesh.device),
        out["resident"]["params"])
    epoch = mnist_nn.make_epoch_resident_dp(mesh, cfg)
    out["profile"] = _profile(lambda: epoch(model, x_dev, y_dev, perm),
                              device, n_calls_timed=2)
    out["profile"]["steps"] = perm.numel() // cfg.batch_size

    # DP x TP: (data ranks/2 x model 2), one step from the initial
    # parameters on the first batch
    mesh2 = make_mesh({"data": mesh.size("data") // 2, "model": 2})
    x, onehot, mask = (torch.from_numpy(a).to(mesh.device) for a in
                       mnist_nn._make_batch(data.x[:cfg.batch_size],
                                            data.y[:cfg.batch_size],
                                            cfg.batch_size, cfg.layer_3))
    shards = mnist_nn.place_params_tp(mesh2, initial)
    rows = batch_sharding(mesh2)
    summed = {}

    def keep(real):
        def wrapped(*a, **kw):
            summed.update(real(*a, **kw))
            return summed
        return wrapped

    _zero_k1_counts(mm)
    with _wrapped(spmd, "psum_tree", keep):
        new, correct, ce = mnist_nn.make_train_step_dp_tp(mesh2, cfg)(
            shards, rows(x), rows(onehot), rows(mask))
    _sync(device)
    tp_counts = dict(mm.variant_launch_counts)
    full = mnist_nn.gather_params_tp(mesh2, new)
    tp_grads = mnist_nn.gather_params_tp(mesh2, summed["grads"])
    single = mnist_nn.MnistNN.from_params(initial, device=mesh.device)
    c1, ce1 = mnist_nn.train_step(single, x, onehot, mask, cfg)
    out["tp"] = {"counts": tp_counts,
                 "full": {k: v.cpu() for k, v in full.items()},
                 "grads": {k: v.cpu() for k, v in tp_grads.items()},
                 "single_grads": {k: v.grad.cpu() for k, v in
                                  single.params().items()},
                 "single": {k: v.detach().cpu() for k, v in
                            single.params().items()},
                 "metrics": (float(correct), float(ce), float(c1),
                             float(ce1))}
    return out


def _p24_hinge(tmp: str, device: str) -> dict:
    """mnist_hinge ``train 100 0.0005 --dp`` (rank 0 prints), then the DP
    iterations replayed one by one from the same weights on this rank's
    examples, bit-equal to the CLI's; rank 0 holds each teacher-forced
    against f64 on the whole set (``_hinge_iteration_check``, with the
    ranks' own margins gathered, so the violation set is the card's)."""
    from big_linear_algebra_tpu_torch.data.mnist import MnistDataset
    from big_linear_algebra_tpu_torch.models import mnist_hinge as hinge
    from big_linear_algebra_tpu_torch.parallel import (batch_sharding,
                                                       default_mesh, spmd)

    where = os.path.join(tmp, "hinge")
    last = []

    def spy(real):
        def chunks(*a, **kw):
            last[:] = [real(*a, **kw)]
            return last[0]
        return chunks

    w0 = torch.load(os.path.join(tmp, "hinge_w0.pt"))
    with _wrapped(hinge, "Chunks", spy):
        text, secs = _cli(hinge, ["train", str(HINGE_ITERATIONS),
                                  str(HINGE_LR), "--dp"], where, device)
    del os.environ["BLA_DATA_DIR"]
    mesh = default_mesh()
    data = MnistDataset.from_csv(os.path.join(where, "mnist",
                                              "mnist_train.csv"))
    n_total = data.num_examples
    x_np, labels = hinge.pad_examples(data.x / 255.0, data.y,
                                      mesh.size("data"))
    shard = batch_sharding(mesh)
    x_l = torch.from_numpy(shard(x_np)).to(mesh.device)
    y_l = hinge.signed_targets(torch.from_numpy(shard(labels)).to(
        mesh.device), x_l.dtype)
    x_full = torch.from_numpy(data.x / 255.0)
    y_full = hinge.signed_targets(torch.from_numpy(data.y), x_full.dtype)
    step = hinge.make_train_chunk_dp(mesh, n_total, 1)
    w = w0.to(mesh.device)
    ratios = []
    for _ in range(HINGE_ITERATIONS):
        with torch.no_grad():
            margins = y_l * (x_l @ w)  # the op _chunk computes
            margins = spmd.all_gather(margins, mesh, "data", dim=0)
        nxt, norms = step(w, x_l, y_l, HINGE_LR)
        if mesh.rank == 0:
            ratios.append(_hinge_iteration_check(
                w, nxt, x_full, y_full, HINGE_LR,
                margins=margins[:n_total]))
        w = nxt
        if float(norms.sum()) < hinge.EPSILON:
            break
    return {"text": text, "seconds": secs, "ratios": ratios,
            "bit_equal": torch.equal(w.cpu(), last[0].w.cpu()),
            "iterations": len(ratios) if mesh.rank == 0 else None,
            "profile": _profile(lambda: hinge.make_train_chunk_dp(
                mesh, n_total, hinge.CHUNK)(w, x_l, y_l, HINGE_LR), device)}


def _p24_unet(tmp: str, device: str) -> dict:
    """cifar_unet ``train 1 --dp --image-size=64 --max-steps=20`` (full
    width, bf16 compute, batch 16: 8 per rank) with K2/K2c/K2d's launches
    around it, then ``train 1 --dp --fused-block --max-steps=10`` at 32x32
    (K5a/K5b's launches and routes), then one resumed step; every step's
    loss and a hash of this rank's parameters after each run; then one DP
    step at 64x64 profiled. On the CPU rehearsal, the TINY net."""
    import dataclasses

    from big_linear_algebra_tpu_torch.models import cifar_unet as cu
    from big_linear_algebra_tpu_torch.nn import attention as at
    from big_linear_algebra_tpu_torch.nn import fused_block as fb
    from big_linear_algebra_tpu_torch.nn.optim import adam_init, tree_map
    from big_linear_algebra_tpu_torch.parallel import default_mesh

    where = os.path.join(tmp, "unet")
    mesh = default_mesh()
    world = mesh.size("data")
    # the CPU rehearsal: the TINY net at batch 2 a rank
    tiny = ["--tiny", f"--batch={2 * world}"] if device == "cpu" else []
    losses, last = [], {}

    def spy(real):
        def make(*a, **kw):
            step = real(*a, **kw)

            def wrapped(*args, **kwargs):
                params, opt, loss = step(*args, **kwargs)
                losses.append(loss)
                last["params"] = params
                return params, opt, loss
            return wrapped
        return make

    out = {}
    with _wrapped(cu, "make_train_step_dp", spy):
        at.launch_count = at.bwd_dq_launch_count = 0
        at.bwd_dkv_launch_count = 0
        text, secs = _cli(cu, ["train", "1", "--dp", "--image-size=64",
                               f"--max-steps={P24_UNET_STEPS}", *tiny],
                          where, device)
        out["flash"] = {"K2": at.launch_count, "K2c": at.bwd_dq_launch_count,
                        "K2d": at.bwd_dkv_launch_count, "text": text,
                        "seconds": secs,
                        "losses": torch.stack(losses).float().cpu(),
                        "hash": _params_hash(last["params"])}
        losses.clear()
        _zero_fused_counts(fb)
        text, secs = _cli(cu, ["train", "1", "--dp", "--fused-block",
                               f"--max-steps={P24_FUSED_STEPS}", *tiny],
                          where, device)
        out["fused"] = {
            "counts": (fb.launch_count, fb.tc_launch_count,
                       fb.bwd_launch_count, fb.bwd_tc_launch_count,
                       fb.wgrad_launch_count, fb.wgrad_tc_launch_count),
            "text": text, "seconds": secs,
            "losses": torch.stack(losses).float().cpu(),
            "hash": _params_hash(last["params"])}
        losses.clear()
        text, _ = _cli(cu, ["train", "1", "--dp", "--fused-block",
                            "--max-steps=1", *tiny], where, device)
        out["resumed"] = {"text": text,
                          "losses": torch.stack(losses).float().cpu(),
                          "hash": _params_hash(last["params"])}
    del os.environ["BLA_DATA_DIR"]

    base = (dataclasses.replace(cu.TINY, batch_size=2 * world) if tiny
            else cu.CONFIG)
    cfg = dataclasses.replace(base, image_size=64)
    params = last["params"]
    opt = adam_init(params)
    gen = torch.Generator().manual_seed(24)
    x0 = torch.rand((cfg.batch_size // mesh.size("data"), 3, 64, 64),
                    generator=gen).to(mesh.device) * 2 - 1
    step = cu.make_train_step_dp(mesh, cfg)
    gens = cu.DPGenerators(24, mesh.index("data"), mesh.device)
    out["profile"] = _profile(lambda: step(params, opt, x0, gens), device)
    del params, opt
    out["batch"] = base.batch_size
    out["blocks"] = len(_unet_fused_blocks(base, base.batch_size // world))
    return out


def _ring_check(got, want, dtype, bwd: bool) -> float:
    """Largest error over its bound of ``got`` against ``want`` (the plain
    flash's): bf16 ``RING_BF16_RTOL_OF_MAX`` of max|ref|; f32 phase 5's
    elementwise bound for o, phase 8's for the gradients."""
    got, want = got.double(), want.double()
    if dtype == torch.bfloat16:
        return ((got - want).abs().max() / (RING_BF16_RTOL_OF_MAX
                                            * want.abs().max())).item()
    atol, rtol = ((K2BWD_F32_ATOL, K2BWD_F32_RTOL) if bwd
                  else (K2_F32_ATOL, K2_F32_RTOL))
    return ((got - want).abs() / (atol + rtol * want.abs())).max().item()


def _p24_ring(device: str) -> list:
    """Ring attention over the ranks' ``seq`` axis at each of
    ``P24_RING[device]``: this rank's rows of (B, N, d) inputs drawn alike
    on every rank, forward and backward twice (bit-equal), K2/K2c/K2d's
    launches around the first, each output held against the plain flash
    and its plain backward over the whole sequence, and the pair timed."""
    from big_linear_algebra_tpu_torch.nn import attention as at
    from big_linear_algebra_tpu_torch.parallel import (default_mesh,
                                                       ring_attention)
    from big_linear_algebra_tpu_torch.parallel.sharding import BatchShard

    mesh = default_mesh("seq")
    rows = BatchShard(mesh.index("seq"), mesh.size("seq"))
    results = []
    for b, n, d, dtype in P24_RING[device]:
        gen = torch.Generator().manual_seed(n + d)
        q, k, v, g = (torch.randn(b, n, d, generator=gen).to(
            mesh.device, dtype) for _ in range(4))

        def run():
            leaves = [rows(x, dim=1).clone().requires_grad_()
                      for x in (q, k, v)]
            o = ring_attention(*leaves, mesh, "seq")
            o.backward(rows(g, dim=1))
            return [o.detach()] + [x.grad for x in leaves]

        at.launch_count = at.bwd_dq_launch_count = 0
        at.bwd_dkv_launch_count = 0
        first = run()
        _sync(device)
        launches = (at.launch_count, at.bwd_dq_launch_count,
                    at.bwd_dkv_launch_count)
        second = run()
        equal = all(torch.equal(a, b) for a, b in zip(first, second))
        with torch.no_grad():
            o_ref, lse = at._plain_flash(q, k, v)
            refs = [o_ref, *at._plain_flash_bwd(q, k, v, o_ref, lse, g)]
        ratios = {name: _ring_check(got, rows(ref, dim=1), dtype,
                                    name != "o")
                  for name, got, ref in zip(("o", "dq", "dk", "dv"), first,
                                            refs)}
        del refs, o_ref, lse
        results.append({"shape": (b, n, d), "dtype": str(dtype),
                        "launches": launches, "bit_equal": equal,
                        "ratios": ratios,
                        "profile": _profile(run, device)})
    return results


def _phase24_rank(tmp: str, device: str) -> int:
    """One rank of phase 24 (``chip_smoke.py --phase24-rank TMP DEVICE``
    under ``torch.distributed.run``): joins the group, runs the parts and
    writes its results to ``TMP/rank<r>.pt`` for the launching process.
    The parts hold the eager steps (``graphs.eager()``: over NCCL the
    epochs would replay graphs; phase 28 holds those)."""
    from big_linear_algebra_tpu_torch.parallel import mesh as pmesh
    from big_linear_algebra_tpu_torch.utils import graphs

    rank = pmesh.distributed_init(device=device)
    dev = pmesh.current_device()
    out = {"rank": rank, "device": str(dev), "backend": pmesh.backend(),
           "why": pmesh.select_backend(dev, pmesh.local_world_size())[1]}
    with graphs.eager():
        out["mnist"] = _p24_mnist(tmp, device)
        out["hinge"] = _p24_hinge(tmp, device)
        out["unet"] = _p24_unet(tmp, device)
        out["ring"] = _p24_ring(device)
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    return 0


def _run_ranks(tmp: str, device: str, n: int, args=None,
               phase: str = "phase 24") -> tuple:
    """``python3 -m torch.distributed.run --standalone --nproc-per-node=N
    chip_smoke.py ARGS`` (default ``--phase24-rank TMP DEVICE``) in its own
    process group (killed whole on the time limit): (stdout, seconds)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={n}", os.path.abspath(__file__),
           *(args or ["--phase24-rank", tmp, device])]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=P24_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        stdout, stderr = proc.communicate()
        fail(f"{phase}: the ranks did not end within {P24_TIMEOUT_S} s:\n"
             f"{stdout[-4000:]}\n{stderr[-8000:]}")
    if proc.returncode != 0:
        fail(f"{phase}: torch.distributed.run exited {proc.returncode}:\n"
             f"{stdout[-6000:]}\n{stderr[-10000:]}")
    return stdout, time.perf_counter() - t0


def _p24_prepare(tmp: str, device: str) -> dict:
    """The ranks' inputs in ``tmp``: mnist_nn ``init`` with the 8192-image
    set (a copy for ``--per-batch``), mnist_hinge ``init`` on a copy of the
    set, and the CIFAR batches with ``cifar_unet init`` (full width; TINY
    on the CPU rehearsal)."""
    import shutil

    from big_linear_algebra_tpu_torch.data import synth
    from big_linear_algebra_tpu_torch.models import cifar_unet as cu
    from big_linear_algebra_tpu_torch.models import mnist_hinge as hinge
    from big_linear_algebra_tpu_torch.models import mnist_nn

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mnist = os.path.join(tmp, "mnist")
        os.environ["BLA_DATA_DIR"] = mnist
        synth.ensure_mnist(mnist)
        if mnist_nn.main(["init"]) != 0:
            fail(f"mnist_nn init:\n{out.getvalue()}")
        initial = mnist_nn.load_params_csv()
        torch.save(initial, os.path.join(tmp, "mnist_initial.pt"))
        shutil.copytree(mnist, os.path.join(tmp, "mnist_pb"))
        where = os.path.join(tmp, "hinge")
        shutil.copytree(os.path.join(mnist, "mnist"),
                        os.path.join(where, "mnist"))
        os.environ["BLA_DATA_DIR"] = where
        if hinge.main(["init"]) != 0:
            fail(f"mnist_hinge init:\n{out.getvalue()}")
        w0 = hinge.load_weights()
        torch.save(w0, os.path.join(tmp, "hinge_w0.pt"))
        where = os.path.join(tmp, "unet")
        os.environ["BLA_DATA_DIR"] = where
        synth.ensure_cifar(where)
        t0 = time.perf_counter()
        if cu.main(["init"] + (["--tiny"] if device == "cpu" else [])) != 0:
            fail(f"cifar_unet init:\n{out.getvalue()}")
        init_s = time.perf_counter() - t0
        del os.environ["BLA_DATA_DIR"]
    return {"initial": initial, "w0": w0, "init_s": init_s}


def _mnist_f64_epoch(initial, tmp: str):
    """The single-device epoch of ``train 1`` in f64 on the CPU from the
    same CSVs and permutation (the plain path), as phase 22 computes it."""
    import numpy as np

    from big_linear_algebra_tpu_torch.data.mnist import MnistDataset
    from big_linear_algebra_tpu_torch.models import mnist_nn

    cfg = mnist_nn.CONFIG
    data = MnistDataset.from_csv(os.path.join(tmp, "mnist", "mnist",
                                              "mnist_train.csv"))
    model = mnist_nn.MnistNN.from_params(initial, device="cpu",
                                         dtype=torch.float64)
    perm = mnist_nn.epoch_permutation(np.random.default_rng(cfg.seed),
                                      data.num_examples, cfg.batch_size)
    mnist_nn.epoch_step_resident(model, torch.from_numpy(data.x).double(),
                                 torch.from_numpy(data.y),
                                 torch.from_numpy(perm), cfg)
    return {k: v.detach() for k, v in model.params().items()}, data


def _of_update(got, ref, initial) -> dict:
    """max|got - ref| / max|ref - initial| per leaf."""
    return {k: ((got[k].double() - ref[k]).abs().max()
                / (ref[k] - initial[k].double()).abs().max()).item()
            for k in ref}


def _p24_check_mnist(ranks, prep, tmp, device) -> list:
    from big_linear_algebra_tpu_torch.models import mnist_nn

    cfg = mnist_nn.CONFIG
    ref, data = _mnist_f64_epoch(prep["initial"], tmp)
    steps = -(-data.num_examples // cfg.batch_size)
    world = len(ranks)
    local = cfg.batch_size // world
    want = (_k1_counts(train_step_gemms(cfg.sizes, local), steps)
            if device == "cuda" else {"nn": 0, "nt": 0, "tn": 0})
    lines = []
    ratios = {}
    for mode in ("resident", "--per-batch"):
        runs = [r["mnist"][mode] for r in ranks]
        for r, run in enumerate(runs):
            if run["counts"] != want:
                fail(f"mnist_nn train 1 --dp {mode} on rank {r}: K1 launched "
                     f"{run['counts']}, expected {want} ({steps} steps of "
                     f"batch {local} per rank, _SMALL_FLOPS)")
            if run["steps"] != steps:
                fail(f"mnist_nn train 1 --dp {mode}: {run['steps']} DP "
                     f"steps on rank {r}, expected {steps}")
            for k, v in run["params"].items():
                if not (torch.isfinite(v).all() and torch.equal(
                        v.view(torch.int32),
                        runs[0]["params"][k].view(torch.int32))):
                    fail(f"mnist_nn train 1 --dp {mode}: {k} on rank {r} "
                         f"not bit-equal to rank 0's (or not finite)")
        ratios[mode] = _of_update(runs[0]["params"], ref, prep["initial"])
        if not max(ratios[mode].values()) <= TRAIN_RTOL_OF_UPDATE:
            fail(f"mnist_nn train 1 --dp {mode} against the single-device "
                 f"f64 epoch on the CPU, max|err| / max|update| per leaf "
                 f"{ratios[mode]} > {TRAIN_RTOL_OF_UPDATE}")
    line = _epoch_line(ranks[0]["mnist"]["resident"]["text"], 0)
    pb = _epoch_line(ranks[0]["mnist"]["--per-batch"]["text"], 0)
    for r, rank in enumerate(ranks[1:], start=1):
        for mode in ("resident", "--per-batch"):
            if "epoch:" in rank["mnist"][mode]["text"]:
                fail(f"mnist_nn train --dp: rank {r} printed metrics")
    lines.append(
        f"[24 mnist_nn dp] train 1 --dp on {world} ranks ({steps} steps, "
        f"batch {cfg.batch_size} = {world} x {local}): K1 launches per "
        f"rank {ranks[0]['mnist']['resident']['counts']} (expected {want} "
        f"from the local shapes and _SMALL_FLOPS), the same with "
        f"--per-batch; replicas bit-equal; avg_loss {line['avg_loss']}, "
        f"{float(line['images_per_sec']):.1f} images/s (--per-batch "
        f"{float(pb['images_per_sec']):.1f}); against the single-device f64 "
        f"epoch, max|err| / max|update| per leaf "
        + ", ".join(f"{k} {v:.3e}" for k, v in ratios["resident"].items())
        + " (--per-batch "
        + ", ".join(f"{k} {v:.3e}" for k, v in ratios["--per-batch"].items())
        + f"; tol {TRAIN_RTOL_OF_UPDATE})")

    # the epoch step by step: each rank's gradients teacher-forced against
    # f64 with the card's ReLU decisions, and the control
    for r, rank in enumerate(ranks):
        rp = rank["mnist"]["replay"]
        if not rp["bit_equal"] or rp["steps"] != steps:
            fail(f"mnist_nn DP epoch replayed on rank {r}: {rp['steps']} "
                 f"steps (expected {steps}), trained leaves bit-equal to "
                 f"train 1 --dp's: {rp['bit_equal']}")
        over = {k: v for k, v in rp["worst"].items()
                if not v[0] <= DP_GRAD_RTOL_OF_MAX}
        if over:
            fail(f"mnist_nn DP step on rank {r}: the local gradient against "
                 f"f64 at the same parameters with the card's ReLU "
                 f"decisions, max|err| / max|ref| (step) {over} > "
                 f"{DP_GRAD_RTOL_OF_MAX}")
        if not max(rp["control"].values()) > DP_GRAD_RTOL_OF_MAX:
            fail(f"mnist_nn DP step on rank {r}: the control (operands "
                 f"truncated to TF32) passes the bound "
                 f"{DP_GRAD_RTOL_OF_MAX}: {rp['control']}")
    lines.append(
        f"[24 mnist_nn dp steps] the DP epoch replayed from the initial CSVs"
        f" bit-equal to train 1 --dp on every rank; each of its {steps} "
        f"steps' local gradient (batch {local}, the all-reduce's input) "
        f"against f64 at the same parameters with the card's ReLU "
        f"decisions, worst max|err| / max|ref| per leaf (step): "
        + "; ".join(f"rank {r} " + ", ".join(
            f"{k} {v:.3e} ({s_})" for k, (v, s_) in
            rank["mnist"]["replay"]["worst"].items())
            for r, rank in enumerate(ranks))
        + f" (tol {DP_GRAD_RTOL_OF_MAX}); the control, the first step's "
        f"gradient from operands truncated to TF32, rank 0: "
        + ", ".join(f"{k} {v:.3e}" for k, v in
                    ranks[0]["mnist"]["replay"]["control"].items())
        + " (must exceed the tol)")

    # DP x TP against the single-device step, and both against f64
    tp = ranks[0]["mnist"]["tp"]
    n_data = world // 2  # the DP x TP step's (data, model 2) mesh
    want_tp = (_k1_counts(tp_step_gemms(cfg.sizes, cfg.batch_size // n_data,
                                        2))
               if device == "cuda" else {"nn": 0, "nt": 0, "tn": 0})
    x, onehot, mask = (torch.from_numpy(a).double() for a in
                       mnist_nn._make_batch(data.x[:cfg.batch_size],
                                            data.y[:cfg.batch_size],
                                            cfg.batch_size, cfg.layer_3))
    model64 = mnist_nn.MnistNN.from_params(prep["initial"],
                                           dtype=torch.float64)
    mnist_nn.train_step(model64, x, onehot, mask, cfg)
    ref64 = {k: v.detach() for k, v in model64.params().items()}
    tp_ratio = _of_update(tp["full"], ref64, prep["initial"])
    single_ratio = _of_update(tp["single"], ref64, prep["initial"])
    grad_ratio = {k: _of_max(tp["grads"][k], v.double())
                  for k, v in tp["single_grads"].items()}
    for r, rank in enumerate(ranks):
        t = rank["mnist"]["tp"]
        if t["counts"] != want_tp:
            fail(f"the DP x TP step on rank {r}: K1 launched {t['counts']}, "
                 f"expected {want_tp} (column shards of 2)")
        for k, v in t["full"].items():
            if not (torch.equal(v, tp["full"][k])
                    and torch.equal(t["grads"][k], tp["grads"][k])):
                fail(f"the DP x TP step: gathered {k} (or its gradient) on "
                     f"rank {r} differs from rank 0's")
    if not max(grad_ratio.values()) <= DP_GRAD_RTOL_OF_MAX:
        fail(f"the DP x TP step's gathered gradient against the "
             f"single-device step's on the same batch, max|err| / max|ref| "
             f"per leaf {grad_ratio} > {DP_GRAD_RTOL_OF_MAX}")
    if not max(tp_ratio.values()) <= TRAIN_RTOL_OF_UPDATE:
        fail(f"the DP x TP step against the f64 step, max|err| / "
             f"max|update| per leaf {tp_ratio} > {TRAIN_RTOL_OF_UPDATE}")
    c, ce, c1, ce1 = tp["metrics"]
    if c != c1:
        fail(f"the DP x TP step counts {c} correct, the single-device step "
             f"{c1}")
    lines.append(
        f"[24 mnist_nn dp x tp] one step on (data {n_data} x model 2), "
        f"batch {cfg.batch_size}: K1 launches per rank {tp['counts']} "
        f"(expected {want_tp} at the column shards); the gathered leaves "
        f"equal on every rank; the gathered gradient against the "
        f"single-device step's on the card, max|err| / max|ref| per leaf "
        + ", ".join(f"{k} {v:.3e}" for k, v in grad_ratio.items())
        + f" (tol {DP_GRAD_RTOL_OF_MAX}); against the single-device f64 "
        f"step, max|err| / max|update| per leaf "
        + ", ".join(f"{k} {v:.3e}" for k, v in tp_ratio.items())
        + " (the single-device step on the card: "
        + ", ".join(f"{k} {v:.3e}" for k, v in single_ratio.items())
        + f"; tol {TRAIN_RTOL_OF_UPDATE}); ce {ce:.6f} vs {ce1:.6f}")
    return lines


def _p24_check_hinge(ranks, prep, tmp) -> list:
    import numpy as np

    from big_linear_algebra_tpu_torch.data.mnist import MnistDataset
    from big_linear_algebra_tpu_torch.models import mnist_hinge as hinge

    h0 = ranks[0]["hinge"]
    text = h0["text"]
    conv = re.search(r"converged < epsilon after iteration (\d+)", text)
    conv = None if conv is None else int(conv.group(1))
    if "Finished training" not in text or any(
            r["hinge"]["text"] for r in ranks[1:]):
        fail(f"mnist_hinge train --dp: rank 0 must print, and only it:\n"
             f"{text}")
    for r, rank in enumerate(ranks):
        if not rank["hinge"]["bit_equal"]:
            fail(f"mnist_hinge --dp: the replayed iterations on rank {r} are "
                 f"not bit-equal to train's")
    data = MnistDataset.from_csv(os.path.join(tmp, "hinge", "mnist",
                                              "mnist_train.csv"))
    x64 = torch.from_numpy(data.x / 255.0).double()
    y64 = hinge.signed_targets(torch.from_numpy(data.y), torch.float64)
    w, ref_conv = prep["w0"].double(), None
    for start in range(0, HINGE_ITERATIONS, hinge.CHUNK):
        w, norms = hinge.train_chunk(w, x64, y64, HINGE_LR,
                                     min(hinge.CHUNK, HINGE_ITERATIONS - start))
        hit = (norms.sum(dim=1) < hinge.EPSILON).nonzero()
        if len(hit):
            ref_conv = start + int(hit[0])
            break
    if conv != ref_conv:
        fail(f"mnist_hinge train --dp: converged at {conv} on the card, at "
             f"{ref_conv} in f64 on the CPU")
    ratios = np.asarray(h0["ratios"])
    if not ratios.max() <= 1.0:
        fail(f"mnist_hinge train --dp, teacher-forced against f64: iteration"
             f" {int(ratios.argmax())} at {ratios.max()} of its bound")
    return [f"[24 mnist_hinge dp] train {HINGE_ITERATIONS} {HINGE_LR} --dp on "
            f"{len(ranks)} ranks ({data.num_examples // len(ranks)} examples "
            f"each): converged "
            f"{'at ' + str(conv) if conv is not None else 'never'} on the "
            f"card and in f64; {len(ratios)} iterations replayed bit-equal on "
            f"every rank, each teacher-forced against f64 at median "
            f"{np.median(ratios):.3e}, max {ratios.max():.3e} of its f32 "
            f"bound; rank 0 alone printed; train {h0['seconds']:.3f} s of "
            f"host wall"]


def _falls(losses: torch.Tensor, what: str) -> tuple:
    k = len(losses) // 4 or 1
    head, tail = losses[:k].mean().item(), losses[-k:].mean().item()
    if not (torch.isfinite(losses).all() and tail < head):
        fail(f"{what}: losses not finite or not falling: {losses.tolist()}")
    return head, tail, k


def _p24_check_unet(ranks, device) -> list:
    lines = []
    u0 = ranks[0]["unet"]
    n_fused, batch = u0["blocks"], u0["batch"]
    world = len(ranks)
    local = batch // world
    for part in ("flash", "fused", "resumed"):
        hashes = {r["unet"][part]["hash"] for r in ranks}
        if len(hashes) != 1:
            fail(f"cifar_unet train --dp ({part}): the replicas' parameters "
                 f"differ after the run (hashes {hashes})")
        for r, rank in enumerate(ranks):
            if not torch.equal(rank["unet"][part]["losses"],
                               u0[part]["losses"]):
                fail(f"cifar_unet train --dp ({part}): rank {r}'s pmean'd "
                     "losses differ from rank 0's")
    per = 4 if device == "cuda" else 0
    for r, rank in enumerate(ranks):
        f = rank["unet"]["flash"]
        got = (f["K2"], f["K2c"], f["K2d"])
        if got != (per * P24_UNET_STEPS,) * 3:
            fail(f"cifar_unet train --dp --image-size=64 on rank {r}: K2/K2c/"
                 f"K2d launched {got}, expected {per * P24_UNET_STEPS} each "
                 f"(4 flash sites x {P24_UNET_STEPS} steps)")
        want = (n_fused * P24_FUSED_STEPS if device == "cuda" else 0,) * 6
        if rank["unet"]["fused"]["counts"] != want:
            fail(f"cifar_unet train --dp --fused-block on rank {r}: K5a/its "
                 f"tensor-core route/K5b data/its tensor-core route/K5b "
                 f"weight gradients/their tensor-core route launched "
                 f"{rank['unet']['fused']['counts']}, expected {want} "
                 f"({n_fused} fused blocks at batch {local} per rank x "
                 f"{P24_FUSED_STEPS} steps)")
    fl = u0["flash"]
    if len(fl["losses"]) != P24_UNET_STEPS:
        fail(f"{len(fl['losses'])} DP steps at 64x64, expected "
             f"{P24_UNET_STEPS}")
    head, tail, k = _falls(fl["losses"], "train --dp --image-size=64")
    ep0 = _epoch_line(fl["text"], 0)
    fu = u0["fused"]
    if not (len(fu["losses"]) == P24_FUSED_STEPS
            and torch.isfinite(fu["losses"]).all()):
        fail(f"train --dp --fused-block: {P24_FUSED_STEPS} finite step "
             f"losses expected, got {fu['losses'].tolist()}")
    resumed = (f"resumed train state at step "
               f"{P24_UNET_STEPS + P24_FUSED_STEPS} (epoch 2)")
    if resumed not in u0["resumed"]["text"] or len(
            u0["resumed"]["losses"]) != 1:
        fail(f"the third train --dp did not resume at epoch 2:\n"
             f"{u0['resumed']['text']}")
    for r, rank in enumerate(ranks[1:], start=1):
        if any(rank["unet"][p]["text"] for p in ("flash", "fused",
                                                   "resumed")):
            fail(f"cifar_unet train --dp: rank {r} printed")
    lines.append(
        f"[24 unet dp] train 1 --dp --image-size=64 --max-steps="
        f"{P24_UNET_STEPS} on {world} ranks (batch {batch} = {world} x "
        f"{local}, {'TINY, f32' if device == 'cpu' else 'full width, bf16'} "
        f"compute, f32 masters): launches per rank "
        f"K2 {fl['K2']}, K2c {fl['K2c']}, K2d {fl['K2d']} ({per} each a "
        f"step); loss mean of steps 1-{k} {head:.5f}, of the last {k} "
        f"{tail:.5f}; replicas bit-equal; epoch {ep0['epoch_seconds']} s "
        f"({ep0['images_per_sec']} images/s). train 1 --dp --fused-block "
        f"--max-steps={P24_FUSED_STEPS} (32x32): K5a/tc/K5b data/tc/K5b "
        f"weights/tc per rank {fu['counts']} ({n_fused} fused blocks a step "
        f"at batch {local}, every launch on the tensor-core "
        f"route); losses finite (mean {fu['losses'].mean().item():.5f}); "
        f"replicas bit-equal; "
        f"then '{resumed}', step loss {u0['resumed']['losses'][0]:.5f}, "
        f"replicas bit-equal")
    return lines


def _p24_check_ring(ranks, device) -> list:
    lines = []
    world = len(ranks)
    for i, case in enumerate(ranks[0]["ring"]):
        for r, rank in enumerate(ranks):
            c = rank["ring"][i]
            if c["launches"] != ((world,) * 3 if device == "cuda"
                                 else (0, 0, 0)):
                fail(f"ring attention {case['shape']} {case['dtype']} on "
                     f"rank {r}: K2/K2c/K2d launched {c['launches']}, "
                     f"expected {world} each (one per rotation)")
            if not c["bit_equal"]:
                fail(f"ring attention {case['shape']} {case['dtype']} on "
                     f"rank {r}: two runs not bit-equal")
            if not max(c["ratios"].values()) <= 1.0:
                fail(f"ring attention {case['shape']} {case['dtype']} on "
                     f"rank {r} against the plain flash over the whole "
                     f"sequence: error / bound {c['ratios']}")
        worst = {k: max(rank["ring"][i]["ratios"][k] for rank in ranks)
                 for k in ("o", "dq", "dk", "dv")}
        b, n, d = case["shape"]
        lines.append(
            f"[24 ring attention] {case['dtype']} (B, N, d) = {(b, n, d)}, "
            f"{n // world} rows per rank: K2, K2c, K2d launched "
            f"{case['launches']} per rank (one each per rotation); two runs "
            f"bit-equal; against the plain flash and its backward over the "
            f"whole sequence, error / bound "
            + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
            + (f" (bound {RING_BF16_RTOL_OF_MAX} of max|ref|)"
               if "bfloat16" in case["dtype"] else
               " (phase 5's bound for o, phase 8's for the gradients)"))
    return lines


def _p24_profile_lines(ranks, device, smi_line: str) -> list:
    lines = []
    parts = [("mnist_nn resident DP epoch", lambda r: r["mnist"]["profile"]),
             ("mnist_hinge DP chunk (10 iterations)",
              lambda r: r["hinge"]["profile"]),
             ("cifar_unet DP step, 64x64", lambda r: r["unet"]["profile"])]
    parts += [(f"ring attention forward + backward {c['dtype']} "
               f"{c['shape']}", (lambda i: lambda r: r["ring"][i]["profile"])
               (i)) for i, c in enumerate(ranks[0]["ring"])]
    for what, get in parts:
        for r, rank in enumerate(ranks):
            p = get(rank)
            busy = ("" if p["busy_ms"] is None else
                    f"; device busy {p['busy_ms']:.3f} ms = "
                    f"{p['busy_ms'] / p['host_ms']:.1%} of the host time")
            steps = p.get("steps")
            per_step = ("" if not steps else
                        f" = {p['host_ms'] / steps * 1e3:.2f} us per step")
            lines.append(
                f"[24 profile] {what}, rank {r} ({rank['device']}, "
                f"{rank['backend']}): host wall {p['host_ms']:.3f} ms"
                f"{per_step}{busy}; "
                f"{p['coll_calls'] / (steps or 1):.1f} collectives per "
                f"{'step' if steps else 'call'} | {smi_line}")
    return lines


def _p24_gloo_rule(ranks, device) -> list:
    """Ranks that share a card over gloo: rank 0 alone printed the stated
    rule for each ``--dp`` CLI (mnist_nn, mnist_hinge, cifar_unet), whose
    steps ran eagerly (the counts the other checks hold)."""
    from big_linear_algebra_tpu_torch.utils import graphs

    if device != "cuda" or ranks[0]["backend"] != "gloo":
        return []
    rule = f"--dp: eager steps ({graphs.GLOO})"
    texts = [(r["mnist"]["resident"]["text"], r["hinge"]["text"],
              r["unet"]["flash"]["text"]) for r in ranks]
    if not all(rule in t for t in texts[0]) or any(
            rule in t for other in texts[1:] for t in other):
        fail(f"phase 24: rank 0 did not print {rule!r} for every --dp CLI "
             f"(or another rank did)")
    return [f"[24 gloo rule] rank 0 printed {rule!r} for mnist_nn, "
            f"mnist_hinge and cifar_unet train --dp; their steps ran eagerly"]


def phase_parallel(smi_line: str = "", device: str = "cuda",
                   n_ranks: int = P24_RANKS) -> None:
    """Phase 24: the data- and sequence-parallel modes, ``n_ranks`` ranks
    (``P24_RANKS`` = 2) launched with ``python3 -m torch.distributed.run
    --standalone --nproc-per-node=2`` (``_phase24_rank``): mnist_nn
    ``train 1 --dp`` and ``--per-batch`` (K1's launches per rank derived
    from the local shapes, the replicas bit-equal, each leaf within
    ``TRAIN_RTOL_OF_UPDATE`` of its update from the single-device f64
    epoch), the DP×TP step on (data ranks/2 x model 2), mnist_hinge ``train 100 0.0005 --dp`` (each
    iteration teacher-forced against f64), cifar_unet ``train 1 --dp`` at
    64x64 and with ``--fused-block`` at 32x32 plus a resumed step (finite,
    falling losses, replicas bit-equal, K2/K2c/K2d and K5a/K5b launches per
    rank), ring attention (bf16 (4, 8192, 64), f32 (2, 2048, 16); K2,
    K2c and K2d P times each per rank, two runs bit-equal, within the
    bounds of the plain flash over the whole sequence); each rank's host
    wall, busy share and collectives."""
    with tempfile.TemporaryDirectory(prefix="bla_smoke_") as tmp:
        prep = _p24_prepare(tmp, device)
        stdout, seconds = _run_ranks(tmp, device, n_ranks)
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=False) for r in range(n_ranks)]
        how = ("every collective and ring hop staged through host memory"
               if ranks[0]["backend"] == "gloo"
               else "NCCL on the device buffers")
        lines = [f"[24 launch] python3 -m torch.distributed.run --standalone "
                 f"--nproc-per-node={n_ranks}: "
                 + "; ".join(f"rank {r['rank']} on {r['device']}"
                             for r in ranks)
                 + f", backend {ranks[0]['backend']} ({ranks[0]['why']}): "
                 f"{how}; {seconds:.1f} s of wall for the launch "
                 f"(cifar_unet init {prep['init_s']:.2f} s before it)"]
        lines += _p24_gloo_rule(ranks, device)
        lines += _p24_check_mnist(ranks, prep, tmp, device)
        lines += _p24_check_hinge(ranks, prep, tmp)
        lines += _p24_check_unet(ranks, device)
        lines += _p24_check_ring(ranks, device)
        lines += _p24_profile_lines(ranks, device, smi_line)
    for line in lines:
        print(line, flush=True)


# ---------------------------------------------------------------------------
# Phase 25: the U-Net's tensor parallelism (P25_TP_RANKS ranks) and the
# pipeline modes (3 ranks; PP×DP on 6), under torch.distributed.run, after
# phase 24 and with its launcher.
# ---------------------------------------------------------------------------

P25_TP_RANKS, P25_PP_RANKS, P25_PPDP_RANKS = 2, 3, 6
# train steps of each CLI run: --tp and --pp at 64x64, --fused-block --pp
# at 32x32, --pp --dp --fused-block at 32x32
P25_TP_STEPS, P25_PP_STEPS, P25_FUSED_STEPS, P25_PPDP_STEPS = 5, 5, 5, 3
P25_MICRO = 4
# The f32 gradient of a TP step (gathered) against the single-device one,
# and of a pipeline step (GPipe, 1F1B) against the sequential run of its
# stages with the same folds, each on the card at the same parameters,
# draws and masks: max|err| / max|ref| per leaf. Fixed before the first
# run: these change only the order of f32 sums (TP: the input gradient of
# a sharded conv summed over the ranks; the pipeline: the microbatches'
# parameter gradients), as phase 10's K2c/K2d-vs-plain backward does,
# whose worst leaf reads 1.3e-4 of its max|ref| on the conditioned net
# (GRAD_SHARE_RTOL_OF_MAX, the same bound; NVIDIA H100 80GB HBM3, 700 W).
# The control, the single-device (sequential) gradient from parameters and
# inputs truncated to TF32's 10-bit mantissa, must fail it: phase 10 reads
# f32 against f64 at 1.4e-2 there, the amplified f32 rounding, and TF32
# rounds 2**13 times coarser.
PARALLEL_GRAD_RTOL_OF_MAX = GRAD_SHARE_RTOL_OF_MAX
P25_TIMEOUT_S = 900


def _p25_cfg(device: str, **kw):
    """Full width at 64x64 (TINY at batch 4 on the CPU rehearsal)."""
    import dataclasses

    from big_linear_algebra_tpu_torch.models import cifar_unet as cu

    base = (dataclasses.replace(cu.TINY, batch_size=4) if device == "cpu"
            else cu.CONFIG)
    return dataclasses.replace(base, **{"image_size": 64, **kw})


def _tiny(device: str) -> list:
    return ["--tiny", "--batch=4"] if device == "cpu" else []


@contextlib.contextmanager
def _p25_masks(cu, seed: int):
    """The U-Net's dropout with call i's mask drawn on the CPU from a
    generator of (seed, i): the same masks on every rank and in the
    single-device or sequential reference."""
    calls = [0]

    def dropout(x, rate, generator, deterministic=False):
        if deterministic or rate == 0.0:
            return x
        gen = torch.Generator().manual_seed(seed * 1000 + calls[0])
        calls[0] += 1
        mask = (torch.rand(x.shape, generator=gen) < 1.0 - rate).to(x.device)
        return torch.where(mask, x / (1.0 - rate), 0.0).to(x.dtype)

    with _wrapped(cu, "dropout", lambda real: dropout):
        yield calls


def _p25_inputs(cu, cfg, mesh, batch: int, seed: int):
    """(params, x0, t, noise) on this rank's device, alike on every rank:
    the initial parameters with each attention site conditioned
    (``_condition_attention``), as rank 0 holds them."""
    import dataclasses

    from big_linear_algebra_tpu_torch.parallel import replicate

    gen = torch.Generator().manual_seed(seed)
    x0 = torch.rand(batch, 3, cfg.image_size, cfg.image_size,
                    generator=gen) * 2 - 1
    tt = torch.randint(0, cfg.timesteps, (batch,), generator=gen)
    noise = torch.randn(x0.shape, generator=gen)
    params = cu.init_params(torch.Generator().manual_seed(seed), cfg)
    dev = mesh.device
    params, _ = _condition_attention(
        cu, params, x0, tt, noise, dataclasses.replace(cfg, dropout_rate=0.0),
        dev)
    return replicate(mesh, params), x0.to(dev), tt.to(dev), noise.to(dev)


def _grad_errors(got: dict, want: dict) -> tuple:
    """(worst leaf max|got − want| / its max|want|, its path)."""
    from big_linear_algebra_tpu_torch.nn.optim import tree_leaves

    worst, where = 0.0, ""
    for i, (a, b) in enumerate(zip(tree_leaves(got), tree_leaves(want))):
        scale = b.double().abs().max().item()
        err = (a.double() - b.double()).abs().max().item()
        ratio = err / scale if scale > 0 else err
        if ratio > worst:
            worst, where = ratio, i
    return worst, where


def _tf32_tree(cu, tree):
    return cu.tree_map(lambda a: _tf32(a.float()), tree)


def _flash_counts(at) -> tuple:
    return at.launch_count, at.bwd_dq_launch_count, at.bwd_dkv_launch_count


def _zero_flash_counts(at) -> None:
    at.launch_count = at.bwd_dq_launch_count = at.bwd_dkv_launch_count = 0


def _spy_steps(cu, name: str, record: dict):
    """``cu.<name>`` (a step factory) wrapped so that every step's loss and
    the last step's parameters land in ``record``."""
    def make(real):
        def factory(*a, **kw):
            step = real(*a, **kw)

            def wrapped(*args, **kwargs):
                params, opt, loss = step(*args, **kwargs)
                record.setdefault("losses", []).append(loss)
                record["params"] = params
                return params, opt, loss
            return wrapped
        return factory
    return _wrapped(cu, name, make)


def _run_cli_counted(cu, at, fb, args, where, device, spy: str) -> dict:
    """One CLI run with the flash and fused counts read around it, its
    step losses, and a hash of this rank's parameters after it."""
    record = {}
    _zero_flash_counts(at)
    _zero_fused_counts(fb)
    with _spy_steps(cu, spy, record):
        text, secs = _cli(cu, args, where, device)
    return {"flash": _flash_counts(at),
            "fused": (fb.launch_count, fb.tc_launch_count,
                      fb.bwd_launch_count, fb.bwd_tc_launch_count,
                      fb.wgrad_launch_count, fb.wgrad_tc_launch_count),
            "text": text, "seconds": secs,
            "losses": torch.stack(record["losses"]).float().cpu(),
            "hash": _params_hash(record["params"])}


def _profile_step(fn, device: str, n_timed: int = 2) -> dict:
    """``_profile`` of ``fn`` plus, for one call after it (warm), the bytes
    each kind of collective moved."""
    from big_linear_algebra_tpu_torch.parallel import spmd

    out = _profile(fn, device, n_calls_timed=n_timed)
    b0 = dict(spmd.collective_bytes)
    fn()
    _sync(device)
    out.update(bytes={k: v - b0[k]
                      for k, v in spmd.collective_bytes.items()})
    return out


def _unit_timer(seconds: list, device: str):
    """A wrap for ``_wrapped`` that adds each call's host time between two
    device synchronizations to ``seconds[0]``: a pipeline stage's units
    (``_Stage.run``, a forward or a recompute, and ``_Stage.vjp``)."""
    def wrap(real):
        def timed(*args, **kwargs):
            _sync(device)
            t0 = time.perf_counter()
            out = real(*args, **kwargs)
            _sync(device)
            seconds[0] += time.perf_counter() - t0
            return out
        return timed
    return wrap


def _p25_tp(tmp: str, device: str) -> dict:
    """One TP rank: ``train 1 --tp --image-size=64`` (K2/K2c/K2d around
    it); the f32 gradient of a TP step on (data 1 x model 2), gathered,
    and a DP×TP step's Adam moments, each against the single-device step on
    the same card (rank 0, with a TF32 control); a bf16 TP step profiled."""
    import dataclasses

    from big_linear_algebra_tpu_torch.models import cifar_unet as cu
    from big_linear_algebra_tpu_torch.nn import attention as at
    from big_linear_algebra_tpu_torch.nn import fused_block as fb
    from big_linear_algebra_tpu_torch.nn.optim import adam_init
    from big_linear_algebra_tpu_torch.parallel import make_mesh

    out = {"cli": _run_cli_counted(
        cu, at, fb, ["train", "1", "--tp", "--image-size=64",
                     f"--max-steps={P25_TP_STEPS}", *_tiny(device)],
        os.path.join(tmp, "tp"), device, "make_train_step_tp")}
    del os.environ["BLA_DATA_DIR"]
    mesh = make_mesh({"data": 1, "model": P25_TP_RANKS})
    rank0 = mesh.rank == 0
    cfg = _p25_cfg(device, compute_dtype="float32")
    params, x0, tt, noise = _p25_inputs(cu, cfg, mesh, 4, 25)
    specs = cu.tp_param_specs(params, P25_TP_RANKS)
    layout = cu.TPLayout(mesh, specs)
    draws = (tt, noise)
    with _p25_masks(cu, 1):
        loss_tp, grads = cu._loss_and_grads(layout.place(params), x0, None,
                                            cfg, draws, layout)
    grads = layout.gather(grads)
    with _p25_masks(cu, 2):
        step = cu.make_train_step_tp(mesh, specs, cfg, data_axis="data")
        p, opt = cu.place_dp_tp(mesh, params, adam_init(params))
        p, opt, loss_dptp = step(p, opt, x0, torch.Generator().manual_seed(3),
                                 draws=draws)
    p, opt = cu.gather_tp(layout, p, opt)
    if rank0:
        with _p25_masks(cu, 1):
            loss_1, want = cu._loss_and_grads(params, x0, None, cfg, draws)
        with _p25_masks(cu, 1):
            _, ctl = cu._loss_and_grads(_tf32_tree(cu, params), _tf32(x0),
                                        None, cfg, draws)
        with _p25_masks(cu, 2):
            p1, opt1, loss_1s = cu.train_step(params, adam_init(params), x0,
                                              None, cfg, draws=draws)
        out["grad"] = {
            "tp": _grad_errors(grads, want), "control": _grad_errors(ctl,
                                                                     want),
            "dptp m": _grad_errors(opt.m, opt1.m),
            "dptp params": max((a - b).abs().max().item() for a, b in zip(
                cu.tree_leaves(p), cu.tree_leaves(p1))),
            "losses": (loss_tp.item(), loss_1.item(), loss_dptp.item(),
                       loss_1s.item()),
            "leaves": len(cu.tree_leaves(want))}
    del params, grads, p, opt
    # one bf16 TP step at the CLI's shapes, profiled
    cfg16 = _p25_cfg(device)
    full = cu.tree_map(lambda a: a.to(mesh.device),
                       cu.init_params(torch.Generator().manual_seed(0),
                                      cfg16))
    p, opt = cu.place_tp(mesh, full, adam_init(full))
    step = cu.make_train_step_tp(mesh, specs, cfg16)
    gen = torch.Generator(device=mesh.device).manual_seed(5)
    xb = torch.rand((cfg16.batch_size, 3, 64, 64), generator=gen,
                    device=mesh.device) * 2 - 1
    out["profile"] = _profile_step(lambda: step(p, opt, xb, gen), device)
    return out


def _stage_fused_blocks(cfg, mb: int) -> list:
    """The fused blocks of each pipeline stage at microbatch ``mb`` under
    ``--fused-block`` (the gate's, as ``_unet_fused_blocks`` lists them):
    [down, mid, up]."""
    import dataclasses

    from big_linear_algebra_tpu_torch.models import cifar_unet as cu
    from big_linear_algebra_tpu_torch.nn import fused_block as fb

    cfg = dataclasses.replace(cfg, fused_block=True,
                              compute_dtype="bfloat16")
    counts = [0]

    def block(x, td, w1, *a, **kw):
        counts[0] += 1
        return x.new_zeros(x.shape[0], w1.shape[0], *x.shape[2:])

    def conv(x, k, stride=1):
        return x.new_zeros(x.shape[0], k.shape[0], -(-x.shape[2] // stride),
                           -(-x.shape[3] // stride))

    real = cu.conv2d, cu.self_attention_block, fb.fused_resnet_block
    cu.conv2d, cu.self_attention_block = conv, (lambda h, p: h)
    fb.fused_resnet_block = block
    per_stage = []
    try:
        stages = cu.split_params_stages(
            cu.init_params(torch.Generator().manual_seed(0), cfg))
        b = (torch.zeros(mb, cfg.in_channels, cfg.image_size,
                         cfg.image_size), torch.zeros(mb))
        with torch.inference_mode():
            for fn, p in zip(cu.unet_pipeline_stages(cfg), stages):
                counts[0] = 0
                b = fn(p, b)
                per_stage.append(counts[0])
    finally:
        cu.conv2d, cu.self_attention_block, fb.fused_resnet_block = real
    return per_stage


def _p25_pp(tmp: str, device: str) -> dict:
    """One pipeline rank (3 ranks, one stage each): ``train 1 --pp
    --pp-micro=4 --image-size=64`` under GPipe, then under 1F1B resuming
    it, then ``--fused-block --pp`` at 32x32 (the kernels' counts around
    each, a hash of the parameters after each); one f32 step's gradients,
    GPipe and 1F1B, against the sequential run of the stages with the same
    folds on the card (rank 0, with a TF32 control); then a bf16 step of
    each schedule profiled, the stage units timed."""
    from big_linear_algebra_tpu_torch.models import cifar_unet as cu
    from big_linear_algebra_tpu_torch.nn import attention as at
    from big_linear_algebra_tpu_torch.nn import fused_block as fb
    from big_linear_algebra_tpu_torch.nn.optim import adam_init
    from big_linear_algebra_tpu_torch.parallel import make_mesh
    from big_linear_algebra_tpu_torch.parallel import pipeline as pl

    where = os.path.join(tmp, "pp")
    out = {}
    for schedule in ("gpipe", "1f1b"):
        out[schedule] = _run_cli_counted(
            cu, at, fb, ["train", "1", "--pp", f"--pp-micro={P25_MICRO}",
                         f"--pp-schedule={schedule}", "--image-size=64",
                         f"--max-steps={P25_PP_STEPS}", *_tiny(device)],
            where, device, "make_train_step_pp")
    out["fused"] = _run_cli_counted(
        cu, at, fb, ["train", "1", "--pp", f"--pp-micro={P25_MICRO}",
                     "--fused-block", f"--max-steps={P25_FUSED_STEPS}",
                     *_tiny(device)],
        os.path.join(tmp, "pp_fused"), device, "make_train_step_pp")
    del os.environ["BLA_DATA_DIR"]
    mesh = make_mesh({"stage": 3})
    cfg = _p25_cfg(device, compute_dtype="float32")
    batch = 4
    params, x0, tt, noise = _p25_inputs(cu, cfg, mesh, batch, 26)
    seed = 2025
    grads = {}
    for schedule in ("gpipe", "1f1b"):
        fn = cu.make_pp_loss_and_grads(mesh, cfg, n_micro=P25_MICRO,
                                       schedule=schedule)
        grads[schedule] = fn(params, x0, tt, noise, seed)
    if mesh.rank == 0:
        want = _pp_sequential(cu, pl, params, x0, tt, noise, seed, cfg)
        ctl = _pp_sequential(cu, pl, _tf32_tree(cu, params), _tf32(x0), tt,
                             noise, seed, cfg)
        out["grad"] = {
            "gpipe": _grad_errors(grads["gpipe"][1], want[1]),
            "1f1b": _grad_errors(grads["1f1b"][1], want[1]),
            "1f1b vs gpipe": _grad_errors(grads["1f1b"][1],
                                          grads["gpipe"][1]),
            "control": _grad_errors(ctl[1], want[1]),
            "losses": (grads["gpipe"][0].item(), grads["1f1b"][0].item(),
                       want[0].item())}
    del params, grads
    cfg16 = _p25_cfg(device)
    full = cu.tree_map(lambda a: a.to(mesh.device),
                       cu.init_params(torch.Generator().manual_seed(0),
                                      cfg16))
    opt = adam_init(full)
    xb = torch.rand((cfg16.batch_size, 3, 64, 64),
                    generator=torch.Generator().manual_seed(6)).to(
        mesh.device) * 2 - 1
    gen = torch.Generator().manual_seed(7)
    out["profile"] = {}
    for schedule in ("gpipe", "1f1b"):
        step = cu.make_train_step_pp(mesh, cfg16, n_micro=P25_MICRO,
                                     schedule=schedule)
        prof = _profile_step(lambda: step(full, opt, xb, gen), device)
        units = [0.0]
        timer = _unit_timer(units, device)
        with _wrapped(pl._Stage, "run", timer), \
                _wrapped(pl._Stage, "vjp", timer):
            _sync(device)
            t0 = time.perf_counter()
            step(full, opt, xb, gen)
            _sync(device)
        prof["unit_share"] = units[0] / (time.perf_counter() - t0)
        out["profile"][schedule] = prof
    return out


def _pp_sequential(cu, pl, params, x0, tt, noise, seed, cfg):
    """(loss, grads) of the pipeline's step run sequentially on this rank:
    the stage functions one after the other on each microbatch, stage s on
    microbatch m drawing from ``fold_generator(seed, s·n_micro + m)``."""
    from big_linear_algebra_tpu_torch.nn.optim import tree_leaves

    leaves = cu.tree_map(lambda p: p.detach().requires_grad_(), params)
    fns = cu.unet_pipeline_stages(cfg, train=True)
    stages = cu.split_params_stages(leaves)
    mb = x0.shape[0] // P25_MICRO
    xs = cu._noised(x0, tt, noise, cfg).reshape(P25_MICRO, mb,
                                                *x0.shape[1:])
    ts = tt.reshape(P25_MICRO, mb).to(x0.dtype)
    preds = []
    with torch.enable_grad():
        for m in range(P25_MICRO):
            b = (xs[m], ts[m])
            for s, (fn, p) in enumerate(zip(fns, stages)):
                b = fn(p, b, pl.fold_generator(seed, s * P25_MICRO + m,
                                               x0.device))
            preds.append(b)
        loss = cu.mse_loss(torch.stack(preds).reshape(x0.shape).float(),
                           noise.float()) / x0.numel()
        grads = iter(torch.autograd.grad(loss, tree_leaves(leaves),
                                         allow_unused=True))
    return loss.detach(), cu.tree_map(
        lambda p: cu._zero_if_none(next(grads), p), leaves)


def _p25_ppdp(tmp: str, device: str) -> dict:
    """One rank of ``train 1 --pp --dp --pp-micro=4 --fused-block`` at 32x32
    on a stage 3 x data 2 mesh: the fused kernels' counts around it, its
    step losses and a hash of the parameters after it."""
    from big_linear_algebra_tpu_torch.models import cifar_unet as cu
    from big_linear_algebra_tpu_torch.nn import attention as at
    from big_linear_algebra_tpu_torch.nn import fused_block as fb

    out = {"cli": _run_cli_counted(
        cu, at, fb, ["train", "1", "--pp", "--dp", f"--pp-micro={P25_MICRO}",
                     "--fused-block", f"--max-steps={P25_PPDP_STEPS}",
                     *_tiny(device)],
        os.path.join(tmp, "ppdp"), device, "make_train_step_pp")}
    del os.environ["BLA_DATA_DIR"]
    return out


def _phase25_rank(tmp: str, device: str, part: str) -> int:
    """One rank of phase 25 (``chip_smoke.py --phase25-rank TMP DEVICE
    PART`` under ``torch.distributed.run``, PART tp, pp or ppdp): joins the
    group, runs its part and writes ``TMP/<part>_rank<r>.pt``."""
    from big_linear_algebra_tpu_torch.parallel import mesh as pmesh

    rank = pmesh.distributed_init(device=device)
    dev = pmesh.current_device()
    out = {"rank": rank, "device": str(dev), "backend": pmesh.backend(),
           "why": pmesh.select_backend(dev, pmesh.local_world_size())[1]}
    out.update({"tp": _p25_tp, "pp": _p25_pp, "ppdp": _p25_ppdp}[part](
        tmp, device))
    torch.save(out, os.path.join(tmp, f"{part}_rank{rank}.pt"))
    return 0


def _p25_launch(tmp: str, device: str, part: str, n: int) -> tuple:
    """The ranks of one part: (their results in rank order, the launch's
    wall seconds)."""
    _, seconds = _run_ranks(tmp, device, n, ["--phase25-rank", tmp, device,
                                             part], "phase 25")
    return [torch.load(os.path.join(tmp, f"{part}_rank{r}.pt"),
                       weights_only=False) for r in range(n)], seconds


def _p25_prepare(tmp: str) -> None:
    """The synthesized CIFAR batches, once, linked into each run's data
    directory."""
    from big_linear_algebra_tpu_torch.data import synth

    data = os.path.join(tmp, "data")
    with contextlib.redirect_stdout(io.StringIO()):
        synth.ensure_cifar(data)
    for run in ("tp", "pp", "pp_fused", "ppdp"):
        os.makedirs(os.path.join(tmp, run))
        os.symlink(os.path.join(data, "cifar"),
                   os.path.join(tmp, run, "cifar"))


def _p25_same(ranks, part: str, what: str) -> None:
    """The replicas of ``part`` bit-equal, their losses equal."""
    if len({r[part]["hash"] for r in ranks}) != 1:
        fail(f"{what}: the replicas' parameters differ after the run")
    for r, rank in enumerate(ranks):
        if not torch.equal(rank[part]["losses"], ranks[0][part]["losses"]):
            fail(f"{what}: rank {r}'s losses differ from rank 0's")
        if r and rank[part]["text"]:
            fail(f"{what}: rank {r} printed")


def _p25_grad_line(tag: str, errs: dict, what: str) -> str:
    ctl = errs["control"][0]
    for name, (err, leaf) in errs.items():
        if name == "control":
            if not ctl > PARALLEL_GRAD_RTOL_OF_MAX:
                fail(f"{what}: the TF32-truncated control is within the "
                     f"bound ({ctl:.3e}): the check cannot see precision")
        elif not err <= PARALLEL_GRAD_RTOL_OF_MAX:
            fail(f"{what}, {name}: worst leaf (#{leaf}) {err:.3e} of its "
                 f"max|ref| (tol {PARALLEL_GRAD_RTOL_OF_MAX})")
    return (f"[25 {tag}] {what}: worst leaf of its max|ref| "
            + ", ".join(f"{k} {v[0]:.3e}" for k, v in errs.items())
            + f" (tol {PARALLEL_GRAD_RTOL_OF_MAX}; the control must fail)")


def _p25_check_tp(ranks, device) -> list:
    cli = [r["cli"] for r in ranks]
    if len({tuple(c["losses"].tolist()) for c in cli}) != 1:
        fail("train --tp: the ranks' step losses differ")
    per = 4 * P25_TP_STEPS if device == "cuda" else 0
    for r, c in enumerate(cli):
        if c["flash"] != (per,) * 3:
            fail(f"train --tp --image-size=64 on rank {r}: K2/K2c/K2d "
                 f"launched {c['flash']}, expected {per} each (4 flash "
                 f"sites at the full batch on every rank x {P25_TP_STEPS} "
                 f"steps)")
        if r and c["text"]:
            fail(f"train --tp: rank {r} printed")
    if f"--tp: conv kernels channel-sharded over {P25_TP_RANKS} devices" \
            not in cli[0]["text"]:
        fail(f"train --tp did not shard:\n{cli[0]['text']}")
    losses = cli[0]["losses"]
    if not (len(losses) == P25_TP_STEPS and torch.isfinite(losses).all()):
        fail(f"train --tp: {losses.tolist()}")
    g = ranks[0]["grad"]
    ep = _epoch_line(cli[0]["text"], 0)
    lines = [
        f"[25 tp] train 1 --tp --image-size=64 --max-steps={P25_TP_STEPS} "
        f"on {len(ranks)} ranks ("
        f"{'TINY, f32' if device == 'cpu' else 'full width, bf16'} compute, "
        f"batch {4 if device == 'cpu' else 16} on every rank): K2/K2c/K2d "
        f"per rank "
        f"{cli[0]['flash']} (4 each a step), losses "
        f"{[round(x, 5) for x in losses.tolist()]} on every rank; epoch "
        f"{ep['epoch_seconds']} s; {cli[0]['seconds']:.1f} s with the CSV "
        f"tree",
        _p25_grad_line("tp grad", {"tp": g["tp"], "dptp m": g["dptp m"],
                                   "control": g["control"]},
                       f"f32 64x64 batch-4 gradient ({g['leaves']} leaves, "
                       f"conditioned net, masks and draws alike) of the TP "
                       f"step on (data 1 x model {len(ranks)}), gathered, "
                       f"and the DP×TP step's first moment, against the "
                       f"single-device step on the same card; losses "
                       f"{[round(x, 6) for x in g['losses']]}; DP×TP "
                       f"params max|diff| {g['dptp params']:.3e}")]
    return lines


def _p25_check_pp(ranks, device) -> tuple:
    """The pipeline part's checks; returns (lines, per-rank flash counts of
    one GPipe step)."""
    import dataclasses

    from big_linear_algebra_tpu_torch.models import cifar_unet as cu

    lines = []
    cuda = device == "cuda"
    # K2 at 64x64: 2 sites a microbatch on the down rank (down_2) and on
    # the up rank (up_3); the mid rank's 8x8 maps take the dense path
    sites = [2, 0, 2]
    for schedule, fwd in (("gpipe", 1), ("1f1b", 2)):
        _p25_same(ranks, schedule, f"train --pp ({schedule})")
        for s, rank in enumerate(ranks):
            k = sites[s] * P25_MICRO * P25_PP_STEPS if cuda else 0
            want = (fwd * k, k, k)
            if rank[schedule]["flash"] != want:
                fail(f"train --pp --pp-schedule={schedule} on stage {s}: "
                     f"K2/K2c/K2d launched {rank[schedule]['flash']}, "
                     f"expected {want}")
    mb = (cu.CONFIG.batch_size if cuda else 4) // P25_MICRO
    blocks = _stage_fused_blocks(cu.CONFIG, mb) if cuda else [0, 0, 0]
    _p25_same(ranks, "fused", "train --pp --fused-block")
    for s, rank in enumerate(ranks):
        n = blocks[s] * P25_MICRO * P25_FUSED_STEPS
        if rank["fused"]["fused"] != (n,) * 6:
            fail(f"train --pp --fused-block on stage {s}: K5a/tc/K5b data/"
                 f"tc/K5b weights/tc launched {rank['fused']['fused']}, "
                 f"expected {n} each ({blocks[s]} fused blocks a "
                 f"microbatch of {mb} x {P25_MICRO} x {P25_FUSED_STEPS})")
    r0 = ranks[0]
    for part, what in (("gpipe", "gpipe schedule"), ("1f1b", "1f1b schedule"),
                       ("fused", "gpipe schedule")):
        if f"--pp: 3-stage pipeline (down/mid/up), {P25_MICRO} " \
                f"microbatches, {what}" not in r0[part]["text"]:
            fail(f"train --pp ({part}) did not take the pipeline:\n"
                 f"{r0[part]['text']}")
    resumed = f"resumed train state at step {P25_PP_STEPS} (epoch 1)"
    if resumed not in r0["1f1b"]["text"]:
        fail(f"the 1F1B run did not resume the GPipe run:\n"
             f"{r0['1f1b']['text']}")
    for part in ("gpipe", "1f1b", "fused"):
        if not torch.isfinite(r0[part]["losses"]).all():
            fail(f"train --pp ({part}): losses {r0[part]['losses']}")
    lines.append(
        f"[25 pp] train 1 --pp --pp-micro={P25_MICRO} --image-size=64 "
        f"--max-steps={P25_PP_STEPS}, GPipe then 1F1B resuming it, on 3 "
        f"ranks (one stage each; batch 16 in microbatches of "
        f"{16 // P25_MICRO}): K2/K2c/K2d per stage (down, mid, up) GPipe "
        f"{[r['gpipe']['flash'] for r in ranks]}, 1F1B "
        f"{[r['1f1b']['flash'] for r in ranks]} (the 1F1B recompute runs K2 "
        f"again); losses GPipe {[round(x, 5) for x in r0['gpipe']['losses'].tolist()]}, "
        f"1F1B {[round(x, 5) for x in r0['1f1b']['losses'].tolist()]}; "
        f"replicas bit-equal after each. --fused-block --pp at 32x32: fused "
        f"blocks a microbatch per stage {blocks}, K5a/tc/K5b data/tc/K5b "
        f"weights/tc per stage {[r['fused']['fused'] for r in ranks]} (all "
        f"on the tensor-core route); replicas bit-equal")
    lines.append(_p25_grad_line(
        "pp grad", {k: v for k, v in r0["grad"].items() if k != "losses"},
        f"f32 64x64 batch-4 gradient ({P25_MICRO} "
        f"microbatches, dropout on, the folds of one seed, conditioned net) "
        f"of the pipeline step against the sequential run of the stages "
        f"with the same folds on the same card; losses GPipe, 1F1B, "
        f"sequential {[round(x, 6) for x in r0['grad']['losses']]}"))
    return lines, blocks


def _p25_check_ppdp(ranks, device, blocks) -> list:
    cuda = device == "cuda"
    _p25_same(ranks, "cli", "train --pp --dp --fused-block")
    n_data = len(ranks) // 3
    per = P25_MICRO // n_data
    text = ranks[0]["cli"]["text"]
    if f"--pp --dp: 3-stage pipeline × {n_data} data shards" not in text:
        fail(f"train --pp --dp did not take the 2-D mesh:\n{text}")
    for r, rank in enumerate(ranks):
        s = r // n_data
        n = blocks[s] * per * P25_PPDP_STEPS if cuda else 0
        if rank["cli"]["fused"] != (n,) * 6:
            fail(f"train --pp --dp --fused-block on rank {r} (stage {s}): "
                 f"K5a/tc/K5b data/tc/K5b weights/tc launched "
                 f"{rank['cli']['fused']}, expected {n} each")
    losses = ranks[0]["cli"]["losses"]
    if not (len(losses) == P25_PPDP_STEPS and torch.isfinite(losses).all()):
        fail(f"train --pp --dp: losses {losses.tolist()}")
    return [f"[25 pp dp] train 1 --pp --dp --pp-micro={P25_MICRO} "
            f"--fused-block --max-steps={P25_PPDP_STEPS} (32x32) on "
            f"{len(ranks)} ranks (stage 3 x data {n_data}, {per} "
            f"microbatches a data coordinate): K5a/tc/K5b data/tc/K5b "
            f"weights/tc per rank {[r['cli']['fused'] for r in ranks]}; "
            f"losses {[round(x, 5) for x in losses.tolist()]} on every rank; "
            f"the {len(ranks)} replicas bit-equal"]


def _p25_profile_lines(tp, pp, smi_line: str) -> list:
    import dataclasses

    from big_linear_algebra_tpu_torch.models import cifar_unet as cu
    from big_linear_algebra_tpu_torch.parallel import pipeline as pl

    cfg = dataclasses.replace(cu.CONFIG, image_size=64)
    xs = (torch.zeros(P25_MICRO, cfg.batch_size // P25_MICRO, 3, 64, 64),
          torch.zeros(P25_MICRO, cfg.batch_size // P25_MICRO))
    stats = pl.hetero_stats(
        cu.unet_pipeline_stages(cfg, train=True),
        cu.split_params_stages(cu.init_params(
            torch.Generator().manual_seed(0), cfg)), xs, key=1)
    lines = []

    def fmt(what, r, rank, p):
        busy = ("" if p["busy_ms"] is None else
                f"; device busy {p['busy_ms']:.3f} ms = "
                f"{p['busy_ms'] / p['host_ms']:.1%} of the host time")
        moved = ", ".join(f"{k} {v / 2 ** 20:.1f} MiB"
                          for k, v in p["bytes"].items() if v)
        return (f"[25 profile] {what}, rank {r} ({rank['device']}, "
                f"{rank['backend']}): host wall {p['host_ms']:.3f} ms"
                f"{busy}; {p['coll_calls']:.1f} collectives, moved "
                f"{moved or 'nothing'}")

    for r, rank in enumerate(tp):
        lines.append(fmt("bf16 TP step, 64x64, batch 16", r, rank,
                         rank["profile"]) + f" | {smi_line}")
    for schedule, util in (("gpipe", "utilization"),
                           ("1f1b", "utilization_1f1b")):
        for s, rank in enumerate(pp):
            p = rank["profile"][schedule]
            lines.append(
                fmt(f"bf16 PP {schedule} step, 64x64, batch 16 in "
                    f"{P25_MICRO} microbatches", s, rank, p)
                + f"; the stage's units {p['unit_share']:.1%} of a step "
                f"(hetero_stats' {util} {stats[util]:.3f}) | {smi_line}")
    lines.append(
        f"[25 hetero_stats] full width 64x64, microbatches of "
        f"{cfg.batch_size // P25_MICRO}: boundary widths "
        f"{stats['boundary_widths']} ({stats['boundary_dtype']} padded in "
        f"JAX; the port sends each at its own width and dtype), "
        f"utilization {stats['utilization']:.3f}, 1F1B "
        f"{stats['utilization_1f1b']:.3f}, JAX's padded ring bytes a step "
        f"{stats['ring_bytes_total'] / 2 ** 20:.1f} MiB")
    return lines


def phase_tp_pp(smi_line: str = "", device: str = "cuda") -> None:
    """Phase 25: the U-Net's tensor parallelism on P25_TP_RANKS ranks, the
    pipeline on 3 and PP×DP on 6, each launched with ``python3 -m
    torch.distributed.run --standalone`` (``_phase25_rank``), the ranks
    sharing the card over gloo (a card each over NCCL where there are as
    many): ``cifar_unet train 1 --tp --image-size=64`` (K2/K2c/K2d 4 each
    per rank per step), the f32 TP gradient and a DP×TP step's first
    moment against the single-device step (``PARALLEL_GRAD_RTOL_OF_MAX``,
    a TF32 control failing it); ``train 1 --pp --pp-micro=4
    --image-size=64`` under GPipe and under 1F1B resuming it (per-stage
    K2/K2c/K2d derived from the sites a stage holds; replicas bit-equal),
    ``--fused-block --pp`` at 32x32 (K5a/K5b per stage as many as the
    gate's blocks there), the f32 GPipe and 1F1B gradients against the
    sequential run of the stages on the same folds; ``train 1 --pp --dp
    --pp-micro=4 --fused-block`` on a stage 3 x data 2 mesh (replicas
    bit-equal); each rank's step wall, collectives and bytes, and the
    share of a pipeline step in its stage's units beside
    ``hetero_stats``' utilizations."""
    with tempfile.TemporaryDirectory(prefix="bla_smoke_") as tmp:
        _p25_prepare(tmp)
        tp, tp_s = _p25_launch(tmp, device, "tp", P25_TP_RANKS)
        pp, pp_s = _p25_launch(tmp, device, "pp", P25_PP_RANKS)
        ppdp, ppdp_s = _p25_launch(tmp, device, "ppdp", P25_PPDP_RANKS)
        lines = [f"[25 launch] python3 -m torch.distributed.run --standalone"
                 f" --nproc-per-node=N, N = {P25_TP_RANKS} (TP), "
                 f"{P25_PP_RANKS} (PP), {P25_PPDP_RANKS} (PP x DP): backend "
                 f"{tp[0]['backend']} ({tp[0]['why']}; {ppdp[0]['why']}); "
                 f"{tp_s:.1f} s, {pp_s:.1f} s and {ppdp_s:.1f} s of wall for "
                 f"the launches"]
        lines += _p25_check_tp(tp, device)
        pp_lines, blocks = _p25_check_pp(pp, device)
        lines += pp_lines
        lines += _p25_check_ppdp(ppdp, device, blocks)
        lines += _p25_profile_lines(tp, pp, smi_line)
    for line in lines:
        print(line if smi_line in line else f"{line} | {smi_line}",
              flush=True)


# ---------------------------------------------------------------------------
# Phase 26: --layout=NHWC and --remat on the U-Net (run after 10, in phase
# 9/10's data directory: its trained CSV tree and its CIFAR batches)
# ---------------------------------------------------------------------------

# The channels-last twins against the NCHW ops on the same values, forward
# and backward, at the full-width net's shapes: the 3x3 conv at (16, 128,
# 64, 64) → 128 and the stride-2 downsample → 256 (B, C, H, W, F, stride);
# GN at (16, 256, 32, 32), groups of 32 channels; the attention block at
# 32x32 tokens, C 256, key_dim 16 (K2, K2c/K2d). TINY-sized on the CPU
# rehearsal.
P26_CONVS = [(16, 128, 64, 64, 128, 1), (16, 128, 64, 64, 256, 2)]
P26_GN = (16, 256, 32, 32, 32)          # B, C, H, W, group size
P26_ATTN = (16, 256, 32, 32, 16)        # B, C, H, W, key_dim
P26_CPU = {"convs": [(2, 8, 16, 16, 8, 1), (2, 8, 16, 16, 12, 2)],
           "gn": (2, 12, 8, 8, 4), "attn": (2, 12, 8, 8, 4)}
# f32 bounds, fixed before the first run. Both sides are true f32 (TF32
# off) and differ in the order of their sums only, so each bound scales
# with the longest sum behind an output, as K1's (F32_ULPS):
# - conv: F32_ULPS * K * max|a| * max|b| * 2**-24, K the contraction (C*k*k
#   forward, F*k*k for dx, B*oh*ow for dk); a TF32 conv (operands cut to
#   10 bits) errs by ~sqrt(K) * |a||b| * 2**-11 and must fail it;
# - GN over n = group_size*H*W elements: the mean errs by up to
#   n*max|x|*2**-24 and the standard deviation by n*max|y|**2/2 of itself,
#   so |dy| <= F32_ULPS * n * 2**-24 * (max|x|/min sigma + max|y|**3), and
#   the backward likewise with max|g|*(1 + max|y|)**2/min sigma added;
# - the attention block: its sums run over C (projections), N (the
#   softmax and P*V) and key_dim (the output dense), and a score's error
#   moves the softmax by its own size: F32_ULPS * (C + N + key_dim) *
#   2**-24 * (1 + max|s|) * max|ref|, s the scaled scores.
# bf16: BF16_RTOL_OF_MAX of max|ref| (the same bf16 operands; cuDNN and
# cuBLAS pick other kernels for the two layouts).
# The NHWC sampling forward (bf16, t=500) against the NCHW one: within
# P26_BF16_FACTOR times the NCHW forward's own distance from the f64
# forward (two bf16 evaluations whose roundings differ; the bound of
# phase 14's fused-vs-unfused forward).
P26_BF16_FACTOR = 2.0
# The f32 NHWC gradient against the NCHW one on phase 10's conditioned net
# (batch 2, fixed draws, dropout off), leaf by leaf, max|err| / max|ref|:
# within max(P26_GRAD_FLOOR, 2 * that leaf's NCHW f32 distance from the
# f64 gradient). Every conv and GN of the net sums in another order (and
# cuDNN takes other algorithms) under NHWC, so the difference is that of
# two f32 evaluations of the net, each as far from f64 as f32 rounding
# amplified by the net takes it. The CPU rehearsal
# (tools/layout_remat_check.py --device=cpu: TINY, whose oneDNN
# channels-last f32 conv rounds several times coarser than its NCHW one)
# read 1.55 of that bound with a floor of GRAD_SHARE_RTOL_OF_MAX: the
# floor is twice that; phase 26 alone on the card (the seed's init, these
# draws) then read 0.156 of it. The control, the NCHW gradient from
# parameters and inputs cut to TF32, must fail it (there: 59.8x).
P26_GRAD_FLOOR = 2 * GRAD_SHARE_RTOL_OF_MAX
P26_TRAIN_STEPS = 50   # NHWC train 1 from the seed's init (phase 9's count)
P26_FUSED_STEPS = 2    # train 1 --fused-block --layout=NHWC at 32x32
P26_TIMED_STEPS = 3    # train steps per turn of the step timings
P26_DP_RANKS, P26_DP_STEPS = 2, 2


def _p26_gn_bounds(x, y, g, dx, n: int, group: int):
    """(forward bound, backward bound) of the f32 GN twin (see P26's
    comment), from the NCHW reference's x (B, C, H, W), y, g and dx."""
    b, c = x.shape[:2]
    sigma = x.double().reshape(b, c // group, -1).std(-1, unbiased=False)
    s_min = sigma.min().item()
    u = F32_ULPS * n * 2.0 ** -24
    ymax, xmax = y.abs().max().item(), x.abs().max().item()
    fwd = u * (xmax / s_min + ymax ** 3)
    bwd = u * (g.abs().max().item() * (1 + ymax) ** 2 / s_min
               + dx.abs().max().item() * ymax ** 2)
    return fwd, bwd


def _p26_compare(name, got, want, bound, lines, dtype):
    """max|got - want| against ``bound`` (f32) or BF16_RTOL_OF_MAX of
    max|want| (bf16): fails beyond it; appends the reading to ``lines``;
    returns err / bound."""
    err = (got.double() - want.double()).abs().max().item()
    if dtype == torch.bfloat16:
        bound = BF16_RTOL_OF_MAX * want.double().abs().max().item()
    ratio = err / bound if bound > 0 else (0.0 if err == 0 else math.inf)
    if not ratio <= 1.0:
        fail(f"phase 26 twins, {name} ({dtype}): max|NHWC - NCHW| {err:.3e}"
             f" > bound {bound:.3e}")
    lines.append(f"{name} {err:.2e}/{bound:.2e}")
    return ratio


def _p26_grads(fn, inputs, g):
    leaves = [x.detach().clone().requires_grad_() for x in inputs]
    out = fn(*leaves)
    return out.detach(), torch.autograd.grad(out, leaves, g)


def _p26_twins(device: str) -> list:
    """The twins against the NCHW ops on the same values (see P26_*):
    forward and backward, f32 and bf16; the TF32 control on the 3x3
    conv's forward and dx; channels-last memory of the conv's output and
    dx and of GN's output. Returns the report lines."""
    from big_linear_algebra_tpu_torch.nn import attention as at
    from big_linear_algebra_tpu_torch.nn import conv, norm

    shapes = (P26_CPU if device == "cpu" else
              {"convs": P26_CONVS, "gn": P26_GN, "attn": P26_ATTN})
    gen = torch.Generator(device=device).manual_seed(26)
    lines, worst = [], 0.0

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    def nhwc(t):
        return t.permute(0, 2, 3, 1).contiguous()

    def nchw(t):  # the NCHW ops' cotangent, contiguous NCHW
        return t.permute(0, 3, 1, 2).contiguous()

    def channels_last(what, t):
        # a contiguous (B, H, W, C) map is a channels-last NCHW tensor
        if not t.permute(0, 3, 1, 2).is_contiguous(
                memory_format=torch.channels_last):
            fail(f"phase 26 twins: {what} is not in channels-last memory "
                 f"(strides {t.stride()} of shape {tuple(t.shape)})")

    counts0 = _flash_counts(at)
    for dtype in (torch.float32, torch.bfloat16):
        row = []
        for b, c, h, w, f, s in shapes["convs"]:
            x = randn(b, c, h, w, dtype=dtype)
            k = randn(f, c, 3, 3, dtype=dtype) / math.sqrt(9 * c)
            oh, ow = conv.out_size(h, s), conv.out_size(w, s)
            g = randn(b, oh, ow, f, dtype=dtype)
            y, (dx, dk) = _p26_grads(lambda a, kk: conv.conv2d(a, kk, s),
                                     [x, k], nchw(g))
            yt, (dxt, dkt) = _p26_grads(
                lambda a, kk: conv.conv2d_nhwc(a, kk, s), [nhwc(x), k], g)
            channels_last(f"conv2d_nhwc's output at {(b, c, h, w, f, s)}",
                          yt)
            channels_last(f"conv2d_nhwc's dx at {(b, c, h, w, f, s)}", dxt)
            tag = f"conv {c}->{f} s{s}"
            for name, got, want, bound in (
                    ("fwd", yt, nhwc(y), f32_bound(x, k, c * 9)),
                    ("dx", dxt, nhwc(dx), f32_bound(g, k, f * 9)),
                    ("dk", dkt, dk, f32_bound(x, g, b * oh * ow))):
                worst = max(worst, _p26_compare(f"{tag} {name}", got, want,
                                                bound, row, dtype))
            if dtype == torch.float32 and s == 1:
                # the control: the NHWC conv on operands cut to TF32
                yc, (dxc, _) = _p26_grads(
                    lambda a, kk: conv.conv2d_nhwc(a, kk, s),
                    [_tf32(nhwc(x)), _tf32(k)], _tf32(g))
                for name, got, want, bound in (
                        ("fwd", yc, nhwc(y), f32_bound(x, k, c * 9)),
                        ("dx", dxc, nhwc(dx), f32_bound(g, k, f * 9))):
                    err = (got - want).abs().max().item()
                    if not err > bound:
                        fail(f"phase 26 TF32 control: a TF32 conv's {name} "
                             f"is within the f32 bound ({err:.3e} <= "
                             f"{bound:.3e})")
                    row.append(f"TF32 control {tag} {name} {err:.2e} "
                               f"(fails, {err / bound:.0f}x)")
        b, c, h, w, grp = shapes["gn"]
        x = randn(b, c, h, w, dtype=dtype) * 2 + 0.5
        g = randn(b, h, w, c, dtype=dtype)
        y, (dx,) = _p26_grads(lambda a: norm.group_norm(a, grp), [x],
                              nchw(g))
        yt, (dxt,) = _p26_grads(lambda a: norm.group_norm_nhwc(a, grp),
                                [nhwc(x)], g)
        channels_last("group_norm_nhwc's output", yt)
        fwd_b, bwd_b = _p26_gn_bounds(x.float(), y.float(), g.float(),
                                      dx.float(), grp * h * w, grp)
        for name, got, want, bound in (("fwd", yt, nhwc(y), fwd_b),
                                       ("dx", dxt, nhwc(dx), bwd_b)):
            worst = max(worst, _p26_compare(f"GN {name}", got, want, bound,
                                            row, dtype))
        b, c, h, w, kd = shapes["attn"]
        x = randn(b, c, h, w, dtype=dtype)
        p = {"q": randn(c, kd, dtype=dtype) / math.sqrt(c),
             "k": randn(c, kd, dtype=dtype) / math.sqrt(c),
             "v": randn(c, kd, dtype=dtype) / math.sqrt(c),
             "w": randn(kd, c, dtype=dtype) / math.sqrt(kd),
             "b": randn(c, dtype=dtype)}
        names = list(p)
        g = randn(b, h, w, c, dtype=dtype)
        y, grads = _p26_grads(
            lambda a, *ws: at.self_attention_block(a, dict(zip(names, ws))),
            [x, *p.values()], nchw(g))
        yt, grads_t = _p26_grads(
            lambda a, *ws: at.self_attention_block_nhwc(
                a, dict(zip(names, ws))), [nhwc(x), *p.values()], g)
        tokens = x.float().flatten(2).transpose(1, 2)
        scores = ((tokens @ p["q"].float())
                  @ (tokens @ p["k"].float()).transpose(-1, -2)) \
            / math.sqrt(kd)
        u = F32_ULPS * (c + h * w + kd) * 2.0 ** -24 * (
            1 + scores.abs().max().item())
        pairs = [("fwd", yt, nhwc(y)), ("dx", grads_t[0], nhwc(grads[0]))]
        pairs += [(f"d{n}", gt, gw) for n, gt, gw in
                  zip(names, grads_t[1:], grads[1:])]
        for name, got, want in pairs:
            worst = max(worst, _p26_compare(
                f"attention {name}", got, want,
                u * want.double().abs().max().item(), row, dtype))
        lines.append(f"{str(dtype).replace('torch.', '')}: "
                     + ", ".join(row))
    counts = tuple(a - b for a, b in zip(_flash_counts(at), counts0))
    want = (0, 0, 0) if device == "cpu" else (4, 4, 4)
    if counts != want:
        fail(f"phase 26 twins: the attention blocks launched K2/K2c/K2d "
             f"{counts} times, expected {want} (both layouts, f32 and bf16)")
    lines.insert(0, f"worst err/bound {worst:.3e}; K2/K2c/K2d {counts} "
                 "(each layout's f32 and bf16 block)")
    return lines


def _p26_data_dir(tmp: str, name: str) -> str:
    """A fresh data directory under ``tmp`` with ``tmp``'s CIFAR batches
    linked in (no CSV tree, no train state)."""
    where = os.path.join(tmp, name)
    os.makedirs(where)
    os.symlink(os.path.join(tmp, "cifar"), os.path.join(where, "cifar"))
    return where


def _p26_run(tmp: str, device: str, nchw_run_k2: int):
    """``run 1 --image-size=64 --layout=NHWC`` in ``tmp`` (K2's launches
    against phase 6's NCHW run's); returns (line, the parameters ``run``
    loaded)."""
    from big_linear_algebra_tpu_torch.data import bmp
    from big_linear_algebra_tpu_torch.models import cifar_unet as cu
    from big_linear_algebra_tpu_torch.nn import attention as at

    loaded = {}
    tiny = ["--tiny"] if device == "cpu" else []
    with _wrapped(cu, "_params_for_run",
                  lambda real: lambda cfg: loaded.setdefault("p", real(cfg))):
        at.launch_count = 0
        text, secs = _cli(cu, ["run", "1", "--image-size=64",
                               "--sample-seed=0", "--layout=NHWC", *tiny],
                          tmp, device)
        launches = at.launch_count
    if launches != nchw_run_k2:
        fail(f"run 1 --layout=NHWC launched K2 {launches} times, NCHW's run "
             f"{nchw_run_k2}")
    path = os.path.join(tmp, "cifar_unet", "samples", "sample_0.bmp")
    planes = bmp.read_bmp(path)
    if any(p.shape != (64, 64) for p in planes):
        fail(f"{path}: planes of shape {[p.shape for p in planes]}")
    lo = min(int(p.min()) for p in planes)
    hi = max(int(p.max()) for p in planes)
    if lo == hi:
        fail(f"{path}: constant image (every byte {lo})")
    return (f"run 1 --image-size=64 --layout=NHWC {secs:.2f} s wall: K2 "
            f"launches {launches} (NCHW's run: {nchw_run_k2}); "
            f"samples/sample_0.bmp 64x64, bytes {lo}..{hi}"), loaded["p"]


def _p26_forward(params, device: str) -> str:
    """One bf16 forward at t=500 in both layouts against the f64 NCHW
    forward (dense attention): NHWC within P26_BF16_FACTOR times NCHW's
    distance."""
    import dataclasses

    from big_linear_algebra_tpu_torch.models import cifar_unet as cu

    cfg = _p25_cfg(device)
    x = torch.randn(1, 3, 64, 64, generator=torch.Generator().manual_seed(0))
    x, t = x.to(device), torch.tensor([min(500, cfg.timesteps - 1)],
                                      device=device)
    outs = {}
    with torch.inference_mode():
        for name, dt, layout in (("f64", "float64", "NCHW"),
                                 ("nchw", "bfloat16", "NCHW"),
                                 ("nhwc", "bfloat16", "NHWC")):
            c = dataclasses.replace(cfg, compute_dtype=dt, layout=layout)
            p = cu.tree_map(lambda a: a.to(device, getattr(torch, dt)),
                            params)
            outs[name] = cu.forward(p, x, t, c).double()
    if not all(torch.isfinite(o).all() for o in outs.values()):
        fail("phase 26: a U-Net forward is not finite")
    scale = outs["f64"].abs().max().item()
    nchw = (outs["nchw"] - outs["f64"]).abs().max().item() / scale
    nhwc = (outs["nhwc"] - outs["f64"]).abs().max().item() / scale
    diff = (outs["nhwc"] - outs["nchw"]).abs().max().item() / scale
    if not diff <= P26_BF16_FACTOR * nchw:
        fail(f"phase 26: the bf16 NHWC forward differs from the NCHW one by "
             f"{diff:.3e} of max|f64|, beyond {P26_BF16_FACTOR} x NCHW's own "
             f"distance from f64 ({nchw:.3e})")
    return (f"bf16 forward at t={int(t)}, /max|f64 ref|: NHWC vs NCHW "
            f"{diff:.3e} (bound {P26_BF16_FACTOR} x {nchw:.3e}, NCHW vs "
            f"f64); NHWC vs f64 {nhwc:.3e}")


def _p26_train(tmp: str, device: str) -> tuple:
    """``train 1 --image-size=64 --layout=NHWC --max-steps=P26_TRAIN_STEPS``
    from the seed's init in a fresh directory (K2/K2c/K2d 4 each a step, a
    falling loss), then ``train 1 --fused-block --layout=NHWC`` at 32x32
    resuming it (no fused block). Returns (line, the directory)."""
    from big_linear_algebra_tpu_torch.models import cifar_unet as cu
    from big_linear_algebra_tpu_torch.nn import attention as at
    from big_linear_algebra_tpu_torch.nn import fused_block as fb

    where = _p26_data_dir(tmp, "p26_nhwc")
    tiny = ["--tiny"] if device == "cpu" else []
    losses = []

    def spy(real):
        def step(*a, **kw):
            out = real(*a, **kw)
            losses.append(out[2])
            return out
        return step

    with _wrapped(cu, "train_step", spy):
        _zero_flash_counts(at)
        text, secs = _cli(cu, ["train", "1", "--image-size=64",
                               "--layout=NHWC",
                               f"--max-steps={P26_TRAIN_STEPS}", *tiny],
                          where, device)
        counts = _flash_counts(at)
        vals = torch.stack(losses).float().cpu()
        losses.clear()
        _zero_fused_counts(fb)
        fused_text, fused_s = _cli(
            cu, ["train", "1", "--fused-block", "--layout=NHWC",
                 f"--max-steps={P26_FUSED_STEPS}", *tiny], where, device)
    fused = (fb.launch_count, fb.tc_launch_count, fb.bwd_launch_count,
             fb.bwd_tc_launch_count, fb.wgrad_launch_count,
             fb.wgrad_tc_launch_count)
    per = 0 if device == "cpu" else 4 * P26_TRAIN_STEPS
    if counts != (per,) * 3:
        fail(f"train 1 --layout=NHWC launched K2/K2c/K2d {counts} times in "
             f"{P26_TRAIN_STEPS} steps, expected {per} each (4 flash sites "
             "per step, as NCHW)")
    if len(vals) != P26_TRAIN_STEPS or not torch.isfinite(vals).all():
        fail(f"train 1 --layout=NHWC: {len(vals)} steps, losses {vals}")
    head, tail = vals[:10].mean().item(), vals[-10:].mean().item()
    if not tail < head:
        fail(f"train 1 --layout=NHWC: the loss did not fall (mean of steps "
             f"1-10 {head}, of the last 10 {tail})")
    if any(fused) or len(losses) != P26_FUSED_STEPS:
        fail(f"train 1 --fused-block --layout=NHWC launched K5a (tc)/K5b "
             f"data (tc)/weights (tc) {fused} times in {len(losses)} steps, "
             "expected none (JAX's dispatch: fused_block and not nhwc)")
    ep = _epoch_line(text, 0)
    return (f"train 1 --image-size=64 --layout=NHWC --max-steps="
            f"{P26_TRAIN_STEPS} from the seed's init {secs:.2f} s wall, epoch"
            f" {ep['epoch_seconds']} s ({ep['images_per_sec']} images/s): "
            f"K2/K2c/K2d {counts}; loss mean of steps 1-10 {head:.5f}, of "
            f"the last 10 {tail:.5f}; then train 1 --fused-block "
            f"--layout=NHWC at 32x32 ({P26_FUSED_STEPS} steps, {fused_s:.2f}"
            f" s): K5a/K5b launches {fused} (none)"), where


def _p26_grad(params, device: str) -> str:
    """Phase 10's conditioned net (the same draws): the f32 NHWC gradient
    against the NCHW one, leaf by leaf, within max(P26_GRAD_FLOOR, 2 x the
    leaf's NCHW f32 distance from f64); the TF32 control fails."""
    import dataclasses

    from big_linear_algebra_tpu_torch.models import cifar_unet as cu
    from big_linear_algebra_tpu_torch.nn import attention as at

    cfg = dataclasses.replace(_p25_cfg(device), dropout_rate=0.0)
    gen = torch.Generator().manual_seed(7)
    x0 = torch.rand(2, 3, 64, 64, generator=gen) * 2 - 1
    tt = torch.randint(0, cfg.timesteps, (2,), generator=gen)
    noise = torch.randn(2, 3, 64, 64, generator=gen)
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    conditioned, _ = _condition_attention(cu, params, x0, tt, noise, f32,
                                          device)
    grads, counts = {}, {}
    for name, tree, dt, layout in (
            ("nchw", conditioned, "float32", "NCHW"),
            ("nhwc", conditioned, "float32", "NHWC"),
            ("f64", conditioned, "float64", "NCHW"),
            ("tf32", _tf32_tree(cu, conditioned), "float32", "NCHW")):
        _zero_flash_counts(at)
        c = dataclasses.replace(cfg, compute_dtype=dt, layout=layout)
        xin = _tf32(x0.float()) if name == "tf32" else x0
        grads[name] = [g.double() for g in _unet_grad(
            cu, tree, xin, tt, noise, c, device)[1]]
        counts[name] = _flash_counts(at)
    want = (0, 0, 0) if device == "cpu" else (4, 4, 4)
    if counts["nchw"] != want or counts["nhwc"] != want:
        fail(f"phase 26 gradients launched K2/K2c/K2d {counts}")
    def of_max(got, ref):
        scale = ref.abs().max().item()
        err = (got - ref).abs().max().item()
        return err / scale if scale else err

    worst, worst_ctl, where = 0.0, 0.0, None
    for i, (a, b, f, ctl) in enumerate(zip(grads["nhwc"], grads["nchw"],
                                           grads["f64"], grads["tf32"])):
        bound = max(P26_GRAD_FLOOR, 2 * of_max(b, f))
        if of_max(a, b) / bound > worst:
            worst, where = of_max(a, b) / bound, i
        worst_ctl = max(worst_ctl, of_max(ctl, b) / bound)
    if not worst <= 1.0:
        fail(f"phase 26: the f32 NHWC gradient exceeds its bound at leaf "
             f"{where} by {worst:.3f}x")
    if not worst_ctl > 1.0:
        fail(f"phase 26 TF32 control: the TF32 gradient stays within the "
             f"bound (worst leaf {worst_ctl:.3f} of it)")
    share = _leaf_errors(grads["nhwc"], grads["nchw"])
    own = _leaf_errors(grads["nchw"], grads["f64"])
    return (f"f32 gradient on phase 10's conditioned net (batch 2, t="
            f"{tt.tolist()}, dropout off), NHWC vs NCHW: worst leaf "
            f"{share[0]:.3e} of its max|ref| (median {share[2]:.3e}), worst "
            f"err/bound {worst:.3f} (leaf {where}); NCHW f32 vs f64 worst "
            f"leaf {own[0]:.3e}; TF32 control worst err/bound "
            f"{worst_ctl:.1f} (fails)")


def _p26_steps(params, device: str) -> tuple:
    """The bf16 train step at 64x64, batch 16 (TINY at 4 on the CPU), from
    the loaded parameters: ``--remat`` bit-equal to the plain step (loss,
    parameters, both moments, the generator's state after it), each one's
    peak of allocated memory above the step's inputs; then host wall and
    (on the card) device busy per step of NCHW, NHWC and ``--remat`` in
    turns, each turn ``_host_and_trace`` (the lower host time of each kept).
    Returns (lines, {mode: (host ms, busy ms)})."""
    import dataclasses

    from big_linear_algebra_tpu_torch.models import cifar_unet as cu
    from big_linear_algebra_tpu_torch.nn.optim import tree_leaves

    cfg = _p25_cfg(device)
    modes = {"nchw": cfg, "nhwc": dataclasses.replace(cfg, layout="NHWC"),
             "remat": dataclasses.replace(cfg, remat=True)}
    p = cu.tree_map(lambda a: a.to(device), params)
    opt = cu.adam_init(p)
    x = (torch.rand(cfg.batch_size, 3, 64, 64,
                    generator=torch.Generator().manual_seed(26)) * 2 - 1
         ).to(device)

    def one(c, seed=3):
        gen = torch.Generator(device=device).manual_seed(seed)
        out = cu.train_step(p, opt, x, gen, c)
        return out, gen.get_state()

    runs, peaks = {}, {}
    for name in ("nchw", "remat", "nhwc"):
        one(modes[name])  # warm
        _sync(device)
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        runs[name] = one(modes[name])
        _sync(device)
        if device == "cuda":
            peaks[name] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    (pa, oa, la), ga = runs["nchw"]
    (pb, ob, lb), gb = runs["remat"]
    same = (torch.equal(la, lb) and torch.equal(ga, gb) and all(
        torch.equal(u, v) for u, v in zip(
            tree_leaves({"p": pa, "m": oa.m, "v": oa.v}),
            tree_leaves({"p": pb, "m": ob.m, "v": ob.v}))))
    if not same:
        fail("phase 26: the --remat step is not bit-equal to the plain step")
    del runs, pa, oa, pb, ob
    gen = torch.Generator(device=device).manual_seed(0)

    def step(name):
        return lambda: cu.train_step(p, opt, x, gen, modes[name])

    times = {name: [] for name in modes}
    for name in ("nchw", "nhwc", "remat", "remat", "nhwc", "nchw"):
        if device == "cuda":
            host, busy, _, _ = _host_and_trace(step(name), 1, warmup=1,
                                               timed=P26_TIMED_STEPS)
        else:
            step(name)()
            t0 = time.perf_counter()
            step(name)()
            host, busy = (time.perf_counter() - t0) * 1e3, None
        times[name].append((host, busy))
    best = {name: min(v) for name, v in times.items()}
    mem = (f"peak allocated above the step's inputs {peaks['nchw']:.1f} "
           f"MiB NCHW, {peaks['remat']:.1f} MiB --remat, {peaks['nhwc']:.1f}"
           f" MiB NHWC" if peaks else "no device memory on the CPU")
    lines = [f"--remat step ({cfg.compute_dtype}, batch {cfg.batch_size}, "
             f"64x64) "
             f"bit-equal to the plain step (loss {float(la):.6f}, every "
             f"parameter and moment, the generator's state); {mem}"]

    def fmt(name):
        host, busy = best[name]
        return (f"{name} {host:.3f} ms host" + (
            f", busy {busy:.3f} ms ({busy / host:.1%})" if busy else ""))

    lines.append(f"train step in turns (nchw, nhwc, remat, remat, nhwc, "
                 f"nchw; the lower host time of each): {fmt('nchw')}; "
                 f"{fmt('nhwc')}; {fmt('remat')}; remat's recompute "
                 f"{best['remat'][0] - best['nchw'][0]:+.3f} ms host a step")
    return lines, best, peaks


def _p26_dp_rank(tmp: str, device: str) -> int:
    """One rank of phase 26's launch (``chip_smoke.py --phase26-rank TMP
    DEVICE``): ``cifar_unet train 1 --dp --layout=NHWC --remat
    --max-steps=P26_DP_STEPS --image-size=64`` in ``TMP`` with each step's
    loss and parameter hash, the recomputed blocks and K2/K2c/K2d's
    launches; written to ``TMP/rank<r>.pt``."""
    from big_linear_algebra_tpu_torch.models import cifar_unet as cu
    from big_linear_algebra_tpu_torch.nn import attention as at
    from big_linear_algebra_tpu_torch.parallel import mesh as pmesh

    rank = pmesh.distributed_init(device=device)
    hashes, losses, blocks = [], [], [0]

    def spy(real):
        def make(*a, **kw):
            step = real(*a, **kw)

            def wrapped(*args, **kwargs):
                params, opt, loss = step(*args, **kwargs)
                losses.append(loss.float().cpu())
                hashes.append(_params_hash(params))
                return params, opt, loss
            return wrapped
        return make

    def count(real):
        def recomputed(*a):
            blocks[0] += 1
            return real(*a)
        return recomputed

    tiny = ["--tiny", "--batch=4"] if device == "cpu" else []
    _zero_flash_counts(at)
    with _wrapped(cu, "make_train_step_dp", spy), \
            _wrapped(cu, "_recomputed", count):
        text, secs = _cli(cu, ["train", "1", "--dp", "--layout=NHWC",
                               "--remat", "--image-size=64",
                               f"--max-steps={P26_DP_STEPS}", *tiny],
                          tmp, device)
    torch.save({"rank": rank, "hashes": hashes, "losses": losses,
                "blocks": blocks[0], "flash": _flash_counts(at),
                "seconds": secs, "text": text},
               os.path.join(tmp, f"rank{rank}.pt"))
    return 0


def _p26_dp(tmp: str, device: str) -> str:
    """The launch of ``_p26_dp_rank`` on P26_DP_RANKS ranks: the replicas
    bit-equal after every step, the losses finite and alike, 18 blocks
    recomputed a step, K2/K2c/K2d 4 each a step per rank."""
    where = _p26_data_dir(tmp, "p26_dp")
    _, seconds = _run_ranks(where, device, P26_DP_RANKS,
                            ["--phase26-rank", where, device], "phase 26")
    ranks = [torch.load(os.path.join(where, f"rank{r}.pt"),
                        weights_only=False) for r in range(P26_DP_RANKS)]
    r0 = ranks[0]
    if len(r0["hashes"]) != P26_DP_STEPS:
        fail(f"phase 26 --dp: {len(r0['hashes'])} steps:\n{r0['text']}")
    for r in ranks[1:]:
        if r["hashes"] != r0["hashes"]:
            fail("phase 26 --dp --layout=NHWC --remat: the replicas' "
                 "parameters differ")
        if not all(torch.equal(a, b) for a, b in zip(r["losses"],
                                                     r0["losses"])):
            fail("phase 26 --dp: the ranks' pmean'd losses differ")
    per = 0 if device == "cpu" else 4 * P26_DP_STEPS
    for r in ranks:
        if r["blocks"] != 18 * P26_DP_STEPS:
            fail(f"phase 26 --dp --remat: rank {r['rank']} recomputed "
                 f"{r['blocks']} blocks, expected {18 * P26_DP_STEPS}")
        if r["flash"] != (per,) * 3:
            fail(f"phase 26 --dp: rank {r['rank']} launched K2/K2c/K2d "
                 f"{r['flash']} times, expected {per} each")
    vals = torch.stack(r0["losses"])
    if not torch.isfinite(vals).all():
        fail(f"phase 26 --dp: non-finite losses {vals.tolist()}")
    epoch = _epoch_line(r0["text"], 0)["epoch_seconds"]
    cli_s = ", ".join(f"{r['seconds']:.1f}" for r in ranks)
    return (f"python3 -m torch.distributed.run --nproc-per-node="
            f"{P26_DP_RANKS}: train 1 --dp --layout=NHWC --remat "
            f"--image-size=64 --max-steps={P26_DP_STEPS} from the seed's "
            f"init, {seconds:.1f} s of wall for the launch (the CLI "
            f"{cli_s} s on the ranks, rank 0's {P26_DP_STEPS} steps "
            f"{epoch} s): "
            f"replicas bit-equal after each step, losses {vals.tolist()}, "
            f"{r0['blocks']} blocks recomputed and K2/K2c/K2d {r0['flash']} "
            "per rank")


def phase_nhwc_remat(tmp: str, nchw_run_k2: int, smi_line: str = "",
                     device: str = "cuda") -> dict:
    """Phase 26 (run after 10, in its data directory ``tmp``): the
    channels-last twins against the NCHW ops (``_p26_twins``); ``run 1
    --image-size=64 --layout=NHWC`` (K2 as often as NCHW's run,
    ``nchw_run_k2``) and its bf16 forward against NCHW's; ``train 1
    --layout=NHWC`` from the seed's init and ``--fused-block
    --layout=NHWC`` (``_p26_train``); the f32 NHWC gradient on phase 10's
    conditioned net (``_p26_grad``); ``--remat`` bit-equal, its memory
    and time beside NCHW's and NHWC's steps (``_p26_steps``); one launch
    of ``train 1 --dp --layout=NHWC --remat`` on two ranks (``_p26_dp``).
    Returns the step readings."""
    t0 = time.perf_counter()
    lines = [f"[26 twins] {line}" for line in _p26_twins(device)]
    line, params = _p26_run(tmp, device, nchw_run_k2)
    lines.append(f"[26 nhwc run] {line}; {_p26_forward(params, device)}")
    line, _ = _p26_train(tmp, device)
    lines.append(f"[26 nhwc train] {line}")
    lines.append(f"[26 nhwc grad] {_p26_grad(params, device)}")
    step_lines, best, peaks = _p26_steps(params, device)
    lines += [f"[26 steps] {line}" for line in step_lines]
    del params
    lines.append(f"[26 dp] {_p26_dp(tmp, device)}")
    lines.append(f"[26 total] {time.perf_counter() - t0:.1f} s")
    for line in lines:
        print(f"{line} | {smi_line}" if smi_line else line, flush=True)
    return {"steps": best, "peaks": peaks}


# Phase 27: the XLA dispatch modes as replayed CUDA graphs
# (utils/graphs.py). A CIFAR set of P27_EXAMPLES (a 50-step epoch at batch
# 16) for the CLI epoch; P27_STEPS steps a configuration in the Python
# comparisons (one warm-up step, then replays of 4); --scan-steps=5 over
# P27_SCAN_STEPS steps (one eager chunk as the warm-up, three replays, a
# tail of three); the sampler on P27_SAMPLE_STEPS timesteps, timed by the
# slope between P27_SAMPLE_STEPS and P27_SAMPLE_LONG; P27_TIMED steps a
# timed run (two replays of 4).
P27_EXAMPLES = 800
P27_STEPS = 21
P27_SCAN, P27_SCAN_STEPS = 5, 23
P27_SAMPLE_STEPS, P27_SAMPLE_LONG = 40, 200
P27_TIMED = 8
# the counters against the profiler: replays profiled, and the margin the
# profiler runs before and after them
P27_PROFILED_REPLAYS, P27_PROFILE_MARGIN_S = 2, 0.05
P27_COUNTERS_TIMEOUT_S = 600
# The kernels' CUDA entry names, for counting launches in a profiler trace
P27_KERNELS = {"K1": r"mm_kernel", "K2": r"flash_fwd_(tc|kernel)",
               "K2c": r"flash_bwd_dq_(tc|kernel)",
               "K2d": r"flash_bwd_dkv_(tc|kernel)",
               "K5a": r"fused_block_fwd_(tc|kernel)",
               "K5b data": r"fused_block_bwd_(tc|kernel)",
               "K5b wgrad": r"fused_block_wgrad_(tc|kernel)",
               "Adam": r"bla_adam_kernel"}
# The same kernels by their launch counters (utils/graphs.py's names)
P27_COUNTERS = {
    "K1": ("big_linear_algebra_tpu_torch.ops.matmul", "launch_count", None),
    "K2": ("big_linear_algebra_tpu_torch.nn.attention", "launch_count",
           None),
    "K2c": ("big_linear_algebra_tpu_torch.nn.attention",
            "bwd_dq_launch_count", None),
    "K2d": ("big_linear_algebra_tpu_torch.nn.attention",
            "bwd_dkv_launch_count", None),
    "K5a": ("big_linear_algebra_tpu_torch.nn.fused_block", "launch_count",
            None),
    "K5b data": ("big_linear_algebra_tpu_torch.nn.fused_block",
                 "bwd_launch_count", None),
    "K5b wgrad": ("big_linear_algebra_tpu_torch.nn.fused_block",
                  "wgrad_launch_count", None),
    "Adam": ("big_linear_algebra_tpu_torch.nn.optim", "adam_launch_count",
             None)}


def _span_share(summary: str) -> str:
    """The device's busy share of a trace's span, as ``trace_summary.py``
    prints it."""
    return re.search(r"= ([0-9.]+%) of the span", summary).group(1)


def _p27_counts(fn):
    """(fn's result, {kernel: launches during fn}) by the counters."""
    from big_linear_algebra_tpu_torch.utils import graphs

    before = graphs.launch_counts()
    out = fn()
    after = graphs.launch_counts()
    return out, {k: after[key] - before[key]
                 for k, key in P27_COUNTERS.items()
                 if after[key] != before[key]}


def _p27_same(a, b) -> bool:
    """Two trees (or tensors) bit for bit."""
    from big_linear_algebra_tpu_torch.nn.optim import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _adam_a_step(params, device: str) -> int:
    """The in-place Adam pass's launches in one ``TrainSteps`` step on
    ``params``: one a group of ``bla_adam_leaves_per_launch()`` leaves for
    f32 parameters on the card, none elsewhere (the plain update)."""
    from big_linear_algebra_tpu_torch.nn.optim import tree_leaves
    from big_linear_algebra_tpu_torch.ops import cuda_utils

    leaves = tree_leaves(params)
    if device != "cuda" or any(x.dtype != torch.float32 for x in leaves):
        return 0
    group = cuda_utils.load_library("adam").bla_adam_leaves_per_launch()
    return -(-len(leaves) // group)


def _adam_apart(counts: dict, want: int, what: str) -> dict:
    """``counts`` without the in-place Adam pass's launches, which must be
    ``want``: a graphed step takes the pass, the eager step it is held
    against keeps the plain update."""
    rest = dict(counts)
    got = rest.pop("Adam", 0)
    if got != want:
        fail(f"{what}: the in-place Adam pass launched {got} times, "
             f"expected {want}")
    return rest


def _p27_profiled_launches(fn, calls: int) -> dict:
    """{kernel: launches} of ``calls`` calls of ``fn`` by ``torch.profiler``'s
    device events. The calls start P27_PROFILE_MARGIN_S after the profiler
    does, and it stops as long after they end: a kernel that seems to start
    before the profiler (the device and host clocks are aligned only so
    closely) is dropped from its events."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        time.sleep(P27_PROFILE_MARGIN_S)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        time.sleep(P27_PROFILE_MARGIN_S)
    out = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for k, pat in P27_KERNELS.items():
            if re.search(pat, e.name):
                out[k] = out.get(k, 0) + 1
    return out


def _p27_sample(params, device: str) -> list:
    """Sampling at full width, 64x64, one image: the graphed sampler
    against the eager one on a P27_SAMPLE_STEPS-step schedule, bit-equal
    images, K2 4 a step either way; then each one's host time a step (the
    slope between P27_SAMPLE_STEPS and P27_SAMPLE_LONG steps, capture and
    warm-up cancelled) in turns, and on the card each one's device busy
    time a step over a traced P27_SAMPLE_STEPS-step run."""
    import dataclasses

    from big_linear_algebra_tpu_torch.models import cifar_unet as cu

    base = _p25_cfg(device)
    cfg = dataclasses.replace(base, timesteps=P27_SAMPLE_STEPS)
    graphed = device == "cuda"

    def run(g, steps=P27_SAMPLE_STEPS):
        c = dataclasses.replace(base, timesteps=steps)
        gen = torch.Generator(device=device).manual_seed(0)
        return cu.sample(params, gen, c, 1, graphed=g and graphed)

    imgs, counts = {}, {}
    for g in (False, True):
        imgs[g], counts[g] = _p27_counts(lambda: run(g))
        _sync(device)
    want_k2 = 4 * cfg.timesteps if device == "cuda" else 0
    for g in (False, True):
        if counts[g].get("K2", 0) != want_k2:
            fail(f"phase 27 sampling (graphed {g}): K2 launched "
                 f"{counts[g]}, expected {want_k2}")
    if not torch.equal(imgs[True], imgs[False]):
        fail("phase 27: the graphed sampler's image is not bit-equal to the "
             "eager sampler's")
    secs = {False: [], True: []}
    for g in (False, True, True, False):
        lens = {}
        for steps in (P27_SAMPLE_STEPS, P27_SAMPLE_LONG):
            _sync(device)
            gc.collect()  # the capture's own collection then costs alike
            t0 = time.perf_counter()
            run(g, steps)
            _sync(device)
            lens[steps] = time.perf_counter() - t0
        secs[g].append((lens[P27_SAMPLE_LONG] - lens[P27_SAMPLE_STEPS])
                       / (P27_SAMPLE_LONG - P27_SAMPLE_STEPS) * 1e3)
    host = {g: min(v) for g, v in secs.items()}
    busy = {}
    if device == "cuda":
        for g in (False, True):
            _, b, summary, _ = _host_and_trace(lambda: run(g), 1, warmup=0,
                                               timed=1)
            busy[g] = (b / P27_SAMPLE_STEPS, _span_share(summary))

    def fmt(g):
        out = f"{host[g]:.3f} ms host a step"
        if g in busy:
            out += (f", device busy {busy[g][0]:.3f} ms a step ({busy[g][1]}"
                    f" of a traced {P27_SAMPLE_STEPS}-step run's span"
                    + (", its warm-up and capture included" if g else "")
                    + ")")
        return out

    return [f"full width 64x64, {P27_SAMPLE_STEPS} timesteps: the graphed "
            f"sampler's image bit-equal to the eager one's, K2 {want_k2} "
            f"launches each (4 a step); in turns (eager, graph, graph, "
            f"eager; the slope between {P27_SAMPLE_STEPS} and "
            f"{P27_SAMPLE_LONG} steps, the lower of each): eager {fmt(False)};"
            f" graph {fmt(True)}; {host[False] / host[True]:.2f}x fewer host "
            f"ms a step"]


def _p27_run_cli(tmp: str, device: str) -> str:
    """``run 1 --image-size=64`` through the CLI on the tree in ``tmp``
    (phase 10's): the graphed sampler, K2's launches by the counters."""
    from big_linear_algebra_tpu_torch.models import cifar_unet as cu

    tiny = _tiny(device)[:1]
    (text, secs), counts = _p27_counts(lambda: _cli(
        cu, ["run", "1", "--image-size=64", "--sample-seed=0", *tiny], tmp,
        device))
    steps = (cu.TINY if tiny else cu.CONFIG).timesteps
    want = 4 * steps if device == "cuda" else 0
    if counts.get("K2", 0) != want:
        fail(f"phase 27: run 1 --image-size=64 launched {counts}, expected "
             f"K2 {want}")
    return (f"run 1 --image-size=64 ({steps} steps, graphs of 4) "
            f"{secs:.2f} s wall: K2 launches {counts.get('K2', 0)} by the "
            f"counters")


def _p27_train_cli(tmp: str, device: str) -> str:
    """``train 1 --image-size=64`` (the graphed device epoch) against
    ``train 1 --image-size=64 --host-loop`` (eager steps), each in a fresh
    data directory holding a P27_EXAMPLES-example CIFAR set and phase 10's
    CSV tree: the saved train states bit-equal (parameters, Adam moments
    and step, the generator's state), the same average loss, K2, K2c and
    K2d 4 a step either way."""
    import shutil

    from big_linear_algebra_tpu_torch.ckpt import pytree
    from big_linear_algebra_tpu_torch.data import synth
    from big_linear_algebra_tpu_torch.models import cifar_unet as cu

    tiny = _tiny(device)
    per_batch = P27_EXAMPLES // 5 if device == "cuda" else 4
    states, lines, counts, secs = {}, {}, {}, {}
    for mode in ("graph", "host-loop"):
        where = os.path.join(tmp, f"p27_{mode}")
        synth.ensure_cifar(where, n_batches=5, per_batch=per_batch)
        shutil.copytree(os.path.join(tmp, "cifar_unet"),
                        os.path.join(where, "cifar_unet"),
                        ignore=shutil.ignore_patterns("train_state*",
                                                      "samples"))
        args = ["train", "1", "--image-size=64", *tiny] + (
            ["--host-loop"] if mode == "host-loop" else [])
        (text, secs[mode]), counts[mode] = _p27_counts(
            lambda: _cli(cu, args, where, device))
        lines[mode] = _epoch_line(text, 0)
        os.environ["BLA_DATA_DIR"] = where
        step = pytree.latest_step(cu.state_dir())
        states[mode] = pytree.restore_pytree(cu.state_dir(), step)
        del os.environ["BLA_DATA_DIR"]
        shutil.rmtree(where)
    a, b = states["graph"], states["host-loop"]
    steps = int(b["opt"]["step"])
    same = (_p27_same(a["params"], b["params"])
            and _p27_same(a["opt"]["m"], b["opt"]["m"])
            and _p27_same(a["opt"]["v"], b["opt"]["v"])
            and a["opt"]["step"] == b["opt"]["step"]
            and torch.equal(a["rng"], b["rng"])
            and lines["graph"]["avg_loss"] == lines["host-loop"]["avg_loss"])
    if not same:
        fail("phase 27: train 1's graphed epoch is not bit-equal to "
             "--host-loop's (train state or average loss)")
    want = ({"K2": 4 * steps, "K2c": 4 * steps, "K2d": 4 * steps}
            if device == "cuda" else {})
    adam = steps * _adam_a_step(a["params"], device)
    for mode in counts:
        rest = _adam_apart(counts[mode], adam if mode == "graph" else 0,
                           f"phase 27: train 1 ({mode})")
        if rest != want:
            fail(f"phase 27: train 1 ({mode}) launched {counts[mode]}, "
                 f"expected {want}")
    return (f"train 1 --image-size=64 from the tree in {tmp} (phase 10's "
            f"in the full script), {steps} steps "
            f"at batch {cu.CONFIG.batch_size if device == 'cuda' else 4}: "
            f"the graphed epoch's train state bit-equal to --host-loop's "
            f"(parameters, Adam moments, step {steps}, the generator's "
            f"state; avg_loss {lines['graph']['avg_loss']} both), launches "
            f"{want} both, and the graphed epoch's in-place Adam {adam}; "
            f"epoch_seconds "
            f"{lines['graph']['epoch_seconds']} graphed (its capture "
            f"included), {lines['host-loop']['epoch_seconds']} --host-loop; "
            f"CLI wall {secs['graph']:.2f} s and {secs['host-loop']:.2f} s")


def _p27_configs(device: str) -> dict:
    """The configurations phase 27 holds graphed against eager steps."""
    import dataclasses

    from big_linear_algebra_tpu_torch.models import cifar_unet as cu

    base = _p25_cfg(device)
    fused = (dataclasses.replace(cu.TINY, batch_size=4, fused_block=True)
             if device == "cpu" else
             dataclasses.replace(cu.CONFIG, fused_block=True))
    return {"64x64 bf16": base,
            "32x32 --fused-block": fused,
            "--remat": dataclasses.replace(base, remat=True),
            "--bf16-params": dataclasses.replace(base,
                                                 param_dtype="bfloat16"),
            "--layout=NHWC": dataclasses.replace(base, layout="NHWC")}


def _p27_train_steps(params, device: str) -> list:
    """Per configuration (``_p27_configs``) from the same parameters and a
    synthesized resident set: ``TrainSteps`` (one warm-up step, then
    replays of 4) against P27_STEPS ``train_step`` calls on the same
    batches and generator seed, every parameter, both moments, every
    loss and the generator's state bit for bit, the launches a step
    equal; then ``--scan-steps=5`` (chunks of 5, the first the warm-up,
    and a ragged tail of 3 step by step) the same way."""
    import numpy as np

    from big_linear_algebra_tpu_torch.models import cifar_unet as cu
    from big_linear_algebra_tpu_torch.nn.optim import adam_init

    lines = []
    cases = [(name, cfg, None, P27_STEPS)
             for name, cfg in _p27_configs(device).items()]
    cases.append((f"--scan-steps={P27_SCAN} with a ragged tail", cases[0][1],
                  P27_SCAN, P27_SCAN_STEPS))
    for name, cfg, unroll, n in cases:
        b = cfg.batch_size
        data = torch.from_numpy(np.random.default_rng(27).uniform(
            -1, 1, (b * n, 3, 32, 32)).astype(np.float32)).to(device)
        rows = torch.from_numpy(np.random.default_rng(28).permutation(
            b * n)).to(device).reshape(n, b)
        p = cu.tree_map(lambda a: a.to(device), cu.cast_params(params, cfg))

        def eager():
            gen = torch.Generator(device=device).manual_seed(7)
            q, opt, losses = p, adam_init(p), []
            for r in rows:
                q, opt, loss = cu.train_step(q, opt, cu._fit_images(
                    data[r], cfg), gen, cfg)
                losses.append(loss)
            return q, opt, torch.stack(losses), gen.get_state()

        def graphed():
            gen = torch.Generator(device=device).manual_seed(7)
            steps = cu.TrainSteps(p, adam_init(p), data, gen, cfg,
                                  unroll=unroll)
            whole = n if unroll is None else n // unroll * unroll
            losses = torch.cat([steps.run(rows[:whole]),
                                steps.run(rows[whole:])])
            return (steps.params, steps.opt_state(), losses,
                    gen.get_state(), steps.graph.replays)

        (q, opt, losses, state), want = _p27_counts(eager)
        got, counts = _p27_counts(graphed)
        want = _adam_apart(want, 0, f"phase 27 ({name}): train_step")
        adam = n * _adam_a_step(p, device)
        counts = _adam_apart(counts, adam, f"phase 27 ({name})")
        same = (_p27_same(got[0], q) and _p27_same(got[1].m, opt.m)
                and _p27_same(got[1].v, opt.v) and got[1].step == opt.step
                and torch.equal(got[2], losses) and torch.equal(got[3], state))
        if not same:
            fail(f"phase 27 ({name}): the graphed steps are not bit-equal to "
                 f"the eager steps")
        if counts != want:
            fail(f"phase 27 ({name}): launches {counts} graphed, {want} "
                 f"eager")
        if device == "cuda" and got[4] == 0:
            fail(f"phase 27 ({name}): no replay ran")
        per_step = {k: v / n for k, v in want.items()}
        lines.append(f"{name}: {n} steps, {got[4]} replays; parameters, "
                     f"moments, losses ({float(losses[0]):.6f} .. "
                     f"{float(losses[-1]):.6f}) and the generator's state "
                     f"bit-equal to train_step's; launches a step {per_step}"
                     f" both, and graphed the in-place Adam {adam / n:g}")
        del p, q, opt, got, data
    return lines


def _p27_mnist(tmp: str, device: str) -> tuple:
    """mnist_nn's resident epoch on the 8192-image synthesized set: the
    graphed epoch (``ResidentEpoch``) against the eager one from the same
    initial parameters, bit-equal parameters and metrics, K1 640 (128 steps
    x 5) by the counters either way. Returns (line, the data and the
    initial parameters for the timings)."""
    import numpy as np

    from big_linear_algebra_tpu_torch.data import synth
    from big_linear_algebra_tpu_torch.data.mnist import MnistDataset
    from big_linear_algebra_tpu_torch.models import mnist_nn

    cfg = mnist_nn.CONFIG
    train_csv, _ = synth.ensure_mnist(os.path.join(tmp, "p27_mnist"))
    data = MnistDataset.from_csv(train_csv)
    x = torch.from_numpy(data.x).to(device)
    y = torch.from_numpy(data.y).to(device)
    perm = torch.from_numpy(mnist_nn.epoch_permutation(
        np.random.default_rng(cfg.seed), data.num_examples,
        cfg.batch_size)).to(device)
    p0 = mnist_nn.init_params(torch.Generator().manual_seed(cfg.seed), cfg)
    out = {}
    for graphed in (False, True):
        model = mnist_nn.MnistNN.from_params(p0, cfg, device=device)
        (c, ce), counts = _p27_counts(lambda: mnist_nn.epoch_step_resident(
            model, x, y, perm, cfg, graphed=graphed and device == "cuda"))
        out[graphed] = (model.params(), c, ce, counts)
    steps = perm.shape[0] // cfg.batch_size
    want = {"K1": 5 * steps} if device == "cuda" else {}
    a, b = out[True], out[False]
    if not (_p27_same(a[0], b[0]) and torch.equal(a[1], b[1])
            and torch.equal(a[2], b[2])):
        fail("phase 27: mnist_nn's graphed resident epoch is not bit-equal "
             "to the eager one")
    if a[3] != want or b[3] != want:
        fail(f"phase 27: mnist_nn epoch launched {a[3]} graphed, {b[3]} "
             f"eager, expected {want}")
    line = (f"mnist_nn train epoch, {data.num_examples} images, {steps} "
            f"steps: the graphed resident epoch bit-equal to the eager one "
            f"(every leaf, correct {int(a[1])}, ce_sum {float(a[2]):.4f}), "
            f"launches {a[3]} either way")
    return line, (x, y, perm, p0)


def _p27_cross_check(params, mnist, device: str) -> str:
    """For P27_PROFILED_REPLAYS replays of the mnist_nn epoch's graph, of
    the 64x64 train step's and of the 32x32 --fused-block one's: the
    launches the counters add against the kernels ``torch.profiler``
    records in those replays."""
    from big_linear_algebra_tpu_torch.models import cifar_unet as cu
    from big_linear_algebra_tpu_torch.models import mnist_nn
    from big_linear_algebra_tpu_torch.nn.optim import adam_init

    x, y, perm, p0 = mnist
    cfg = mnist_nn.CONFIG
    epoch = mnist_nn.ResidentEpoch(
        mnist_nn.MnistNN.from_params(p0, cfg, device=device), x, y, cfg)
    epoch(perm)
    graphs = {"mnist_nn": epoch}
    for name, c in list(_p27_configs(device).items())[:2]:
        b = c.batch_size
        # rows for a warm-up step and the two profiled replays of 4
        data = (torch.rand(b * 9, 3, 32, 32, device=device) * 2 - 1)
        p = cu.tree_map(lambda a: a.to(device), cu.cast_params(params, c))
        steps = cu.TrainSteps(p, adam_init(p), data,
                              torch.Generator(device=device).manual_seed(1),
                              c)
        steps.run(torch.arange(b * 9, device=device).reshape(9, b))
        graphs[name] = steps
    parts = []
    for name, holder in graphs.items():
        g = holder.graph

        def replays():
            holder.counter.zero_()  # replays over the first rows
            for _ in range(P27_PROFILED_REPLAYS):
                g.replay()

        _, by_counter = _p27_counts(replays)
        profiled = _p27_profiled_launches(replays, 1)
        if profiled != by_counter:
            fail(f"phase 27: {P27_PROFILED_REPLAYS} replays of {name}'s "
                 f"graph: the counters add {by_counter}, the profiler "
                 f"records {profiled}")
        parts.append(f"{name} ({g.unroll} steps) {by_counter}")
    return (f"{P27_PROFILED_REPLAYS} replays, the counters' launches equal "
            f"to the profiler's kernels: " + "; ".join(parts))


def _p27_counters_child() -> int:
    """``chip_smoke.py --phase27-counters``: ``_p27_cross_check`` in a
    process of its own, on the seed's init and a synthesized mnist set
    (the kernels it launches are built already); prints its line."""
    import numpy as np

    from big_linear_algebra_tpu_torch.models import cifar_unet as cu
    from big_linear_algebra_tpu_torch.models import mnist_nn

    g = torch.Generator().manual_seed(0)
    x = torch.randint(0, 256, (8192, 784), generator=g).float().cuda()
    y = torch.randint(0, 10, (8192,), generator=g).to(torch.uint8).cuda()
    cfg = mnist_nn.CONFIG
    perm = torch.from_numpy(mnist_nn.epoch_permutation(
        np.random.default_rng(cfg.seed), 8192, cfg.batch_size)).cuda()
    p0 = mnist_nn.init_params(torch.Generator().manual_seed(cfg.seed), cfg)
    params = cu.init_params(torch.Generator().manual_seed(42),
                            _p25_cfg("cuda"))
    print(_p27_cross_check(params, (x, y, perm, p0), "cuda"), flush=True)
    return 0


def _p27_counters() -> str:
    """``_p27_cross_check`` in a fresh process (``--phase27-counters``).
    In the full script's long-lived process the profiler's trace of the
    mnist_nn graph's replays held 5 fewer K1 kernels than were launched,
    twice (with one replay and with two), while a fresh process on the
    same card records every one and the replays' results are bit-equal to
    the eager steps': a profiler artifact of that process, not understood
    yet."""
    out = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--phase27-counters"], capture_output=True,
                         text=True, timeout=P27_COUNTERS_TIMEOUT_S)
    lines = [line for line in out.stdout.splitlines() if line.strip()]
    if out.returncode != 0 or not lines:
        fail(f"phase 27 counters (a fresh process) exited {out.returncode}:"
             f"\n{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    return lines[-1]


def _p27_timings(params, mnist, device: str) -> list:
    """Graph against eager in turns (eager, graph, graph, eager; the lower
    of each): the 64x64 bf16 train step at batch 16 (``train_step`` calls
    against ``TrainSteps`` replays) and the mnist_nn step at batch 64
    (``ResidentEpoch`` eager against graphed): host ms a step (P27_TIMED
    steps a timed run, synchronised, no profiler), on the card device busy
    a step from one traced run and images/s; then the peak of allocated
    memory above the inputs, eager against graphs of 4 and of 1 step."""
    import numpy as np

    import dataclasses

    from big_linear_algebra_tpu_torch.models import cifar_unet as cu
    from big_linear_algebra_tpu_torch.models import mnist_nn
    from big_linear_algebra_tpu_torch.nn.optim import adam_init

    cfg = _p25_cfg(device)
    b, n = cfg.batch_size, P27_TIMED
    p = cu.tree_map(lambda a: a.to(device), params)
    data = torch.from_numpy(np.random.default_rng(27).uniform(
        -1, 1, (b * n, 3, 32, 32)).astype(np.float32)).to(device)
    rows = torch.arange(b * n, device=device).reshape(n, b)
    gen = torch.Generator(device=device).manual_seed(0)
    state = {"p": p, "opt": adam_init(p)}

    def eager():
        for r in rows:
            state["p"], state["opt"], _ = cu.train_step(
                state["p"], state["opt"], cu._fit_images(data[r], cfg), gen,
                cfg)

    steps = cu.TrainSteps(p, adam_init(p), data, gen, cfg)
    steps.run(rows)  # warm-up and capture
    x, y, perm, p0 = mnist
    mcfg = mnist_nn.CONFIG
    epochs = {g: mnist_nn.ResidentEpoch(
        mnist_nn.MnistNN.from_params(p0, mcfg, device=device), x, y, mcfg,
        graphed=g and device == "cuda") for g in (False, True)}
    epochs[True](perm)  # warm-up and capture
    m_steps = perm.shape[0] // mcfg.batch_size
    runs = {("unet", False): (eager, n, b),
            ("unet", True): (lambda: steps.run(rows), n, b),
            ("mnist_nn", False): (lambda: epochs[False](perm), m_steps,
                                  mcfg.batch_size),
            ("mnist_nn", True): (lambda: epochs[True](perm), m_steps,
                                 mcfg.batch_size)}
    got = {k: [] for k in runs}
    for what in ("unet", "mnist_nn"):
        for g in (False, True, True, False):
            fn, k, _ = runs[(what, g)]
            if device == "cuda":
                host, busy, summary, _ = _host_and_trace(fn, 1, warmup=1,
                                                         timed=2)
                busy = (busy / k, _span_share(summary))
            else:
                fn()
                t0 = time.perf_counter()
                fn()
                host, busy = (time.perf_counter() - t0) * 1e3, None
            got[(what, g)].append((host / k, busy))
    best = {k: min(v, key=lambda hb: hb[0]) for k, v in got.items()}
    lines = []
    for what, label in (("unet", f"64x64 bf16 train step, batch {b}"),
                        ("mnist_nn", f"mnist_nn train step, batch "
                                     f"{mcfg.batch_size}")):
        parts = []
        for g in (False, True):
            host, busy = best[(what, g)]
            _, _, bs = runs[(what, g)]
            parts.append(f"{'graph' if g else 'eager'} {host:.4f} ms host a "
                         f"step, {bs / host * 1e3:.1f} images/s" + (
                             f", device busy {busy[0]:.4f} ms a step "
                             f"({busy[1]} of a traced run's span)"
                             if busy else ""))
        lines.append(f"{label}, in turns (eager, graph, graph, eager; "
                     f"{runs[(what, False)][1]} steps a run; the lower of "
                     f"each): " + "; ".join(parts) + f"; "
                     f"{best[(what, False)][0] / best[(what, True)][0]:.2f}x "
                     f"fewer host ms a step")
    del steps, epochs, runs
    if device != "cuda":
        return lines

    def eager_run():
        q, opt = p, adam_init(p)
        for r in rows:
            q, opt, _ = cu.train_step(q, opt, cu._fit_images(data[r], cfg),
                                      gen, cfg)
        return q, opt

    def graph_run(unroll):
        s = cu.TrainSteps(p, adam_init(p), data, gen, cfg, unroll=unroll)
        s.run(rows)
        return s

    def measured(fn):
        """(peak, still allocated) above what was allocated before ``fn``,
        in MiB, and fn's result."""
        state.clear()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fn()
        torch.cuda.synchronize()
        return ((torch.cuda.max_memory_allocated() - base) / 2 ** 20,
                (torch.cuda.memory_allocated() - base) / 2 ** 20, out)

    mem = {"eager": measured(eager_run)[:2]}
    for unroll in (4, 1):
        peak, live, s = measured(lambda: graph_run(unroll))
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        s.run(rows)  # replays only
        torch.cuda.synchronize()
        again = (torch.cuda.max_memory_allocated() - before) / 2 ** 20
        mem[f"graph U={unroll}"] = (peak, live, again)
        del s
    lines.append(
        f"peak allocated above the inputs over {n} steps, and what stays "
        f"allocated after them (the eager steps' new parameters and moments;"
        f" TrainSteps' copies of them and its graph's live blocks): eager "
        f"{mem['eager'][0]:.1f} MiB peak, {mem['eager'][1]:.1f} kept; "
        + "; ".join(f"{k} {v[0]:.1f} MiB peak (warm-up, capture, replays), "
                    f"{v[1]:.1f} kept, {v[2]:.1f} more in {n} more steps of "
                    f"replays" for k, v in mem.items() if k != "eager"))
    return lines


def phase_graphs(tmp: str, smi_line: str = "", device: str = "cuda") -> None:
    """Phase 27 (run after 26, in phase 10's data directory ``tmp``): the
    XLA dispatch modes as replayed CUDA graphs, against the eager steps:
    sampling (``_p27_sample``, ``_p27_run_cli``), the U-Net's train steps
    (``_p27_train_cli``, ``_p27_train_steps``), mnist_nn's resident epoch
    (``_p27_mnist``), the counters against the profiler
    (``_p27_cross_check``) and the timings (``_p27_timings``)."""
    from big_linear_algebra_tpu_torch.models import cifar_unet as cu

    def say(tag: str, *lines: str) -> None:
        for line in lines:
            print(f"[27 {tag}] {line}" + (f" | {smi_line}" if smi_line
                                          else ""), flush=True)

    t0 = time.perf_counter()
    os.environ["BLA_DATA_DIR"] = tmp
    params = cu.load_params_csv(_p25_cfg(device))
    del os.environ["BLA_DATA_DIR"]
    say("sample", *_p27_sample(cu.tree_map(lambda a: a.to(device), params),
                               device))
    say("run", _p27_run_cli(tmp, device))
    say("train cli", _p27_train_cli(tmp, device))
    say("train", *_p27_train_steps(params, device))
    line, mnist = _p27_mnist(tmp, device)
    say("mnist_nn", line)
    if device == "cuda":
        say("counters", _p27_counters())
    say("timing", *_p27_timings(params, mnist, device))
    say("total", f"{time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Phase 28: the last one-dispatch loops as CUDA graphs: the legacy programs'
# SGD scan and hinge chunk on the card, and the DP and TP epochs captured
# over NCCL (one rank per card: tools/graph_check.py --ranks=4 --spawned;
# on one card, a one-rank NCCL world's all-reduce).
# ---------------------------------------------------------------------------

# the legacy CLIs phase 28 runs graphed and eagerly: (name, train args)
P28_LEGACY = (("my_first_model", ["train", "800", "0.1"]),
              ("mnist", ["train", str(LEGACY_MNIST_STEPS),
                         str(LEGACY_MNIST_LR), "0"]),
              ("mnist_hinge", ["train", str(HINGE_ITERATIONS),
                               str(HINGE_LR)]))
# the one-rank NCCL world: replays of the captured all-reduce step
P28_NCCL_REPLAYS = 3


def _p28_same(a, b) -> bool:
    """Two nests of lists, tuples and dicts of tensors bit for bit."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(_p28_same(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_p28_same(x, y) for x, y in zip(a, b)))
    return a.dtype == b.dtype and torch.equal(a, b)


def _p28_record(module_name: str, held: list):
    """A context that keeps what ``module_name``'s train loop computed: the
    parameters and costs each ``make_sgd_scan`` run returns (the Layer
    graph), or each ``Chunks.run``'s history and the chunks' weights
    (mnist_hinge), as CPU copies."""
    from big_linear_algebra_tpu_torch.models import mnist_hinge as hinge
    from big_linear_algebra_tpu_torch.nn import layer_graph as lg

    if module_name == "mnist_hinge":
        def spy(real):
            def make(*a, **kw):
                chunks = real(*a, **kw)
                run = chunks.run

                def recorded(n):
                    hist = run(n)
                    held.append((chunks.w.detach().cpu().clone(),
                                 hist.detach().cpu().clone()))
                    return hist
                chunks.run = recorded
                return chunks
            return make
        return _wrapped(hinge, "Chunks", spy)

    def spy(real):
        def make(*a, **kw):
            run = real(*a, **kw)

            def recorded(*args):
                params, costs = run(*args)
                held.append((_flat([(w.cpu(), b.cpu()) for w, b in params]),
                             costs.detach().cpu().clone()))
                return params, costs
            return recorded
        return make
    return _wrapped(lg, "make_sgd_scan", spy)


def _p28_legacy(tmp: str, device: str) -> list:
    """Each legacy program's ``init`` once, then its ``train`` twice from
    copies of those CSVs, graphed and inside ``graphs.eager()``: what the
    train loop computed (parameters and every cost; the hinge's weights
    and norm history after every chunk) and what it saved bit-equal, the
    printed lines equal (the hinge's convergence iteration with them)."""
    import importlib
    import shutil

    from big_linear_algebra_tpu_torch.data import synth
    from big_linear_algebra_tpu_torch.utils import graphs

    mnist_dir = os.path.join(tmp, "p28_mnist_data")
    with contextlib.redirect_stdout(io.StringIO()):
        synth.ensure_mnist(mnist_dir)
    lines = []
    for name, args in P28_LEGACY:
        module = importlib.import_module(
            f"big_linear_algebra_tpu_torch.models.{name}")
        base = os.path.join(tmp, f"p28_{name}")
        if name != "my_first_model":
            shutil.copytree(os.path.join(mnist_dir, "mnist"),
                            os.path.join(base, "mnist"))
        _cli(module, ["init"], base, device)
        got = {}
        for mode in ("graph", "eager"):
            where = f"{base}_{mode}"
            shutil.copytree(base, where)
            held = []
            save = "save_weights" if name == "mnist_hinge" else "save_params"
            with _p28_record(name, held), _saved(module, save) as saved, (
                    contextlib.nullcontext() if mode == "graph"
                    else graphs.eager()):
                text, secs = _cli(module, args, where, device)
            got[mode] = (text, held, saved, secs)
        (text, held, saved, secs), (etext, eheld, esaved, esecs) = (
            got["graph"], got["eager"])
        same = (text.splitlines() == etext.splitlines()
                and len(held) == len(eheld) > 0 and len(saved) == 1
                and len(esaved) == 1
                and _p28_same(held, eheld) and _p28_same(saved, esaved))
        if not same:
            fail(f"phase 28: {name} {' '.join(args)} graphed is not "
                 f"bit-equal to its eager run (loop results, saved "
                 f"parameters or printed lines):\n{text[-1500:]}\n---\n"
                 f"{etext[-1500:]}")
        conv = re.search(r"converged < epsilon after iteration (\d+)", text)
        what = (f"{len(held)} chunk(s), weights and norm history after each, "
                f"convergence "
                + (f"at {conv.group(1)}" if conv else "not reached")
                if name == "mnist_hinge" else
                f"parameters and all {held[0][1].numel()} costs")
        lines.append(f"{name} {' '.join(args)}: graphed bit-equal to "
                     f"graphs.eager() ({what}; saved parameters; "
                     f"{len(text.splitlines())} printed lines equal); CLI "
                     f"wall {secs:.2f} s graphed, {esecs:.2f} s eager")
    return lines


def _p28_timings(tmp: str, device: str) -> list:
    """The three loops timed in turns (eager, graph, replays, replays,
    graph, eager; two runs a turn after one warm-up run, the lower turn of
    each), then each traced once: the legacy mnist loop
    (LEGACY_MNIST_STEPS steps through ``make_sgd_scan``), my_first_model's
    (800 steps) and mnist_hinge's (HINGE_ITERATIONS iterations through
    ``Chunks``, the history read after each chunk, as ``train`` reads it):
    eager; graph, a whole call as ``train`` makes it (its warm-up and
    capture included); replays, the same steps replayed from a graph
    captured before. Host µs a step from two timed runs ending in a
    synchronise, and on the card the device busy a step and its share of a
    traced run's span; then what one ``gc.collect()`` (which every capture
    runs first) costs in this process."""
    from big_linear_algebra_tpu_torch.data.mnist import MnistDataset
    from big_linear_algebra_tpu_torch.models import mnist as legacy
    from big_linear_algebra_tpu_torch.models import mnist_hinge as hinge
    from big_linear_algebra_tpu_torch.models import my_first_model as mfm
    from big_linear_algebra_tpu_torch.nn import layer_graph as lg
    from big_linear_algebra_tpu_torch.utils import graphs

    train_csv = os.path.join(tmp, "p28_mnist_data", "mnist",
                             "mnist_train.csv")
    xs, ys = legacy.stream_examples(train_csv, LEGACY_MNIST_STEPS)
    gen = torch.Generator().manual_seed(28)

    def uniform(shapes):  # the reference's U(-0.5, 0.5) init
        return [(torch.rand(w, generator=gen) - 0.5,
                 torch.rand(b, generator=gen) - 0.5) for w, b in shapes]

    p_mnist, p_mfm = uniform(legacy.SHAPES), uniform(mfm.SHAPES)
    mxs, mys = mfm.synth_stream(800)
    data = MnistDataset.from_csv(train_csv)
    hx = torch.from_numpy(data.x / 255.0).to(device)
    hy = hinge.signed_targets(torch.from_numpy(data.y).to(device), hx.dtype)
    hw = (torch.rand(784, 10, generator=gen) * 0.1 - 0.05).to(device)
    cuda = device == "cuda"

    def scan(acts, params, x, y, lr):
        dev = [(w.to(device), b.to(device)) for w, b in params]
        x, y = torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)
        runs = {g: lg.make_sgd_scan(acts, graphed=g and cuda)
                for g in (False, True)}
        steps = lg._ScanSteps(dev, acts, x, y, lr)
        graph = graphs.StepGraph(2, torch.device(device), graphed=cuda)
        graph.run(x.shape[0], steps.step)  # warm-up and capture

        def replays():
            steps.counter.zero_()
            graph.run(x.shape[0], steps.step)
        return {"eager": lambda: runs[False](dev, x, y, lr),
                "graph": lambda: runs[True](dev, x, y, lr),
                "replays": replays}

    def chunk_runs():
        def call(g):
            c = hinge.Chunks(hw, hx, hy, HINGE_LR, hx.shape[0],
                             graphed=g and cuda)
            for _ in range(HINGE_ITERATIONS // hinge.CHUNK):
                c.run(hinge.CHUNK).cpu()
        held = hinge.Chunks(hw, hx, hy, HINGE_LR, hx.shape[0], graphed=cuda)
        held.run(hinge.CHUNK)  # warm-up and capture

        def replays():
            for _ in range(HINGE_ITERATIONS // hinge.CHUNK):
                held.run(hinge.CHUNK).cpu()
        return {"eager": lambda: call(False), "graph": lambda: call(True),
                "replays": replays}

    cases = {"legacy mnist step": (LEGACY_MNIST_STEPS, lambda: scan(
                 legacy.ACTS, p_mnist, xs, ys, LEGACY_MNIST_LR)),
             "my_first_model step": (800, lambda: scan(
                 mfm.ACTS, p_mfm, mxs, mys, 0.1)),
             "mnist_hinge iteration": (HINGE_ITERATIONS, chunk_runs)}
    lines = []
    for what, (steps, make) in cases.items():
        fns = make()
        got = {k: [] for k in fns}
        for k in fns:
            fns[k]()
        for k in ("eager", "graph", "replays", "replays", "graph", "eager"):
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(2):
                fns[k]()
            _sync(device)
            got[k].append((time.perf_counter() - t0) * 1e3 / (2 * steps))
        best = {k: min(v) for k, v in got.items()}
        traced = {k: (None, None) for k in fns}
        if cuda:
            for k in fns:
                _, busy, summary, _ = _host_and_trace(fns[k], 1, warmup=0,
                                                      timed=1)
                traced[k] = (busy / steps, _span_share(summary))
        parts = []
        for k, label in (("eager", "eager"),
                         ("graph", "graph (a call, capture included)"),
                         ("replays", "replays")):
            host, (busy, share) = best[k], traced[k]
            parts.append(f"{label} {host * 1e3:.2f} us host a step" + (
                f", device busy {busy * 1e3:.2f} us a step ({share} of a "
                f"traced run's span)" if busy is not None else ""))
        lines.append(f"{what}, {steps} a run, in turns (eager, graph, "
                     f"replays, replays, graph, eager; the lower of each): "
                     + "; ".join(parts) + f"; eager over replays "
                     f"{best['eager'] / best['replays']:.2f}x, over a "
                     f"graphed call {best['eager'] / best['graph']:.2f}x "
                     f"host us a step")
        del fns
    t0 = time.perf_counter()
    gc.collect()
    lines.append(f"one gc.collect() in this process (a capture runs one "
                 f"first): {(time.perf_counter() - t0) * 1e3:.1f} ms")
    return lines


def _p28_nccl_world(device: str) -> str:
    """A one-rank NCCL world on the card (the part of a graphed DP or TP
    step one card can hold): ``spmd._psum_leaves`` of an f32 and an f64
    leaf over the world group, after an eager step that makes the
    communicator, captured in a ``StepGraph`` and replayed
    P28_NCCL_REPLAYS times; each replay's sums right (one rank: the leaves
    themselves, which the step advances first), the collective counters
    advanced by the capture's calls and bytes at every replay."""
    import torch.distributed as dist

    from big_linear_algebra_tpu_torch.parallel import mesh as pmesh
    from big_linear_algebra_tpu_torch.parallel import spmd
    from big_linear_algebra_tpu_torch.utils import graphs

    if device != "cuda":
        return "no NCCL world on the CPU"
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{pmesh._free_port()}", world_size=1, rank=0)
    try:
        leaves = [torch.arange(1000, dtype=torch.float32, device="cuda"),
                  torch.full((37,), 0.5, dtype=torch.float64, device="cuda")]
        start = [leaf.clone() for leaf in leaves]
        sums = [torch.zeros_like(leaf) for leaf in leaves]

        def step():
            for leaf in leaves:
                leaf.add_(1)
            for out, s in zip(sums, spmd._psum_leaves(leaves,
                                                      dist.group.WORLD)):
                out.copy_(s)

        graph = graphs.StepGraph(1, torch.device("cuda"))
        if not graph.graphed:
            fail(f"phase 28: no graph in a one-rank NCCL world "
                 f"({graphs.eager_reason(torch.device('cuda'))})")
        c0 = (spmd.collective_calls, spmd.collective_bytes["all_reduce"])
        graph.run(1, step)  # the eager warm-up, then the capture
        torch.cuda.synchronize()
        c1 = (spmd.collective_calls, spmd.collective_bytes["all_reduce"])
        per = (c1[0] - c0[0], c1[1] - c0[1])
        for k in range(P28_NCCL_REPLAYS):
            before = (spmd.collective_calls,
                      spmd.collective_bytes["all_reduce"])
            graph.replay()
            torch.cuda.synchronize()
            after = (spmd.collective_calls,
                     spmd.collective_bytes["all_reduce"])
            want = [s + (k + 2) for s in start]
            if not all(torch.equal(o, w) and torch.equal(leaf, w)
                       for o, leaf, w in zip(sums, leaves, want)):
                fail(f"phase 28: replay {k + 1} of the captured NCCL "
                     f"all-reduce summed wrong")
            if (after[0] - before[0], after[1] - before[1]) != per:
                fail(f"phase 28: replay {k + 1} advanced the collective "
                     f"counters by {(after[0] - before[0], after[1] - before[1])}"
                     f", the eager step by {per}")
        replays = graph.replays
        del graph
        gc.collect()
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    return (f"a one-rank NCCL world: spmd._psum_leaves over the world group "
            f"(f32 and f64 leaves: {per[0]} all-reduces, {per[1]} bytes a "
            f"step) captured in a StepGraph after its eager warm-up and "
            f"replayed {replays} times: the sums right at every replay, the "
            f"collective counters advanced by {per[0]} calls and {per[1]} "
            f"bytes a replay, as by the eager step")


def phase_graphs_legacy(smi_line: str = "", device: str = "cuda") -> None:
    """Phase 28 on one card (``tools/graph_check.py --phase=28`` runs it
    alone): the legacy programs' loops graphed against ``graphs.eager()``
    (``_p28_legacy``), their timings (``_p28_timings``) and a one-rank NCCL
    world's captured all-reduce (``_p28_nccl_world``). The DP and TP
    epochs over NCCL need a card a rank: ``phase_graphs_parallel``."""
    def say(tag: str, *lines: str) -> None:
        for line in lines:
            print(f"[28 {tag}] {line}" + (f" | {smi_line}" if smi_line
                                          else ""), flush=True)

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="bla_smoke_") as tmp:
        say("legacy", *_p28_legacy(tmp, device))
        say("timing", *_p28_timings(tmp, device))
        os.environ.pop("BLA_DATA_DIR", None)
    say("nccl", _p28_nccl_world(device))
    say("total", f"{time.perf_counter() - t0:.1f} s")


# The DP and TP epochs over NCCL (``phase_graphs_parallel``, one rank a
# card): P28_STEPS steps a U-Net case (one warm-up step, then two replays
# of 4), P28_TP_SCAN_STEPS under --scan-steps=2 (chunks of 2, a ragged
# tail of 1), P28_TIMED steps a timed run; the CLI pairs' synthesized set,
# P28_CLI_EXAMPLES examples at --batch=P28_CLI_BATCH (TINY at 64x64).
P28_STEPS, P28_TP_SCAN_STEPS, P28_TIMED = 9, 5, 8
P28_CLI_EXAMPLES, P28_CLI_BATCH = 80, 8
P28_TIMEOUT_S = 900


def _p28_collectives():
    from big_linear_algebra_tpu_torch.parallel import spmd

    return spmd.collective_calls, dict(spmd.collective_bytes)


def _p28_counted(fn):
    """(fn's result, kernel launches, (collective calls, bytes by kind))
    during fn, by the counters."""
    c0, b0 = _p28_collectives()
    out, launches = _p27_counts(fn)
    c1, b1 = _p28_collectives()
    return out, launches, (c1 - c0, {k: v - b0[k] for k, v in b1.items()
                                     if v != b0[k]})


def _p28_timed(fns: dict, steps: int, device: str):
    """{graphed: (host ms a step, busy ms a step, busy share)} of the two
    runs in ``fns`` ({False: eager, True: replays of a graph captured
    before}), in turns (eager, graph, graph, eager), the lower of each;
    None on the CPU (its rehearsal times nothing)."""
    if device != "cuda":
        return None
    got = {False: [], True: []}
    for g in (False, True, True, False):
        host, busy, summary, _ = _host_and_trace(fns[g], 1, warmup=1,
                                                 timed=2)
        got[g].append((host / steps, busy / steps, _span_share(summary)))
    return {g: min(v, key=lambda r: r[0]) for g, v in got.items()}


def _p28_mnist_dp(device: str) -> dict:
    """mnist_nn's resident DP epoch (128 steps of batch 64 on an 8192-image
    set, graphs of 4) against the same epoch with ``graphed=False``, from
    the same parameters: every leaf, correct and ce_sum bit-equal, the
    launches and collectives equal; then both timed."""
    import numpy as np

    from big_linear_algebra_tpu_torch.models import mnist_nn
    from big_linear_algebra_tpu_torch.parallel import default_mesh

    mesh = default_mesh()
    cfg = mnist_nn.CONFIG
    g = torch.Generator().manual_seed(0)
    x = torch.randint(0, 256, (8192, 784), generator=g).float().to(
        mesh.device)
    y = torch.randint(0, 10, (8192,), generator=g).to(torch.uint8).to(
        mesh.device)
    perm = torch.from_numpy(mnist_nn.epoch_permutation(
        np.random.default_rng(cfg.seed), 8192, cfg.batch_size)).to(
        mesh.device)
    p0 = mnist_nn.init_params(torch.Generator().manual_seed(cfg.seed), cfg)
    out, epochs = {}, {}
    for graphed in (False, True):
        model = mnist_nn.MnistNN.from_params(p0, cfg, device=mesh.device)
        epochs[graphed] = mnist_nn.ResidentEpoch(
            model, x, y, cfg, graphed=None if graphed else False, mesh=mesh)
        (c, ce), launches, colls = _p28_counted(lambda: epochs[graphed](perm))
        out[graphed] = (model, c, ce, launches, colls)
    a, b = out[True], out[False]
    same = (_p27_same(a[0].params(), b[0].params())
            and torch.equal(a[1], b[1]) and torch.equal(a[2], b[2]))
    steps = perm.shape[0] // cfg.batch_size
    replays = epochs[True].graph.replays
    digest = _params_hash(a[0].params())

    timed = _p28_timed({True: lambda: epochs[True](perm),
                        False: lambda: epochs[False](perm)}, steps, device)
    return {"same": same, "counts": (a[3], a[4]), "eager counts": (b[3], b[4]),
            "hash": digest, "steps": steps, "replays": replays,
            "timed": timed, "correct": float(a[1])}


def _p28_hinge_dp(device: str) -> dict:
    """mnist_hinge ``--dp``'s ``Chunks`` (HINGE_ITERATIONS iterations at
    HINGE_LR on 8192 examples, a chunk a graph) against
    ``make_train_chunk_dp``'s eager chunks from the same weights: the
    weights and every norm bit-equal, the collectives equal; then timed."""
    from big_linear_algebra_tpu_torch.models import mnist_hinge as hinge
    from big_linear_algebra_tpu_torch.parallel import (batch_sharding,
                                                       default_mesh)

    mesh = default_mesh()
    g = torch.Generator().manual_seed(1)
    x = (torch.randint(0, 256, (8192, 784), generator=g).float() / 255.0)
    labels = torch.randint(0, 10, (8192,), generator=g)
    w0 = (torch.rand(784, 10, generator=g) * 0.1 - 0.05).to(mesh.device)
    shard = batch_sharding(mesh)
    xl = shard(x).to(mesh.device)
    yl = hinge.signed_targets(shard(labels).to(mesh.device), xl.dtype)
    n_chunks = HINGE_ITERATIONS // hinge.CHUNK

    def eager():
        w, hist = w0, []
        chunk = hinge.make_train_chunk_dp(mesh, 8192)
        for _ in range(n_chunks):
            w, h = chunk(w, xl, yl, HINGE_LR)
            hist.append(h)
        return w, torch.cat(hist)

    held = {}

    def graphed():
        chunks = hinge.Chunks(w0, xl, yl, HINGE_LR, 8192, mesh)
        held["chunks"] = chunks
        return chunks.w, torch.cat([chunks.run(hinge.CHUNK).clone()
                                    for _ in range(n_chunks)])

    want, _, want_c = _p28_counted(eager)
    got, _, got_c = _p28_counted(graphed)
    same = _p28_same(got, want)
    chunks, replays = held["chunks"], held["chunks"].graph.replays

    def replayed():
        for _ in range(n_chunks):
            chunks.run(hinge.CHUNK).cpu()

    timed = _p28_timed({False: eager, True: replayed}, HINGE_ITERATIONS,
                       device)
    return {"same": same, "counts": got_c, "eager counts": want_c,
            "hash": _params_hash(got[0]), "replays": replays,
            "timed": timed}


def _p28_unet(device: str, kind: str, fused: bool = False,
              unroll=None, n: int = P28_STEPS) -> dict:
    """``n`` U-Net train steps (64x64 bf16 at batch 16, or 32x32
    ``--fused-block``; TINY at batch 8 on the CPU) through ``TrainSteps``
    against the eager steps on the same rows and generator seeds: ``kind``
    "dp" (the mesh: this rank's 16/ranks rows, ``DPGenerators``, against
    ``make_train_step_dp``) or "tp" (a model axis of every rank: this
    rank's slices, against ``make_train_step_tp``); ``unroll`` steps a
    graph (default ``scan_unroll``). Every parameter, both moments, the
    losses and the generators' states bit-equal, the launches and
    collectives equal; the replicas' hash; then both timed over
    P28_TIMED steps."""
    import dataclasses

    import numpy as np

    from big_linear_algebra_tpu_torch.models import cifar_unet as cu
    from big_linear_algebra_tpu_torch.nn.optim import adam_init
    from big_linear_algebra_tpu_torch.parallel import (batch_sharding,
                                                       default_mesh,
                                                       make_mesh)
    from big_linear_algebra_tpu_torch.parallel import mesh as pmesh

    base = (dataclasses.replace(cu.TINY, batch_size=8, image_size=64)
            if device == "cpu" else dataclasses.replace(cu.CONFIG,
                                                        image_size=64))
    cfg = (dataclasses.replace(base, fused_block=True, image_size=32)
           if fused else base)
    b = cfg.batch_size
    mesh = (default_mesh() if kind == "dp"
            else make_mesh({"model": pmesh.world_size()}))
    dev = mesh.device
    data = torch.from_numpy(np.random.default_rng(28).uniform(
        -1, 1, (b * n, 3, 32, 32)).astype(np.float32)).to(dev)
    rows = torch.from_numpy(np.random.default_rng(29).permutation(
        b * n)).to(dev).reshape(n, b)
    full = cu.cast_params(cu.init_params(torch.Generator().manual_seed(0),
                                         cfg), cfg)
    full = cu.tree_map(lambda a: a.to(dev), full)
    if kind == "dp":
        lo, hi = batch_sharding(mesh).bounds(b)
        rows = rows[:, lo:hi]
        layout = None

        def gens():
            return cu.DPGenerators(7, mesh.index("data"), dev)

        def start():
            return full, adam_init(full)

        step = cu.make_train_step_dp(mesh, cfg)
    else:
        layout = cu.TPLayout(mesh, cu.tp_param_specs(full,
                                                     mesh.size("model")))

        def gens():
            return torch.Generator(device=dev).manual_seed(7)

        def start():
            return cu.place_tp(mesh, full, adam_init(full))

        step = cu.make_train_step_tp(mesh, layout.specs, cfg)

    def states(g):
        return ([g.replicated.get_state(), g.rank.get_state()]
                if kind == "dp" else [g.get_state()])

    def eager():
        g = gens()
        p, opt = start()
        losses = []
        for r in rows:
            p, opt, loss = step(p, opt, cu._fit_images(data[r], cfg), g)
            losses.append(loss)
        return p, opt, torch.stack(losses), states(g)

    held = {}

    def graphed():
        g = gens()
        p, opt = start()
        steps = cu.TrainSteps(p, opt, data, g, cfg, unroll=unroll,
                              mesh=mesh if kind == "dp" else None, tp=layout)
        held["steps"] = steps
        if unroll is None:
            losses = steps.run(rows)
        else:
            whole = n // unroll * unroll
            losses = torch.cat([steps.run(rows[:whole]),
                                steps.run(rows[whole:])])
        return steps.params, steps.opt_state(), losses, states(g)

    (q, opt, losses, st), want, want_c = _p28_counted(eager)
    got, counts, got_c = _p28_counted(graphed)
    adam = n * _adam_a_step(full, device)
    counts = _adam_apart(counts, adam, f"phase 28 {kind} (fused {fused})")
    same = (_p27_same(got[0], q) and _p27_same(got[1].m, opt.m)
            and _p27_same(got[1].v, opt.v) and got[1].step == opt.step
            and torch.equal(got[2], losses) and _p28_same(got[3], st))
    params = got[0] if layout is None else cu.gather_tp(layout, got[0])
    digest = _params_hash(params)
    replays = held["steps"].graph.replays
    del q, opt, got, params, held
    timed = None
    if unroll is None and device == "cuda":
        r8 = rows[:P28_TIMED]
        g = gens()
        p, o = start()
        state = {"p": p, "opt": o}

        def eager_run():
            for r in r8:
                state["p"], state["opt"], _ = step(
                    state["p"], state["opt"], cu._fit_images(data[r], cfg), g)

        p, o = start()
        steps = cu.TrainSteps(p, o, data, gens(), cfg,
                              mesh=mesh if kind == "dp" else None, tp=layout)
        steps.run(r8)  # warm-up and capture
        timed = _p28_timed({False: eager_run, True: lambda: steps.run(r8)},
                           P28_TIMED, device)
        del steps, state
    return {"same": same, "counts": (counts, got_c),
            "eager counts": (want, want_c), "hash": digest,
            "replays": replays, "timed": timed, "steps": n, "adam": adam,
            "losses": (float(losses[0]), float(losses[-1]))}


def _p28_cli_states(tmp: str, device: str) -> dict:
    """cifar_unet ``train 1 --dp --tiny --image-size=64 --batch=8`` (the
    graphed device epoch) against ``--host-loop`` (eager steps), and
    ``train 1 --tp ... --scan-steps=2 --max-steps=5`` (chunks of 2 and a
    tail) against ``--max-steps=5`` alone (eager), each pair from fresh
    data directories: this rank's stdout (rank 0's holds the metrics) and
    the train states rank 0 saved (read after the launch's barrier)."""
    from big_linear_algebra_tpu_torch.ckpt import pytree
    from big_linear_algebra_tpu_torch.models import cifar_unet as cu

    common_args = ["train", "1", "--tiny", "--image-size=64",
                   f"--batch={P28_CLI_BATCH}"]
    runs = {"dp graph": ["--dp"], "dp host-loop": ["--dp", "--host-loop"],
            "tp scan": ["--tp", "--scan-steps=2", "--max-steps=5"],
            "tp eager": ["--tp", "--max-steps=5"]}
    out = {}
    for name, extra in runs.items():
        where = os.path.join(tmp, "p28_cli_" + name.replace(" ", "_"))
        (text, secs), launches = _p27_counts(
            lambda: _cli(cu, common_args + extra, where, device))
        state = pytree.restore_pytree(cu.state_dir(), pytree.latest_step(
            cu.state_dir()))
        del os.environ["BLA_DATA_DIR"]
        out[name] = {"text": text, "seconds": secs, "launches": launches,
                     "state": state}
    return out


def _phase28_rank(tmp: str, device: str) -> int:
    """One rank of phase 28's parallel part (``chip_smoke.py --phase28-rank
    TMP DEVICE`` under ``torch.distributed.run``, one rank a card): the
    graphed epochs against the eager ones (``_p28_mnist_dp``,
    ``_p28_hinge_dp``, ``_p28_unet``, ``_p28_cli_states``); writes
    ``TMP/rank<r>.pt`` for the launching process."""
    from big_linear_algebra_tpu_torch.parallel import mesh as pmesh

    rank = pmesh.distributed_init(device=device)
    dev = pmesh.current_device()
    out = {"rank": rank, "device": str(dev), "backend": pmesh.backend(),
           "world": pmesh.world_size()}
    out["mnist_nn --dp"] = _p28_mnist_dp(device)
    out["mnist_hinge --dp"] = _p28_hinge_dp(device)
    out["cifar_unet --dp"] = _p28_unet(device, "dp")
    out["cifar_unet --dp --fused-block"] = _p28_unet(device, "dp",
                                                     fused=True)
    out["cifar_unet --tp"] = _p28_unet(device, "tp")
    out["cifar_unet --tp --scan-steps=2"] = _p28_unet(
        device, "tp", unroll=2, n=P28_TP_SCAN_STEPS)
    out["cli"] = _p28_cli_states(tmp, device)
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    return 0


def phase_graphs_parallel(smi_line: str = "", device: str = "cuda",
                          n_ranks: int = 4) -> None:
    """Phase 28's parallel part, ``n_ranks`` ranks under
    ``torch.distributed.run``, one card each over NCCL
    (``tools/graph_check.py --ranks=4 --spawned``; on the CPU a gloo
    rehearsal in which both sides run eagerly): on every rank each graphed
    epoch bit-equal to its eager one with the launches and collectives
    equal, the replicas bit-equal across the ranks, the CLIs' train states
    bit-equal between their graphed and eager runs; each case's host time
    and busy share a step, graphed against eager."""
    from big_linear_algebra_tpu_torch.data import synth
    from big_linear_algebra_tpu_torch.utils import graphs

    def say(tag: str, *lines: str) -> None:
        for line in lines:
            print(f"[28 {tag}] {line}" + (f" | {smi_line}" if smi_line
                                          else ""), flush=True)

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="bla_smoke_") as tmp:
        for name in ("dp_graph", "dp_host-loop", "tp_scan", "tp_eager"):
            with contextlib.redirect_stdout(io.StringIO()):
                synth.ensure_cifar(os.path.join(tmp, f"p28_cli_{name}"),
                                   per_batch=P28_CLI_EXAMPLES // 5)
        _, seconds = _run_ranks(tmp, device, n_ranks,
                                ["--phase28-rank", tmp, device], "phase 28")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=False) for r in range(n_ranks)]
    r0 = ranks[0]
    if device == "cuda" and r0["backend"] != "nccl":
        fail(f"phase 28 parallel: backend {r0['backend']}: a graphed "
             f"parallel epoch needs NCCL, one card a rank")
    say("launch", f"{n_ranks} ranks ("
        + ", ".join(f"rank {r['rank']} on {r['device']}" for r in ranks)
        + f"), backend {r0['backend']}; {seconds:.1f} s of wall")
    for case in [k for k in r0 if k.startswith(("mnist", "cifar"))]:
        res = [r[case] for r in ranks]
        for r, x in zip(ranks, res):
            if not x["same"]:
                fail(f"phase 28 {case}: rank {r['rank']}'s graphed epoch is "
                     f"not bit-equal to its eager one")
            if x["counts"] != x["eager counts"]:
                fail(f"phase 28 {case}: rank {r['rank']} launched "
                     f"{x['counts']} graphed, {x['eager counts']} eager")
            if device == "cuda" and x["replays"] == 0:
                fail(f"phase 28 {case}: no replay ran")
        if len({x["hash"] for x in res}) != 1:
            fail(f"phase 28 {case}: the replicas differ across the ranks")
        x = res[0]
        launches, (calls, nbytes) = (x["counts"] if isinstance(
            x["counts"][0], dict) else ({}, x["counts"]))
        steps = x.get("steps", HINGE_ITERATIONS)
        line = (f"{case}: {steps} steps, {x['replays']} replays; every rank "
                f"bit-equal to its eager epoch, the replicas bit-equal "
                f"across the ranks; per rank launches "
                f"{ {k: v / steps for k, v in launches.items()} } a step, "
                f"{calls / steps:g} collectives and "
                f"{ {k: v / steps for k, v in nbytes.items()} } bytes a "
                f"step, graphed as eager" + (
                    f", and graphed the in-place Adam {x['adam'] / steps:g} "
                    f"a step" if "adam" in x else ""))
        if x["timed"] is not None:
            parts = []
            for g in (False, True):
                host, busy, share = x["timed"][g]
                parts.append(f"{'graph' if g else 'eager'} {host:.4f} ms "
                             f"host a step" + (
                                 f", device busy {busy:.4f} ms a step "
                                 f"({share} of a traced run's span)"
                                 if busy is not None else ""))
            line += ("; rank 0 in turns (eager, graph, graph, eager; the "
                     "lower of each): " + "; ".join(parts) + f"; "
                     f"{x['timed'][False][0] / x['timed'][True][0]:.2f}x "
                     f"fewer host ms a step")
        say("parallel", line)
    cli = [r["cli"] for r in ranks]
    for a, b, what in (("dp graph", "dp host-loop", "--dp: the graphed "
                        "device epoch against --host-loop"),
                       ("tp scan", "tp eager", "--tp --scan-steps=2 "
                        "--max-steps=5 against --max-steps=5")):
        sa, sb = cli[0][a]["state"], cli[0][b]["state"]
        same = (_p27_same(sa["params"], sb["params"])
                and _p27_same(sa["opt"]["m"], sb["opt"]["m"])
                and _p27_same(sa["opt"]["v"], sb["opt"]["v"])
                and sa["opt"]["step"] == sb["opt"]["step"]
                and torch.equal(sa["rng"], sb["rng"])
                and sa["chain"] == sb["chain"])
        la, lb = (_epoch_line(cli[0][k]["text"], 0) for k in (a, b))
        if not same or la["avg_loss"] != lb["avg_loss"]:
            fail(f"phase 28 CLI {what}: the train states (or avg_loss) "
                 f"differ:\n{cli[0][a]['text']}\n---\n{cli[0][b]['text']}")
        adam = int(sa["opt"]["step"]) * _adam_a_step(sa["params"], device)
        if any(_adam_apart(r[a]["launches"], adam, f"phase 28 CLI {what}")
               != _adam_apart(r[b]["launches"], 0, f"phase 28 CLI {what}")
               for r in cli):
            fail(f"phase 28 CLI {what}: launches "
                 f"{[r[a]['launches'] for r in cli]} against "
                 f"{[r[b]['launches'] for r in cli]}")
        if any("later work" in r[k]["text"] or graphs.GLOO in r[k]["text"]
               for r in cli for k in (a, b)) and device == "cuda":
            fail(f"phase 28 CLI {what}: a rank printed an eager rule")
        say("cli", f"cifar_unet train 1 --tiny --image-size=64 "
                   f"--batch={P28_CLI_BATCH} on {P28_CLI_EXAMPLES} examples, "
                   f"{what}: train states bit-equal (parameters, moments, "
                   f"step {int(sa['opt']['step'])}, the generator's state, "
                   f"chain {sa['chain']}), avg_loss {la['avg_loss']} both, "
                   f"launches {cli[0][b]['launches']} on rank 0 either "
                   f"way, and graphed the in-place Adam {adam}; "
                   f"CLI wall {cli[0][a]['seconds']:.2f} s and "
                   f"{cli[0][b]['seconds']:.2f} s")
    say("total", f"{time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Phase 29: Adam in place, one hand-written multi-tensor pass
# (``csrc/adam.cu``, ``nn/optim.py`` ``adam_update_at_``), which a
# ``TrainSteps`` step takes for f32 parameters on the card.
# ---------------------------------------------------------------------------

# The TPU has no kernel of its own here: XLA fuses the JAX package's Adam, a
# tree_map of elementwise ops, into a few loops
ADAM_TPU_KERNEL = "big_linear_algebra_tpu/nn/optim.py:88 (adam_update)"
ADAM_BYTES_PER_PARAM = 28  # read p, g, m, v; write p, m, v (f32)
ADAM_STEPS = 3  # steps held bit-equal at the U-Net's leaves
# calls a timed graph holds: a call of the pass or of the library spends
# more host time than device time, and the plain update ~2,000 launches
ADAM_GRAPH_CALLS = {"pass": 20, "plain": 2, "library": 20}
# the train run whose launches phase 29 reads: every step a TrainSteps step
ADAM_TRAIN_ARGS = ["train", "1", "--fused-block", "--scan-steps=5",
                   f"--max-steps={FUSED_TRAIN_STEPS}"]


def _graph(fn, calls: int):
    """A CUDA graph of ``calls`` calls of ``fn``, after one call on a side
    stream."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return graph


def phase_adam(tmp: str, smi_line: str) -> dict:
    """Phase 29 (after 15, in its data directory ``tmp``): the in-place
    Adam pass at the full-width U-Net's 122 leaves (25,784,704 f32
    parameters). Its kernel's registers, shared memory and spills (failing
    on a spill); ADAM_STEPS steps from random moments, every parameter and
    both moments bit-equal to ``adam_update_at`` after each, its launches
    per call as ``bla_adam_leaves_per_launch`` groups the leaves; its device
    time beside the plain update (``adam_update_at`` and the copy-back into
    the buffers, the graphed step's Adam before the pass) and
    ``torch._fused_adam_`` (the library yardstick, timed only here), each
    over replays of a CUDA graph (ADAM_GRAPH_CALLS) in turns (pass, plain,
    library, library, plain, pass; the lower of each), against 28 bytes a
    parameter over the card's bandwidth; then ``train 1 --fused-block
    --scan-steps=5 --max-steps=30`` from phase 15's train state with
    ``adam_launch_count`` set to 0 just before: the pass's launches equal
    the steps times its launches a step, the average loss finite."""
    import dataclasses

    from big_linear_algebra_tpu_torch.models import cifar_unet as cu
    from big_linear_algebra_tpu_torch.nn import optim

    def say(tag: str, line: str) -> None:
        print(f"[29 {tag}] {line} | {smi_line}", flush=True)

    st = _kernel_stats("adam", re.compile(r"(bla_adam_kernel)")).get(
        ("bla_adam_kernel",), {})
    if not {"regs", "smem", "spill"} <= set(st) or st["spill"]:
        fail(f"phase 29: the pass's build record {st}")
    say("adam build", f"bla_adam_kernel: {st['regs']} registers, "
        f"{st['smem']} bytes of shared memory, no spill")

    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(cu.CONFIG, fused_block=True)
    params = cu.tree_map(lambda a: a.to(dev), cu.init_params(
        torch.Generator().manual_seed(0), cfg))
    leaves = optim.tree_leaves(params)
    n = sum(x.numel() for x in leaves)
    gen = torch.Generator(dev).manual_seed(29)

    def drawn(scale, draw=torch.randn):
        return cu.tree_map(lambda a: draw(a.shape, device=dev,
                                          generator=gen) * scale, params)

    m, v = drawn(1e-3), drawn(1e-6, torch.rand)
    counter = torch.zeros((), dtype=torch.int64, device=dev)
    table = optim.bias_corrections(1, ADAM_STEPS).to(dev)
    lr = cfg.learn_rate
    p0, m0, v0 = (cu.tree_map(torch.clone, t) for t in (params, m, v))
    plain, state = params, optim.AdamState(0, m, v)
    before, errs, same = optim.adam_launch_count, [], True
    for _ in range(ADAM_STEPS):
        g = drawn(1e-3)
        plain, state = optim.adam_update_at(plain, g, state, counter,
                                            table, lr)
        optim.adam_update_at_(p0, g, m0, v0, counter, table, lr)
        counter.add_(1)
        for got, want in ((p0, plain), (m0, state.m), (v0, state.v)):
            for a, b in zip(optim.tree_leaves(got), optim.tree_leaves(want)):
                same = same and torch.equal(a, b)
                errs.append((a - b).abs().max())
    err = torch.stack(errs).max().item()
    a_call = _adam_a_step(params, "cuda")
    launches = optim.adam_launch_count - before
    if not same or launches != ADAM_STEPS * a_call:
        fail(f"phase 29: the pass against adam_update_at: bit-equal {same} "
             f"(max |diff| {err}), {launches} launches in {ADAM_STEPS} "
             f"calls, expected {ADAM_STEPS * a_call}")
    say("adam", f"{len(leaves)} leaves, {n} f32 parameters, {ADAM_STEPS} "
        f"steps from random moments: every parameter and moment bit-equal "
        f"to adam_update_at after each; {a_call} launches a call")

    del p0, m0, v0, plain, state
    g = drawn(1e-3)
    counter.zero_()
    p1, m1, v1 = (cu.tree_map(torch.clone, t) for t in (params, m, v))
    p2, m2, v2 = (cu.tree_map(torch.clone, t) for t in (params, m, v))
    lib = [optim.tree_leaves(cu.tree_map(torch.clone, t))
           for t in (params, m, v)]
    steps = [torch.ones((), device=dev) for _ in leaves]

    def in_place():
        optim.adam_update_at_(p1, g, m1, v1, counter, table, lr)

    def plain_update():
        new, opt = optim.adam_update_at(p2, g, optim.AdamState(0, m2, v2),
                                        counter, table, lr)
        for buffers, values in ((p2, new), (m2, opt.m), (v2, opt.v)):
            for a, b in zip(optim.tree_leaves(buffers),
                            optim.tree_leaves(values)):
                a.copy_(b)

    def library():
        torch._fused_adam_(lib[0], leaves_g, lib[1], lib[2], [], steps,
                           lr=lr, beta1=0.9, beta2=0.999, weight_decay=0.0,
                           eps=1e-8, amsgrad=False, maximize=False)

    leaves_g = optim.tree_leaves(g)
    fns = {"pass": in_place, "plain": plain_update, "library": library}
    graphs = {k: _graph(fn, ADAM_GRAPH_CALLS[k]) for k, fn in fns.items()}
    times = {k: [] for k in fns}
    for k in ("pass", "plain", "library", "library", "plain", "pass"):
        dev_ms, _ = _time_ms(graphs[k].replay, iters=20, warmup=5)
        times[k].append(dev_ms / ADAM_GRAPH_CALLS[k])
    del graphs, p1, m1, v1, p2, m2, v2, lib
    ms = {k: min(t) for k, t in times.items()}
    bound = n * ADAM_BYTES_PER_PARAM / HBM_BYTES_PER_S * 1e3
    say("adam time", "device ms a call over graph replays, in turns: "
        + "; ".join(f"{k} {', '.join(f'{x:.4f}' for x in t)}"
                    for k, t in times.items())
        + f"; bound {bound:.4f} ms ({n} x {ADAM_BYTES_PER_PARAM} B over "
        f"3.35 TB/s): the pass at {100 * bound / ms['pass']:.1f}% of it, "
        f"{ms['plain'] / ms['pass']:.1f}x below the plain update, "
        f"{ms['library'] / ms['pass']:.2f}x the library's time")

    optim.adam_launch_count = 0
    text, secs = _cli(cu, ADAM_TRAIN_ARGS, tmp, "cuda")
    train_launches = optim.adam_launch_count
    want = FUSED_TRAIN_STEPS * a_call
    losses = [float(x) for x in re.findall(r"avg_loss: (\S+)", text)]
    if train_launches != want or not losses or not all(
            math.isfinite(x) for x in losses):
        fail(f"phase 29: {' '.join(ADAM_TRAIN_ARGS)} launched the pass "
             f"{train_launches} times, expected {want}; avg_loss {losses}:"
             f"\n{text}")
    say("adam train", f"{' '.join(ADAM_TRAIN_ARGS)} in {tmp} (phase 15's "
        f"train state in the full script; {secs:.2f} s): the pass launched "
        f"{train_launches} times in {FUSED_TRAIN_STEPS} steps, avg_loss "
        f"{losses[-1]}")
    return {"launches": train_launches, "err": err, "ms": ms["pass"],
            "plain_ms": ms["plain"], "library_ms": ms["library"],
            "bound_ms": bound}


def main() -> int:
    smi_line, exp2_per_s = phase_environment()
    phase_build()
    f32_err = phase_kernel_vs_plain()
    phase_tf32_control()
    phase_k1_bitequal()
    phase_k1_build_info()
    k1 = phase_timing()
    phase_train_gemm_timing()
    k1_launches = phase_main_path()
    k1_train, p22 = phase_mnist_train()
    k1_launches += k1_train
    phase_legacy_programs(p22)
    del p22
    phase_parallel(smi_line)
    phase_tp_pp(smi_line)
    k2_err = phase_k2_vs_plain()
    phase_k2_bitequal()
    phase_k2_build_info()
    k2 = phase_k2_timing(exp2_per_s)
    with tempfile.TemporaryDirectory(prefix="bla_smoke_") as tmp:
        os.environ["BLA_DATA_DIR"] = tmp
        k2_launches = phase_unet_main_path(tmp)
        phase_unet_oracle()
        k4_err = phase_k4_vs_plain()
        phase_k4_build_info()
        k4 = phase_k4_timing()
        k4_launches = phase_k4_unet_sites()
        k5_err = phase_k5_vs_plain()
        k5_err["K5a tc"] = phase_k5a_tc_vs_plain()
        phase_k5a_tc_build_info()
        k5_err.update(phase_k5b_tc_vs_plain())
        phase_k5b_tc_build_info()
        k5 = phase_k5_timing()
        k5b = phase_k5b_timing()
        k5a_launches = phase_unet_fused_run(tmp)
        k5a_fma_launches, k5b_fma = phase_fused_oracle()
        fused_train = phase_unet_fused_train()
        from big_linear_algebra_tpu_torch.models import cifar_unet as cu
        phase_fused_step_profile(cu.load_params_csv(cu.CONFIG))
        adam = phase_adam(tmp, smi_line)
        del os.environ["BLA_DATA_DIR"]
    bwd_err = phase_k2bwd_vs_plain()
    phase_k2bwd_build_info()
    phase_k2bwd_bitequal()
    bwd = phase_k2bwd_timing(exp2_per_s)
    with tempfile.TemporaryDirectory(prefix="bla_smoke_") as tmp:
        os.environ["BLA_DATA_DIR"] = tmp
        train_launches = phase_unet_train(tmp)
        flash_sites = phase_grad_oracle()
        phase_nhwc_remat(tmp, k2_launches, smi_line)
        del os.environ["BLA_DATA_DIR"]
        phase_graphs(tmp, smi_line)
    k3_err = phase_k3_vs_plain()
    phase_k3_build_info()
    k3 = phase_k3_timing(exp2_per_s)
    k3_launches = phase_k3_unet_sites(flash_sites)
    del flash_sites
    phase_graphs_legacy(smi_line)
    k3_rows = [{
        "name": "K3a flash attention fused backward (dq, dk, dv; stream=False)",
        "route": "cuda",
        "source": "big_linear_algebra_tpu_torch/csrc/flash_attn_bwd_fused.cu",
        "replaces": K3A_TPU_KERNEL,
        "launches": k3_launches["K3a"],
        "max_abs_err": k3_err["K3a"],
        "ms": k3["K3a"],
        "plain_ms": k3["plain"],
        "bound_ms": k3["bound"][0],
        "bound_by": k3["bound"][1],
        "library_ms": k3["sdpa"],
    }, {
        # the TPU's row-resident two-pass kernels compute what K2c and K2d
        # compute; row residency is a VMEM tiling the card does not have
        "name": "K3b/K3c flash attention two-pass backward (stream=False "
                "past the fused budget), launched as K2c + K2d",
        "route": "cuda",
        "source": "big_linear_algebra_tpu_torch/csrc/flash_attn_bwd.cu",
        "replaces": K3BC_TPU_KERNEL,
        "launches": k3_launches["K3bc"],
        "max_abs_err": k3_err["K3bc"],
        "ms": k3["K2c+K2d"],
        "plain_ms": k3["plain"],
        "bound_ms": k3["pair_bound"][0],
        "bound_by": k3["pair_bound"][1],
        "library_ms": k3["sdpa"],
    }]
    k4_row = {
        "name": "K4 implicit-GEMM conv (conv2d_implicit, conv2d_packed; "
                "forward and dx)",
        "route": "cuda",
        "source": "big_linear_algebra_tpu_torch/csrc/conv_implicit.cu",
        "replaces": K4_TPU_KERNEL,
        "launches": k4_launches["K4"],
        "max_abs_err": k4_err,
        "ms": k4["K4"],
        "plain_ms": k4["plain"],
        "bound_ms": k4["bound"],
        "bound_by": k4["bound_by"],
        "library_ms": k4["F.conv2d"],
    }
    bwd_rows = [{
        "name": f"{name} flash attention backward ({what})",
        "route": "cuda",
        "source": "big_linear_algebra_tpu_torch/csrc/flash_attn_bwd.cu",
        "replaces": tpu,
        "launches": train_launches[name],
        "max_abs_err": bwd_err[kern],
        "ms": bwd[kern],
        # the plain version and SDPA's backward compute dq, dk and dv in one
        # call: the same work as K2c and K2d together
        "plain_ms": bwd["plain"],
        "bound_ms": bwd["bound"][kern][0],
        "bound_by": bwd["bound"][kern][1],
        "library_ms": bwd["sdpa"],
    } for name, kern, what, tpu in (
        ("K2c", "dq", "dq", K2C_TPU_KERNEL),
        ("K2d", "dkv", "dk, dv", K2D_TPU_KERNEL))]
    k5_rows = [{
        "name": name,
        "route": "cuda",
        "source": f"big_linear_algebra_tpu_torch/csrc/{src}.cu",
        "replaces": tpu,
        "launches": launches,
        "max_abs_err": k5_err[err],
        "ms": ms,
        "plain_ms": plain,
        "bound_ms": bound[0],
        "bound_by": bound[1],
        # no single PyTorch call computes the block or its data gradients;
        # phase 12 prints the port's unfused block beside them
        "library_ms": library,
    } for name, src, ms, err, plain, bound, library, tpu, launches in (
        ("K5a fused resnet block forward, tensor-core route (bf16 at the "
         "U-Net's widths; launches: run 1 --fused-block)", "fused_block_tc",
         k5["K5a"], "K5a tc", k5["plain fwd"], k5["bound"]["fwd"], None,
         K5A_TPU_KERNEL, k5a_launches),
        ("K5a fused resnet block forward, FMA route (f32, and bf16 shapes "
         "the tensor cores do not take; launches: phase 14's f32 forward "
         "and gradient; time: bf16 forced onto it)", "fused_block",
         k5["K5a fma"], "K5a", k5["plain fwd"], k5["bound"]["fwd"], None,
         K5A_TPU_KERNEL, k5a_fma_launches),
        ("K5b fused resnet block recompute backward, data gradients, "
         "tensor-core route (bf16 at the U-Net's widths; launches: train 1 "
         "--fused-block; plain: the whole backward)", "fused_block_tc",
         k5b["data tc"], "K5b tc", k5b["plain bwd"],
         k5b["bound"]["data tc"], None, K5B_TPU_KERNEL, fused_train["K5b"]),
        ("K5b fused resnet block recompute backward, data gradients, FMA "
         "route (f32, and bf16 shapes the tensor cores do not take; "
         "launches: phase 14's f32 gradient; time: bf16 forced onto it; "
         "plain: the whole backward)", "fused_block", k5b["data fma"],
         "K5b data", k5b["plain bwd"], k5b["bound"]["data fma"], None,
         K5B_TPU_KERNEL, k5b_fma[0]),
        ("K5b fused resnet block recompute backward, weight gradients (dw1, "
         "dw2, dw3), tensor-core route (launches: train 1 --fused-block; "
         "plain: the whole backward; library: torch.nn.grad.conv2d_weight "
         "for each)", "fused_block_tc", k5b["wgrad tc"], "K5b tc wgrad",
         k5b["plain bwd"], k5b["bound"]["wgrad tc"], k5b["conv2d_weight"],
         K5B_TPU_KERNEL, fused_train["wgrad"]),
        ("K5b fused resnet block recompute backward, weight gradients, FMA "
         "route (after the FMA data gradients; launches: phase 14's f32 "
         "gradient; time: bf16 forced onto it; plain: the whole backward; "
         "library: torch.nn.grad.conv2d_weight for each)", "fused_block",
         k5b["wgrad fma"], "K5b wgrad", k5b["plain bwd"],
         k5b["bound"]["wgrad fma"], k5b["conv2d_weight"], K5B_TPU_KERNEL,
         k5b_fma[1]))]
    adam_row = {
        "name": "Adam in place, one multi-tensor pass (adam_update_at_; "
                "launches: train 1 --fused-block --scan-steps=5 "
                "--max-steps=30; time: the U-Net's 122 leaves; plain: "
                "adam_update_at and the copy-back; library: "
                "torch._fused_adam_)",
        "route": "cuda",
        "source": "big_linear_algebra_tpu_torch/csrc/adam.cu",
        "replaces": ADAM_TPU_KERNEL,
        "launches": adam["launches"],
        "max_abs_err": adam["err"],
        "ms": adam["ms"],
        "plain_ms": adam["plain_ms"],
        "bound_ms": adam["bound_ms"],
        "bound_by": "bytes",
        "library_ms": adam["library_ms"],
    }
    print(json.dumps({"kernels": [{
        "name": "K1 matmul (nn/nt/tn, bias+ReLU epilogue; launches: "
                "mnist_nn run and train 1; time: one batch-2048 forward)",
        "route": "cuda",
        "source": "big_linear_algebra_tpu_torch/csrc/matmul.cu",
        "replaces": TPU_KERNEL,
        "launches": k1_launches,
        "max_abs_err": f32_err,
        "ms": k1["kernel"],
        "plain_ms": k1["plain"],
        "bound_ms": k1["bound"],
        "bound_by": "operations",
        "library_ms": k1["torch.matmul"],
    }, {
        "name": "K2 flash attention forward (o, lse)",
        "route": "cuda",
        "source": "big_linear_algebra_tpu_torch/csrc/flash_attn.cu",
        "replaces": K2_TPU_KERNEL,
        "launches": k2_launches,
        "max_abs_err": k2_err,
        "ms": k2["kernel"],
        "plain_ms": k2["plain"],
        "bound_ms": k2["bound"],
        "bound_by": k2["bound_by"],
        "library_ms": k2["sdpa"],
    }, *bwd_rows, *k3_rows, k4_row, *k5_rows, adam_row]}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phase24-rank"]:  # one rank of phase 24
        raise SystemExit(_phase24_rank(*sys.argv[2:4]))
    if sys.argv[1:2] == ["--phase25-rank"]:  # one rank of phase 25
        raise SystemExit(_phase25_rank(*sys.argv[2:5]))
    if sys.argv[1:2] == ["--phase26-rank"]:  # one rank of phase 26's launch
        raise SystemExit(_p26_dp_rank(*sys.argv[2:4]))
    if sys.argv[1:2] == ["--phase27-counters"]:  # phase 27's cross-check
        raise SystemExit(_p27_counters_child())
    if sys.argv[1:2] == ["--phase28-rank"]:  # one rank of phase 28's launch
        raise SystemExit(_phase28_rank(*sys.argv[2:4]))
    raise SystemExit(main())
