"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (or a few), in the order 1–7, 16–18, 11–15, 8–10,
19–21; any failure exits non-zero:
1. environment: the card's name and power limit, torch and CUDA versions;
   fails when no CUDA device is available;
2. build: compiles the kernels from ``big_linear_algebra_tpu_torch/csrc/``
   with nvcc, one process per source, started together: the GEMM (K1,
   ``matmul.cu``), flash attention (K2, ``flash_attn.cu``), its backward
   (K2c and K2d, ``flash_attn_bwd.cu``), the fused resnet block (K5a,
   K5b, ``fused_block.cu``), the fused flash backward (K3a,
   ``flash_attn_bwd_fused.cu``) and the implicit-GEMM conv (K4,
   ``conv_implicit.cu``);
3. K1 against plain, on the card: nn/nt/tn x f32/bf16 x
   {no epilogue, bias, bias+ReLU} at the three mnist_nn layer shapes and a
   ragged one, against the plain PyTorch version with TF32 off; a TF32
   product at the layer shapes must fail the f32 bound; then the
   kernel's time beside the plain version's and torch.matmul's (CUDA events,
   after warm-up);
4. mnist_nn main path: ``mnist_nn init`` then ``mnist_nn run`` on the
   2048-image synthesized test set in a temporary data directory, with K1's
   launch count read around it; the eval is recomputed on the CPU in f64 by
   the plain path from the same checkpoint;
5. K2 against plain, on the card: f32/bf16 x d in {16, 64} x (B, N) in
   {(1, 1024) the U-Net's shape, (2, 300) ragged, (1, 4096), (1, 16384)},
   and the other head dims the kernel takes at (2, 300); o and lse against
   ``_plain_flash``; then the kernel's time beside the plain version's and
   ``F.scaled_dot_product_attention``'s, the library yardstick;
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
   in {(16, 1024) the train step's shape, (2, 300) ragged, (1, 4096)}, and
   the other head dims at (2, 300); dq, dk, dv against
   ``_plain_flash_bwd`` on the same (q, k, v, o, lse, g); then each
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
   8x8) and a TINY-width one; the kernels' dropout bits bit-equal to the
   plain version's;
12. K5 timing: K5a and K5b beside the plain versions and the port's
   unfused block (cuDNN convs, GN), at the train step's and the sampler's
   8x8 blocks, with the bounds;
13. ``cifar_unet run 1 --fused-block`` at 32x32 (full width, 1000 DDPM
   steps) from phase 6's checkpoint, with K5a's launches read around it;
   a non-constant 32x32 BMP;
14. fused oracle: one f32 full-width 32x32 forward with the fused blocks
   against the same forward unfused (bounded) and f64 (reported); then one
   f32 train-mode gradient at batch 16: K5b against the plain backward on
   every fused block's operands (bounded), the gradient's leaves against
   the one with the plain backward at those blocks (reported);
15. ``cifar_unet train 1 --fused-block --max-steps=30`` at batch 16 (9
   fused blocks: up_2 resnet_1 fails the gate) with the launches of K5a
   and K5b read around it; finite losses, the last 10 steps' mean below
   the first 10's; then one resumed step;
16. K4 against plain, on the card: ``conv2d_implicit`` and
   ``conv2d_packed`` (forward and dx, two launches each) against the plain
   tap sum, f32/bf16 at the U-Net's 3x3 maps at batch 16 (32x32 to 4x4) and
   a non-square 5x5 case;
17. K4 timing beside the plain version and ``F.conv2d`` at (16, 128,
   32x32) and (16, 256, 16x16), bf16 and f32, with the bounds;
18. K4 at the U-Net's sites: every stride-1 3x3 conv of one f32 32x32
   forward at batch 16 from phase 6's checkpoint, through both entry points
   (forward, dx, dk) against ``conv2d`` in f64, with K4's launches read
   around them; then ``conv2d_im2col`` at one site, with K1's nn, tn and
   nt launches;
19. K3 against plain, on the card: ``flash_attention(..., stream=False)``
   through autograd against ``_plain_flash_bwd``, f32/bf16 x d 16, 64 x
   (B, N) (2, 300), (16, 1024) x blocks (512, 1024), (384, 256), on the
   fused route (K3a) and with the budget at 0 on the two-pass route (K2c +
   K2d); two K3a runs bit-equal; a bf16 case at |s| ~ 1e5 finite;
20. K3 timing: K3a beside K2c + K2d, the plain backward and SDPA's backward
   at (16, 1024, 16) and (4, 4096, 64), bf16, with the bounds;
21. K3 at the U-Net's sites: phase 10's four flash sites through
   ``flash_attention(..., stream=False)`` (K3a, then the two-pass route),
   with the launches read around them, against the plain backward.
Then a JSON line of per-kernel results, the ``nvidia-smi`` name/power-limit
line, and as the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
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
K5A_TPU_KERNEL = "big_linear_algebra_tpu/nn/fused_block.py:396"
K5B_TPU_KERNEL = "big_linear_algebra_tpu/nn/fused_block.py:441"
# (B, C, F, H, W, group size): the train step's 8x8 block, up_1 resnet_1 at
# batch 16, up_2 resnet_1 in sampling, and a TINY-width block
K5_SHAPES = [(16, 256, 256, 8, 8, 32), (16, 512, 256, 4, 4, 32),
             (1, 512, 256, 8, 8, 32), (2, 24, 12, 8, 8, 4)]
K5_TIMED = [(16, 256, 256, 8, 8, 32), (1, 256, 256, 8, 8, 32)]
# one example fewer than the train step: 15 clusters of 8 blocks
K5_WAVE = (15, 256, 256, 8, 8, 32)
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

MAIN_SHAPES = [(2048, 784, 256), (2048, 256, 128), (2048, 128, 10)]  # M, K, N
RAGGED_SHAPE = (130, 257, 200)
TPU_KERNEL = "big_linear_algebra_tpu/ops/matmul.py:220"
K2_TPU_KERNEL = "big_linear_algebra_tpu/nn/attention.py:545"
K2_SHAPES = [(1, 1024), (2, 300), (1, 4096), (1, 16384)]  # B, N
K2_MAIN = (1, 1024, 16)  # B, N, d at the U-Net's four flash sites, 64x64
K2_TIMED = [K2_MAIN, (4, 4096, 64)]
K2C_TPU_KERNEL = "big_linear_algebra_tpu/nn/attention.py:662"
K2D_TPU_KERNEL = "big_linear_algebra_tpu/nn/attention.py:682"
K2BWD_SHAPES = [(16, 1024), (2, 300), (1, 4096)]  # B, N
K2BWD_MAIN = (16, 1024, 16)  # B, N, d at the flash sites of a train step
K2BWD_TIMED = [K2BWD_MAIN, (4, 4096, 64)]
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
             "flash_attn_bwd_fused", "conv_implicit")
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
    for m, k, n in MAIN_SHAPES + [RAGGED_SHAPE]:
        for variant in ("nn", "nt", "tn"):
            for dtype in (torch.float32, torch.bfloat16):
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
    print(f"[3 kernel vs plain] {n_cases} cases pass: f32 max abs err "
          f"{worst_abs:.3e}, worst err / bound {worst[torch.float32]:.3f} "
          f"(bound {F32_ULPS}*K*max|a|*max|b|*2^-24); bf16 max err / "
          f"max|ref| {worst[torch.bfloat16]:.3e} (tol {BF16_RTOL_OF_MAX})",
          flush=True)
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


def _bound(nbytes: float, ops_s: float):
    """(ms, what bounds it): the larger of the bytes over the HBM rate and
    ``ops_s``, the operations' time at their peak rate."""
    bytes_s = nbytes / HBM_BYTES_PER_S
    if bytes_s >= ops_s:
        return bytes_s * 1e3, "bytes"
    return ops_s * 1e3, "operations"


def k1_bound_ms(m: int, k: int, n: int):
    """K1 nn f32 with a bias: A, B and the bias read once, C written once;
    2·M·N·K flops at the f32 CUDA-core peak."""
    nbytes = 4 * (m * k + k * n + n + m * n)
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
    worst_abs = 0.0
    worst = {"f32 o err/tol": 0.0, "bf16 o err/max|ref|": 0.0, "lse": 0.0}
    bad = []
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for b, n, d in cases:
            q, k, v = _k2_inputs(b, n, d, dtype, gen)
            o, lse = at._kernel_flash(q, k, v)
            want_o, want_lse = at._plain_flash(q, k, v)
            torch.cuda.synchronize()
            case = f"{str(dtype)[6:]} B={b} N={n} d={d}"
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
          f"(B, N) {K2_SHAPES}, and d {[d for _, _, d in cases[8:]]} at "
          f"(2, 300)): worst f32 o err/(atol {K2_F32_ATOL} + rtol "
          f"{K2_F32_RTOL}*|ref|) {worst['f32 o err/tol']:.3f}, worst bf16 o "
          f"err/max|ref| {worst['bf16 o err/max|ref|']:.3e} (tol "
          f"{K2_BF16_RTOL_OF_MAX}), worst lse abs err {worst['lse']:.3e} "
          f"(tol {K2_LSE_ATOL}), worst o abs err {worst_abs:.3e}",
          flush=True)
    return worst_abs


def phase_k2_timing(exp2_per_s: float) -> dict:
    """bf16 at the U-Net's flash shape and at (4, 4096, 64): the kernel,
    the plain version and SDPA (on (B, 1, N, d), one head, so that PyTorch
    may pick its fused backends), in turns within this one process; the
    lower of each pair is kept. Returns the main shape's numbers."""
    import torch.nn.functional as F

    from big_linear_algebra_tpu_torch.nn import attention as at

    gen = torch.Generator().manual_seed(4)
    names = ("kernel", "plain", "sdpa")
    main = {}
    for b, n, d in K2_TIMED:
        q, k, v = _k2_inputs(b, n, d, torch.bfloat16, gen)
        q4, k4, v4 = (x[:, None] for x in (q, k, v))
        fns = {"kernel": lambda: at._kernel_flash(q, k, v),
               "plain": lambda: at._plain_flash(q, k, v),
               "sdpa": lambda: F.scaled_dot_product_attention(q4, k4, v4)}
        runs = {name: [] for name in names}
        for name in names + names[::-1]:
            runs[name].append(_time_ms(fns[name]))
        ms = {name: min(dv for dv, _ in runs[name]) for name in names}
        host = {name: min(h for _, h in runs[name]) for name in names}
        bound, bound_by = k2_bound_ms(b, n, d, torch.bfloat16, exp2_per_s)
        tflops = 4 * b * n * n * d / (ms["kernel"] * 1e-3) / 1e12
        print(f"[5 K2 timing] bf16 B={b} N={n} d={d}: device kernel "
              f"{ms['kernel'] * 1e3:.2f} us ({tflops:.2f} TFLOP/s), plain "
              f"{ms['plain'] * 1e3:.2f} us, SDPA {ms['sdpa'] * 1e3:.2f} us; "
              f"bound {bound * 1e3:.3f} us ({bound_by}; {b * n * n} exp2, "
              f"{4 * b * n * n * d} flops) | host per call: kernel "
              f"{host['kernel'] * 1e3:.2f} us, plain "
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
    """(host ms per call, device busy ms per call, trace summary) of
    ``fn``: host wall time per call over ``timed`` calls ending in a
    synchronise, without the profiler; then a ``torch.profiler`` trace of
    ``n_traced`` calls reduced by ``trace_summary.py``."""
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
            summary = trace_summary.summarize(json.load(f), top=8)
    busy_ms = float(re.search(r"device busy ([0-9.]+) ms",
                              summary).group(1)) / n_traced
    return host_ms, busy_ms, summary


def phase_unet_step(cu, cfg, params, x, n_fwd=5) -> None:
    """One bf16 forward (a sampling step's network): host wall time per
    forward without the profiler, then a ``torch.profiler`` trace of
    ``n_fwd`` forwards reduced by ``trace_summary.py`` (device busy per
    forward and the largest device entries)."""
    p = cu.tree_map(lambda a: a.to("cuda", torch.bfloat16), params)
    tb = torch.tensor([500], dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        host_ms, busy_ms, summary = _host_and_trace(
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
        for b, n, d in cases:
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
          f"x (B, N) {K2BWD_SHAPES}, and d {[d for _, _, d in cases[6:]]} at "
          f"(2, 300)); dq, dk, dv each: worst f32 err/(atol {K2BWD_F32_ATOL}"
          f" + rtol {K2BWD_F32_RTOL}*|ref|) {worst[torch.float32]:.3f}, "
          f"worst bf16 err/max|ref| {worst[torch.bfloat16]:.3e} (tol "
          f"{K2BWD_BF16_RTOL_OF_MAX}); worst abs err dq "
          f"{worst_abs['dq']:.3e}, dk/dv {worst_abs['dkv']:.3e}", flush=True)
    return worst_abs


def phase_k2bwd_timing(exp2_per_s: float) -> dict:
    """bf16 at the train step's flash shape and at (4, 4096, 64): K2c and
    K2d each on prepared operands, the wrapper (prep + both kernels), the
    plain backward and SDPA's backward (``torch.autograd.grad`` through
    ``F.scaled_dot_product_attention`` on (B, 1, N, d)), in turns within
    this one process; the lower of each pair is kept. Returns the main
    shape's numbers."""
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


def _unet_grad(cu, params, x0, tt, noise, cfg):
    """(loss, {path: gradient}) of ``cu.loss_fn`` on the card with the
    draws given, the parameters cast to the compute dtype first."""
    dt = getattr(torch, cfg.compute_dtype)
    leaves = cu.tree_map(
        lambda a: a.to("cuda", dt).requires_grad_(), params)
    loss = cu.loss_fn(leaves, x0.to("cuda", dt), tt.cuda(),
                      noise.to("cuda", dt), cfg)
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


def _condition_attention(cu, params, x0, tt, noise, cfg):
    """A copy of ``params`` with each attention site's q and k projections
    scaled by f = min(1, sqrt(GRAD_SCORE_RANGE / w)), w the widest row of
    its scores q.k^T/sqrt(d) in an f32 forward on the given draws. A site's
    factor is applied in that forward before the sites after it are
    measured. Returns (params, {site: (w, f)})."""
    import math

    params = cu.tree_map(lambda a: a.to("cuda", torch.float32), params)
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
            cu.loss_fn(params, x0.cuda(), tt.cuda(), noise.cuda(), cfg)
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

    host_ms, busy_ms, summary = _host_and_trace(step, n_steps)
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
    worst_abs = {"K5a": 0.0, "K5b": 0.0}
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    names = ("out", "dx", "d_td", "dw1", "dw2", "dw3")
    worst_f32 = dict.fromkeys(names, 0.0)  # per output, err/tol
    plain_f32 = dict.fromkeys(names, 0.0)  # the plain f32 version's
    bad = []
    n_cases = 0
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
                        kern = "K5a" if name == "out" else "K5b"
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
          f"{worst_abs['K5b']:.3e}", flush=True)
    return worst_abs


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
    """bf16 at the train step's 8x8 block (B=16, train) and the sampler's
    (B=1, eval): K5a, K5b (both of its kernels), the plain versions and the
    port's unfused block forward and backward (autograd through its
    hand-written VJPs), in turns within this one process; the lower of each
    pair is kept. Returns the train shape's numbers."""
    from big_linear_algebra_tpu_torch.nn import fused_block as fb

    gen = torch.Generator().manual_seed(9)
    main = {}
    for b, c, f, h, w, gsz in K5_TIMED:
        train = b > 1
        x, td, w1, w2, w3, g = _k5_inputs(b, c, f, h, w, torch.bfloat16, gen)
        args = (x, td, w1, w2, w3, fb._seed_tensor(5, "cuda"), gsz, K5_RATE,
                train, 1e-8)
        cgen = torch.Generator(device="cuda").manual_seed(0)
        leaves = [a.detach().requires_grad_() for a in (x, td, w1, w2)]
        out = _unfused_block(*leaves, None, cgen, train, gsz)
        fns = {"K5a": lambda: fb._kernel_fused_fwd(*args),
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
        print(f"[12 K5 timing] bf16 B={b} C={c} F={f} {h}x{w} train={train}:"
              f" device K5a {ms['K5a'] * 1e3:.2f} us (bound "
              f"{bounds['fwd'][0] * 1e3:.3f} us, {bounds['fwd'][1]}), plain "
              f"{ms['plain fwd'] * 1e3:.2f} us, unfused block "
              f"{ms['unfused fwd'] * 1e3:.2f} us; K5b (data + weight "
              f"gradients) {ms['K5b'] * 1e3:.2f} us (bound "
              f"{bounds['bwd'][0] * 1e3:.3f} us, {bounds['bwd'][1]}), plain "
              f"{ms['plain bwd'] * 1e3:.2f} us, unfused backward "
              f"{ms['unfused bwd'] * 1e3:.2f} us | host per call: K5a "
              f"{host['K5a'] * 1e3:.2f} us, K5b {host['K5b'] * 1e3:.2f} us, "
              f"unfused fwd {host['unfused fwd'] * 1e3:.2f} us, bwd "
              f"{host['unfused bwd'] * 1e3:.2f} us", flush=True)
        if (b, c, f, h, w, gsz) == K5_TIMED[0]:
            main = dict(ms, bound=bounds)
    b, c, f, h, w, gsz = K5_WAVE
    x, td, w1, w2, w3, g = _k5_inputs(b, c, f, h, w, torch.bfloat16, gen)
    args = (x, td, w1, w2, w3, fb._seed_tensor(5, "cuda"), gsz, K5_RATE,
            True, 1e-8)
    wave = {"K5a": _time_ms(lambda: fb._kernel_fused_fwd(*args), 50, 5)[0],
            "K5b": _time_ms(lambda: fb._kernel_fused_bwd(*args, g), 50,
                            5)[0]}
    print(f"[12 K5 timing] bf16 B={b} C={c} F={f} {h}x{w} train=True (one "
          f"cluster of {fb._plan(b, c, f, h, w, 3, gsz)[0]} blocks fewer "
          f"than the train step): device K5a {wave['K5a'] * 1e3:.2f} us, "
          f"K5b {wave['K5b'] * 1e3:.2f} us", flush=True)
    return main


def _fused_counts(fb) -> tuple:
    return fb.launch_count, fb.bwd_launch_count, fb.wgrad_launch_count


def _zero_fused_counts(fb) -> None:
    fb.launch_count = fb.bwd_launch_count = fb.wgrad_launch_count = 0


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
    if rc != 0:
        fail(f"cifar_unet run --fused-block exited {rc}:\n{out.getvalue()}")
    steps = cu.CONFIG.timesteps
    if (k5a, k5b, wgrad) != (FUSED_PER_RUN_STEP * steps, 0, 0):
        fail(f"run --fused-block launched K5a/K5b/weight gradients "
             f"{(k5a, k5b, wgrad)} times, expected "
             f"({FUSED_PER_RUN_STEP * steps}, 0, 0)")
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
          f"steps, bf16 compute) {run_s:.2f} s wall: K5a launches {k5a} "
          f"({FUSED_PER_RUN_STEP} per step; K2 {at.launch_count}); "
          f"samples/sample_0.bmp 32x32, bytes {lo}..{hi}", flush=True)
    return k5a


def phase_fused_oracle() -> None:
    """From phase 6's checkpoint at 32x32: the f32 forward (batch 1) with
    the fused blocks against the same forward unfused (bounded) and against
    f64 (reported); then one f32 train-mode gradient at batch 16 with the
    fused blocks, K5b against the plain backward on each fused block's
    operands (bounded), and its leaves against the gradient with the plain
    backward at those blocks, on the same dropout seeds (reported)."""
    import dataclasses

    from big_linear_algebra_tpu_torch.models import cifar_unet as cu
    from big_linear_algebra_tpu_torch.nn import fused_block as fb

    params = cu.load_params_csv(cu.CONFIG)
    gen = torch.Generator().manual_seed(10)
    x = torch.randn(1, 3, 32, 32, generator=gen).cuda()
    tb = torch.tensor([500], device="cuda")
    outs = {}
    with torch.inference_mode():
        for name, dt, fused in (("fused", "float32", True),
                                ("unfused", "float32", False),
                                ("f64", "float64", False)):
            cfg = dataclasses.replace(cu.CONFIG, compute_dtype=dt,
                                      fused_block=fused)
            p = cu.tree_map(lambda a: a.to("cuda", getattr(torch, dt)),
                             params)
            _zero_fused_counts(fb)
            outs[name] = cu.forward(p, x, tb, cfg).double()
            torch.cuda.synchronize()
            if fb.launch_count != (FUSED_PER_RUN_STEP if fused else 0):
                fail(f"the {name} forward launched K5a {fb.launch_count} "
                     "times")
    if not all(torch.isfinite(o).all() for o in outs.values()):
        fail("non-finite U-Net outputs")
    scale = outs["unfused"].abs().max().item()
    share = (outs["fused"] - outs["unfused"]).abs().max().item() / scale
    f64_scale = outs["f64"].abs().max().item()
    vs_f64 = {k: (outs[k] - outs["f64"]).abs().max().item() / f64_scale
              for k in ("fused", "unfused")}
    if not share <= K5_UNET_RTOL_OF_MAX:
        fail(f"f32 forward with the fused blocks differs from the unfused "
             f"one by {share:.3e} of max|ref| (tol {K5_UNET_RTOL_OF_MAX})")

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
        counts = _fused_counts(fb)
        fb._kernel_fused_bwd = fb._plain_fused_bwd
        loss_p, grads_p = grad()
    finally:
        fb._kernel_fused_bwd = kernel
    per = FUSED_PER_TRAIN_STEP
    if counts != (per, per, per) or len(sites) != per:
        fail(f"the f32 train-mode gradient launched K5a/K5b/weight "
             f"gradients {counts} times over {len(sites)} fused blocks, "
             f"expected {per} each")
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
    print(f"[14 fused oracle] full-width 32x32 f32 forward, t=500: with the "
          f"10 fused blocks vs unfused err/max|ref| {share:.3e} (tol "
          f"{K5_UNET_RTOL_OF_MAX}); reported, no bound: fused vs f64 "
          f"{vs_f64['fused']:.3e}, unfused vs f64 {vs_f64['unfused']:.3e} "
          f"of max|ref| {f64_scale:.3f}. f32 train-mode gradient at batch "
          f"16, {per} fused blocks: K5b vs plain on each block's operands, "
          f"worst err/(atol {K5_GRAD_ATOL} + rtol {K5_GRAD_RTOL}*|ref|) "
          f"{worst_site:.3e} (tol 1); reported, no bound: the gradient "
          f"through K5b vs with the plain backward at the fused blocks, "
          f"worst leaf {leaves[0]:.3e} of its max|ref|, {leaves[1]:.3e} of "
          f"the largest max|ref|, median leaf {leaves[2]:.3e}; losses "
          f"{loss_k:.6f}, {loss_p:.6f}", flush=True)


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
    if (k5a, k5b, wgrad) != (want, want, want):
        fail(f"train --fused-block launched K5a/K5b/weight gradients "
             f"{(k5a, k5b, wgrad)} times in {FUSED_TRAIN_STEPS} steps, "
             f"expected {want} each ({FUSED_PER_TRAIN_STEP} per step)")
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
          f"({ep0['images_per_sec']} images/s): launches K5a {k5a}, K5b "
          f"{k5b}, K5b weight gradients {wgrad}; loss mean of steps 1-10 "
          f"{head:.5f}, of steps {FUSED_TRAIN_STEPS - 9}-{FUSED_TRAIN_STEPS} "
          f"{tail:.5f}; then '{resumed}', step loss "
          f"{vals[-1].item():.5f}", flush=True)
    return {"K5a": k5a, "K5b": k5b}


def _k4_inputs(b, c, h, w, f, k, dtype, gen):
    """x ~ N(0, 1) (B, C, H, W), He-normal kernels (F, C, k, k) and a
    cotangent g ~ N(0, 1) (B, F, H, W), made on the CPU from ``gen``, on the
    card."""
    x = torch.randn(b, c, h, w, generator=gen)
    kr = torch.randn(f, c, k, k, generator=gen) * (2.0 / (k * k * c)) ** 0.5
    g = torch.randn(b, f, h, w, generator=gen)
    return tuple(a.to("cuda", dtype) for a in (x, kr, g))


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
    if bad:
        fail(f"{len(bad)} K4 outputs disagree with the plain version:\n  "
             + "\n  ".join(bad))
    print(f"[16 K4 vs plain] {n_cases} cases pass (conv2d_implicit and "
          f"conv2d_packed x f32/bf16 x (B, C, H, W, F, k) {K4_SHAPES}; "
          f"forward and dx): worst f32 err/bound {worst[torch.float32]:.3f} "
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


def phase_k4_timing() -> dict:
    """K4 (through ``conv2d_implicit``'s wrapper), the plain tap sum and
    ``F.conv2d`` (cuDNN, TF32 off for f32) as the library call, at the
    U-Net's 32x32 and 16x16 maps in bf16 and f32, in turns within this one
    process; the lower of each pair is kept. Returns the bf16 32x32
    numbers."""
    import torch.nn.functional as F

    from big_linear_algebra_tpu_torch.nn import conv_implicit as ci

    gen = torch.Generator().manual_seed(16)
    names = ("K4", "plain", "F.conv2d")
    main = {}
    for b, c, h, w, f, k in K4_TIMED:
        for dtype in (torch.bfloat16, torch.float32):
            x, kr, _ = _k4_inputs(b, c, h, w, f, k, dtype, gen)
            fns = {"K4": lambda: ci._kernel_implicit(x, kr),
                   "plain": lambda: ci._plain_conv(x, kr),
                   "F.conv2d": lambda: F.conv2d(x, kr, padding=k // 2)}
            runs = {name: [] for name in names}
            for name in names + names[::-1]:
                runs[name].append(_time_ms(fns[name], iters=20, warmup=3))
            ms = {name: min(d for d, _ in runs[name]) for name in names}
            bound, bound_by = k4_bound_ms(b, c, h, w, f, k, dtype)
            flops = 2 * b * f * h * w * c * k * k
            print(f"[17 K4 timing] {str(dtype)[6:]} B={b} C={c} {h}x{w} F={f} "
                  f"k={k}: device K4 {ms['K4'] * 1e3:.2f} us "
                  f"({flops / (ms['K4'] * 1e-3) / 1e12:.2f} TFLOP/s), plain "
                  f"{ms['plain'] * 1e3:.2f} us, F.conv2d "
                  f"{ms['F.conv2d'] * 1e3:.2f} us; bound {bound * 1e3:.3f} us "
                  f"({bound_by}; {flops} flops)", flush=True)
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
    Then ``conv2d_im2col`` forward and backward at the first 32x32 site
    whose input and output channels match (128 at full width), bounded the
    same way, with K1's launches and variants.
    Returns {"K4": launches, "K1": launches}."""
    import dataclasses

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
          f"{worst['im2col']:.3e} (tol 1)", flush=True)
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


def phase_k3_vs_plain() -> dict:
    """``flash_attention(..., stream=False)`` through autograd against
    ``_plain_flash_bwd`` on every case, on the fused route (K3a) and with
    the budget at 0 on the two-pass route (K2c/K2d standing for the TPU's
    K3b/K3c), each call's launches checked; two K3a runs bit-equal; a bf16
    case at |s| ~ 1e5 finite. Returns the worst abs errors ({"K3a": ..,
    "K3bc": ..})."""
    from big_linear_algebra_tpu_torch.nn import attention as at

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
    want = at._plain_flash_bwd(q, k, v, o, lse, g)
    max_s = _score_overshoot(at, q, k, lse)[0]
    large = max(_k3_ratio(x, y) for x, y in zip(got, want))
    if not all(bool(torch.isfinite(x).all()) for x in got) or large > 1.0:
        bad.append(f"bf16 at max|s| {max_s:.4g}: K3a finite "
                   f"{[bool(torch.isfinite(x).all()) for x in got]}, err/tol "
                   f"{large}")
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
          f"K3a runs at {K3_MAIN} bit-equal (f32, bf16): {equal}. bf16 at "
          f"max|s| {max_s:.4g} (log2 units): finite, err/tol {large:.3e}",
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


def phase_k3_timing(exp2_per_s: float) -> dict:
    """bf16 at the train step's flash shape and at (4, 4096, 64): K3a and
    K2c + K2d on prepared operands, the plain backward and SDPA's backward,
    in turns within this one process; the lower of each pair is kept.
    Returns the main shape's numbers."""
    import torch.nn.functional as F

    from big_linear_algebra_tpu_torch.nn import attention as at
    from big_linear_algebra_tpu_torch.ops import cuda_utils

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
        tiles = cuda_utils.load_library(
            "flash_attn_bwd_fused").bla_flash_bwd_fused_tiles(n, d)
        print(f"[20 K3 timing] bf16 B={b} N={n} d={d}: device K3a "
              f"{ms['K3a'] * 1e3:.2f} us (bound {bound[0] * 1e3:.3f} us, "
              f"{bound[1]}; dq workspace {tiles * b * n * d * 4 / 1e6:.1f} "
              f"MB), K2c + K2d {ms['K2c+K2d'] * 1e3:.2f} us (bound "
              f"{pair[0] * 1e3:.3f} us), plain backward "
              f"{ms['plain'] * 1e3:.2f} us, SDPA backward "
              f"{ms['sdpa'] * 1e3:.2f} us ({b * n * n} exp2, "
              f"{10 * b * n * n * d} flops)", flush=True)
        if (b, n, d) == K3_MAIN:
            main = dict(ms, bound=bound, pair_bound=pair)
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


def main() -> int:
    smi_line, exp2_per_s = phase_environment()
    phase_build()
    f32_err = phase_kernel_vs_plain()
    phase_tf32_control()
    k1 = phase_timing()
    k1_launches = phase_main_path()
    k2_err = phase_k2_vs_plain()
    k2 = phase_k2_timing(exp2_per_s)
    with tempfile.TemporaryDirectory(prefix="bla_smoke_") as tmp:
        os.environ["BLA_DATA_DIR"] = tmp
        k2_launches = phase_unet_main_path(tmp)
        phase_unet_oracle()
        k4_err = phase_k4_vs_plain()
        k4 = phase_k4_timing()
        k4_launches = phase_k4_unet_sites()
        k5_err = phase_k5_vs_plain()
        k5 = phase_k5_timing()
        k5a_launches = phase_unet_fused_run(tmp)
        phase_fused_oracle()
        fused_train = phase_unet_fused_train()
        del os.environ["BLA_DATA_DIR"]
    bwd_err = phase_k2bwd_vs_plain()
    bwd = phase_k2bwd_timing(exp2_per_s)
    with tempfile.TemporaryDirectory(prefix="bla_smoke_") as tmp:
        os.environ["BLA_DATA_DIR"] = tmp
        train_launches = phase_unet_train(tmp)
        flash_sites = phase_grad_oracle()
        del os.environ["BLA_DATA_DIR"]
    k3_err = phase_k3_vs_plain()
    k3 = phase_k3_timing(exp2_per_s)
    k3_launches = phase_k3_unet_sites(flash_sites)
    del flash_sites
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
        "source": "big_linear_algebra_tpu_torch/csrc/fused_block.cu",
        "replaces": tpu,
        "launches": launches,
        "max_abs_err": k5_err[kern],
        "ms": k5[kern],
        "plain_ms": k5[f"plain {way}"],
        "bound_ms": k5["bound"][way][0],
        "bound_by": k5["bound"][way][1],
        # no single PyTorch call computes the block; phase 12 prints the
        # port's unfused block beside it
        "library_ms": None,
    } for name, kern, way, tpu, launches in (
        ("K5a fused resnet block forward", "K5a", "fwd", K5A_TPU_KERNEL,
         k5a_launches),
        ("K5b fused resnet block recompute backward (data and weight "
         "gradients)", "K5b", "bwd", K5B_TPU_KERNEL, fused_train["K5b"]))]
    print(json.dumps({"kernels": [{
        "name": "K1 matmul (nn/nt/tn, bias+ReLU epilogue)",
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
    }, *bwd_rows, *k3_rows, k4_row, *k5_rows]}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
