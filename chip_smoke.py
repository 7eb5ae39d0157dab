"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (or a few); any failure exits non-zero:
1. environment: the card's name and power limit, torch and CUDA versions;
   fails when no CUDA device is available;
2. build: compiles both kernels from ``big_linear_algebra_tpu_torch/csrc/``
   with nvcc, one process per source, started together: the GEMM (K1,
   ``matmul.cu``) and flash attention (K2, ``flash_attn.cu``);
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
   time.
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

MAIN_SHAPES = [(2048, 784, 256), (2048, 256, 128), (2048, 128, 10)]  # M, K, N
RAGGED_SHAPE = (130, 257, 200)
TPU_KERNEL = "big_linear_algebra_tpu/ops/matmul.py:220"
K2_TPU_KERNEL = "big_linear_algebra_tpu/nn/attention.py:545"
K2_SHAPES = [(1, 1024), (2, 300), (1, 4096), (1, 16384)]  # B, N
K2_MAIN = (1, 1024, 16)  # B, N, d at the U-Net's four flash sites, 64x64
K2_TIMED = [K2_MAIN, (4, 4096, 64)]

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

    names = ("matmul", "flash_attn")
    t0 = time.perf_counter()
    cuda_utils.build(names)
    for name in names:
        cuda_utils.load_library(name)
    print(f"[2 build] csrc/matmul.cu and csrc/flash_attn.cu built in "
          f"parallel and loaded in {time.perf_counter() - t0:.2f} s ("
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
            p = cu._tree_map(lambda a: a.to("cuda", getattr(torch, dt)),
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
                p = cu._tree_map(lambda a: a.to("cuda", getattr(torch, dt)),
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


def phase_unet_step(cu, cfg, params, x, n_fwd=5) -> None:
    """One bf16 forward (a sampling step's network): host wall time per
    forward without the profiler, then a ``torch.profiler`` trace of
    ``n_fwd`` forwards reduced by ``trace_summary.py`` (device busy per
    forward and the largest device entries)."""
    import trace_summary

    p = cu._tree_map(lambda a: a.to("cuda", torch.bfloat16), params)
    tb = torch.tensor([500], dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        for _ in range(3):
            cu.forward(p, x, tb, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            cu.forward(p, x, tb, cfg)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / 10
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(n_fwd):
                cu.forward(p, x, tb, cfg)
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="bla_trace_") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            summary = trace_summary.summarize(json.load(f), top=8)
    busy_ms = float(re.search(r"device busy ([0-9.]+) ms",
                              summary).group(1)) / n_fwd
    print(f"[7 unet step] one bf16 full-width 64x64 forward (a sampling "
          f"step's network): host wall {host_ms:.3f} ms per forward "
          f"(synchronised, no profiler); device busy {busy_ms:.3f} ms per "
          f"forward = {busy_ms / host_ms:.1%} of that; trace of {n_fwd} "
          f"forwards (trace_summary.py):\n    "
          + summary.replace("\n", "\n    "), flush=True)


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
        del os.environ["BLA_DATA_DIR"]
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
    }]}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
