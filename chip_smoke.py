"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:
1. environment: the card's name and power limit, torch and CUDA versions;
   fails when no CUDA device is available;
2. build: compiles the GEMM kernel (K1) from
   ``big_linear_algebra_tpu_torch/csrc/matmul.cu`` with nvcc;
3. kernel against plain, on the card: nn/nt/tn x f32/bf16 x
   {no epilogue, bias, bias+ReLU} at the three mnist_nn layer shapes and a
   ragged one, against the plain PyTorch version with TF32 off; a TF32
   product at the layer shapes must fail the f32 bound; then the
   kernel's time beside the plain version's and torch.matmul's (CUDA events,
   after warm-up);
4. main path: ``mnist_nn init`` then ``mnist_nn run`` on the 2048-image
   synthesized test set in a temporary data directory, with the kernel's
   launch count read around it; the eval is recomputed on the CPU in f64 by
   the plain path from the same checkpoint.
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

MAIN_SHAPES = [(2048, 784, 256), (2048, 256, 128), (2048, 128, 10)]  # M, K, N
RAGGED_SHAPE = (130, 257, 200)
TPU_KERNEL = "big_linear_algebra_tpu/ops/matmul.py:220"


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def phase_environment() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(f"[1 environment] card: {smi_line} | torch {torch.__version__} "
          f"| CUDA {torch.version.cuda} | python {sys.version.split()[0]}",
          flush=True)
    return smi_line


def phase_build() -> None:
    from big_linear_algebra_tpu_torch.ops import cuda_utils

    t0 = time.perf_counter()
    cuda_utils.load_library("matmul")
    print(f"[2 build] csrc/matmul.cu built and loaded in "
          f"{time.perf_counter() - t0:.2f} s "
          f"({cuda_utils.library_path('matmul').name})", flush=True)


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
    print(f"[3 timing] one mnist_nn forward (3 layers, batch 2048), device: "
          f"kernel {totals['kernel'] * 1e3:.2f} us, plain "
          f"{totals['plain'] * 1e3:.2f} us, torch.matmul "
          f"{totals['torch.matmul'] * 1e3:.2f} us; host per forward: kernel "
          f"{host_totals['kernel'] * 1e3:.2f} us, plain "
          f"{host_totals['plain'] * 1e3:.2f} us", flush=True)
    return totals


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


def main() -> int:
    smi_line = phase_environment()
    phase_build()
    f32_err = phase_kernel_vs_plain()
    phase_tf32_control()
    totals = phase_timing()
    launches = phase_main_path()
    print(json.dumps({"kernels": [{
        "name": "K1 matmul (nn/nt/tn, bias+ReLU epilogue)",
        "route": "cuda",
        "source": "big_linear_algebra_tpu_torch/csrc/matmul.cu",
        "replaces": TPU_KERNEL,
        "launches": launches,
        "max_abs_err": f32_err,
        "ms": totals["kernel"],
        "plain_ms": totals["plain"],
    }]}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
