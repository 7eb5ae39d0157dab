"""Time the tensor-core K5a's phases apart on one card: builds
``csrc/fused_block_tc.cu`` a second time with ``-DBLA_K5A_STAMPS`` (each
phase boundary then waits on a block barrier and records ``clock64()`` in
the first and the last block), runs it once at each shape below after
timing the normal build with CUDA events, and prints each phase's
microseconds at the card's maximum SM clock.

    python3 tools/k5a_phases.py
"""

import ctypes
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402

PHASES = ("x loaded", "GN 1", "conv_1", "h1t + GN 2 sums", "GN 2 barrier",
          "d", "barrier A", "d pushed", "barrier B", "conv_2 (+ w3)",
          "epilogue")
SHAPES = [(1, 256, 256, 8, 8, 32), (1, 512, 256, 8, 8, 32),
          (16, 256, 256, 8, 8, 32), (15, 256, 256, 8, 8, 32),
          (16, 512, 256, 4, 4, 32)]


def main() -> int:
    from big_linear_algebra_tpu_torch.nn import fused_block as fb
    from big_linear_algebra_tpu_torch.ops import cuda_utils

    smi_line, _ = chip_smoke.phase_environment()
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    mhz = float(clock.stdout.strip().splitlines()[0])
    cuda_utils.build(["fused_block_tc"])
    so = cuda_utils.BUILD_DIR / "libfused_block_tc_stamps.so"
    built = subprocess.run(
        [cuda_utils.nvcc(), *cuda_utils.NVCC_FLAGS, "-DBLA_K5A_STAMPS",
         "-o", str(so), str(cuda_utils.CSRC / "fused_block_tc.cu")],
        capture_output=True, text=True)
    if built.returncode != 0:
        chip_smoke.fail(f"stamped build failed:\n{built.stdout}{built.stderr}")
    stamped = ctypes.CDLL(str(so))
    stamped.bla_cuda_error_string.restype = ctypes.c_char_p
    stamped.bla_cuda_error_string.argtypes = [ctypes.c_int]
    normal = cuda_utils.load_library("fused_block_tc")
    gen = torch.Generator().manual_seed(1)
    for b, c, f, h, w, gsz in SHAPES:
        *ops, _ = chip_smoke._k5_inputs(b, c, f, h, w, torch.bfloat16, gen)
        args = (*ops, fb._seed_tensor(5, "cuda"), gsz, chip_smoke.K5_RATE,
                b > 1, 1e-8)
        cuda_utils._libs["fused_block_tc"] = normal
        ms, host = chip_smoke._time_ms(
            lambda: fb._kernel_fused_fwd(*args, route="tc"), 100, 5)
        cuda_utils._libs["fused_block_tc"] = stamped
        try:
            fb._kernel_fused_fwd(*args, route="tc")
            torch.cuda.synchronize()
        finally:
            cuda_utils._libs["fused_block_tc"] = normal
        out = (ctypes.c_longlong * 24)()
        if stamped.bla_k5a_stamps(out) != 0:
            chip_smoke.fail("reading the stamps failed")
        for k, which in enumerate(("first", "last")):
            st = out[12 * k:12 * k + 12]
            print(f"[K5a phases] bf16 B={b} C={c} F={f} {h}x{w}: kernel "
                  f"{ms * 1e3:.2f} us (host {host * 1e3:.2f} us); {which} "
                  f"block, stamped build, {(st[11] - st[0]) / mhz:.2f} us: "
                  + ", ".join(f"{name} {(st[i + 1] - st[i]) / mhz:.2f}"
                              for i, name in enumerate(PHASES)), flush=True)
    print(smi_line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
