"""Check the GEMM (K1) and the flash-attention forward (K2) on one card,
without the rest of ``chip_smoke.py``: phase 3's and phase 5's cases
against the plain versions, two runs bit-equal, the kernels' registers,
shared memory, spills (and HMMA for K2), and the timings beside the plain
versions and the library calls; then phase 8's K2c/K2d build record and
timing, which share K2's header.

    python3 tools/gemm_flash_fwd_check.py [group ...]

With arguments, only the groups named run (K1, K2, K2c/K2d, K1 sweep).

Each group runs even if an earlier one failed; the exit code is 1 if any
failed.
"""

import os
import sys
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402


def _mm_with_splits(a, b, bias, act, splits: int):
    """K1 nn in f32 with the K split over ``splits`` cluster ranks
    (``bla_matmul_with_splits``), for timing the rule's alternatives."""
    import ctypes

    import torch
    from big_linear_algebra_tpu_torch.ops import cuda_utils

    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    lib = cuda_utils.load_library("matmul")
    fn = lib.bla_matmul_with_splits
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
                   + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    rc = fn(0, 0, 0, a.data_ptr(), b.data_ptr(), bias.data_ptr(),
            int(act == "relu"), out.data_ptr(), m, n, k, splits,
            torch.cuda.current_stream().cuda_stream)
    cuda_utils.check(lib, rc, "bla_matmul_with_splits")
    return out


def k1_sweep() -> None:
    """K1 f32 nn at each mnist_nn layer, in the rule's block shape, with
    the K split over 1, 2, 4 and 8 cluster ranks; each checked against the
    rule's result (the f32 bound), with the clusters the card holds at
    once."""
    import torch
    from big_linear_algebra_tpu_torch.ops import matmul as mm

    max_clusters = chip_smoke._int_fn("matmul", "bla_matmul_max_clusters", 4)
    gen = torch.Generator().manual_seed(1)
    for i, (m, k, n) in enumerate(chip_smoke.MAIN_SHAPES):
        a, b, bias = chip_smoke._operands("nn", m, k, n, torch.float32, gen)
        act = "relu" if i < 2 else None
        want = mm._kernel_mm(a, b, "nn", torch.float32, bias, act)
        tol = chip_smoke.f32_bound(a, b, k)
        shape = 1 if n <= 16 else 0  # the rule's block shape
        parts = []
        for splits in (1, 2, 4, 8):
            got = _mm_with_splits(a, b, bias, act, splits)
            err = (got - want).abs().max().item()
            if not err <= tol:
                chip_smoke.fail(f"{splits} splits: err {err} > {tol}")
            t = chip_smoke._time_ms(
                lambda: _mm_with_splits(a, b, bias, act, splits))[0]
            parts.append(f"{chip_smoke.K1_SHAPES[shape]} x{splits} "
                         f"{t * 1e3:.2f} (max clusters "
                         f"{max_clusters(shape, 0, 0, splits)})")
        print(f"[K1 sweep] M={m} K={k} N={n} (us): " + ", ".join(parts),
              flush=True)


def main() -> int:
    from big_linear_algebra_tpu_torch.ops import cuda_utils

    smi_line, exp2_per_s = chip_smoke.phase_environment()
    cuda_utils.build(("matmul", "flash_attn", "flash_attn_bwd"))
    groups = {
        "K1": (chip_smoke.phase_k1_build_info,
               chip_smoke.phase_kernel_vs_plain,
               chip_smoke.phase_tf32_control,
               chip_smoke.phase_k1_bitequal,
               chip_smoke.phase_timing),
        "K2": (chip_smoke.phase_k2_build_info,
               chip_smoke.phase_k2_vs_plain,
               chip_smoke.phase_k2_bitequal,
               lambda: chip_smoke.phase_k2_timing(exp2_per_s)),
        "K2c/K2d": (chip_smoke.phase_k2bwd_build_info,
                    lambda: chip_smoke.phase_k2bwd_timing(exp2_per_s)),
        "K1 sweep": (k1_sweep,),
    }
    if sys.argv[1:]:  # only the groups named
        groups = {g: groups[g] for g in sys.argv[1:]}
    failed = []
    for group, phases in groups.items():
        try:
            for phase in phases:
                phase()
        except (SystemExit, Exception):  # report and go on to the next group
            traceback.print_exc(limit=3)
            failed.append(group)
    print(smi_line, flush=True)
    if failed:
        print(f"FAILED: {failed}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
