"""Time K4's fast forms against its general forms on one card: bf16's
16-byte staging (``VecStager``) against element staging, and f32's row
reuse (``conv_f32<.., true>``) against per-tap loads.

    python3 tools/conv_form_check.py

``csrc/conv_implicit.cu`` is built twice: as the port builds it, and with
``-DBLA_CONV_GENERAL_FORMS``, which makes both kernels take their general
form at every geometry. At each of ``chip_smoke.K4_TIMED`` in bf16 and f32,
both builds run K4's forward through the port's wrapper; their outputs must
be bit-equal (the forms stage the same values and sum in the same order),
and their device times are taken in turns (fast, general, general, fast),
the lower of each pair kept. Exit code 1 if any output differs.
"""

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402


def _general_library():
    """``csrc/conv_implicit.cu`` built with ``-DBLA_CONV_GENERAL_FORMS``
    beside the port's libraries, loaded with ctypes."""
    import ctypes

    from big_linear_algebra_tpu_torch.ops import cuda_utils

    so = cuda_utils.library_path("conv_implicit").with_name(
        "libconv_implicit_general_forms.so")
    cmd = [cuda_utils.nvcc(), *cuda_utils.NVCC_FLAGS,
           "-DBLA_CONV_GENERAL_FORMS", "-o", str(so),
           str(cuda_utils.CSRC / "conv_implicit.cu")]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"building {so.name} failed ({' '.join(cmd)}):\n"
                           f"{done.stdout}{done.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.bla_cuda_error_string.restype = ctypes.c_char_p
    lib.bla_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def main() -> int:
    import torch

    from big_linear_algebra_tpu_torch.nn import conv_implicit as ci
    from big_linear_algebra_tpu_torch.ops import cuda_utils

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 1
    cuda_utils.build(["conv_implicit"])
    libs = {"fast": cuda_utils.load_library("conv_implicit"),
            "general": _general_library()}

    def run(form, x, kr):
        # the wrapper loads the library it finds under the source's name
        cuda_utils._libs["conv_implicit"] = libs[form]
        return ci._launch(x, kr)

    print(chip_smoke.phase_environment()[0], flush=True)
    gen = torch.Generator().manual_seed(16)
    bad = 0
    for b, c, h, w, f, k in chip_smoke.K4_TIMED:
        for dtype in (torch.bfloat16, torch.float32):
            x, kr, _ = chip_smoke._k4_inputs(b, c, h, w, f, k, dtype, gen)
            outs = {form: run(form, x, kr) for form in libs}
            torch.cuda.synchronize()
            equal = torch.equal(outs["fast"], outs["general"])
            bad += not equal
            runs = {form: [] for form in libs}
            for form in ("fast", "general", "general", "fast"):
                runs[form].append(chip_smoke._time_ms(
                    lambda: run(form, x, kr), iters=50, warmup=3)[0])
            ms = {form: min(r) for form, r in runs.items()}
            cuda_utils._libs["conv_implicit"] = libs["fast"]
            plan = chip_smoke._k4_plan(dtype, b, c, h, w, f, k)
            print(f"[K4 forms] {str(dtype)[6:]} B={b} C={c} {h}x{w} F={f} "
                  f"k={k} (fast form taken: {bool(plan['fast'])}): device "
                  f"fast {ms['fast'] * 1e3:.2f} us (runs "
                  + ", ".join(f"{t * 1e3:.2f}" for t in runs["fast"])
                  + f"), general {ms['general'] * 1e3:.2f} us (runs "
                  + ", ".join(f"{t * 1e3:.2f}" for t in runs["general"])
                  + f"), general/fast {ms['general'] / ms['fast']:.3f}; "
                  f"outputs bit-equal: {equal}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
