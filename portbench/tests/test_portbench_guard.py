"""The import guard, and that the harness itself loads nothing it
forbids."""

import os
import subprocess
import sys

from portbench import harness
from portbench.tests import tiny


def test_names_are_compared_whole():
    found = harness.forbidden_modules([
        "jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
        "big_linear_algebra_tpu", "big_linear_algebra_tpu.ops.matmul",
        "big_linear_algebra_tpu_torch", "big_linear_algebra_tpu_torch.nn",
        "jaxtyping", "flaxen", "torch", "numpy"])
    assert found == sorted(["jax", "jax.numpy", "jaxlib.xla_client",
                            "flax.linen", "big_linear_algebra_tpu",
                            "big_linear_algebra_tpu.ops.matmul"])


def test_harness_and_program_load_nothing_forbidden():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.run, portbench.calibrate\n"
            "from portbench.drivers import train, sample\n"
            "from big_linear_algebra_tpu_torch.models import cifar_unet\n"
            "from portbench import harness\n"
            "print(harness.forbidden_modules())" % str(tiny.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_without_a_card_no_result_and_not_zero():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "cifar32_fused.train_b16", "--seed", "2147483659", "--seconds", "1",
         "--trace", "0"], cwd=tiny.ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no result" in out.stderr
