"""The port's GEMM (K1) and its dispatch against the JAX package.

On the CPU the port's K1 takes its plain version; it is held against the
JAX Pallas kernel in interpret mode (f32, 2e-4 as tests/test_matmul.py) and
against the JAX dispatch in f64 (1e-10). The CUDA kernel itself runs only on
a card, where chip_smoke.py holds it against the plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from big_linear_algebra_tpu.ops.matmul import _dispatch as jax_dispatch
from big_linear_algebra_tpu.ops.matmul import _pallas_mm
from big_linear_algebra_tpu_torch.ops import cuda_utils
from big_linear_algebra_tpu_torch.ops import matmul as mm
from tests.torch_parity import as_variant, n, t


@pytest.mark.parametrize("variant", ["nn", "nt", "tn"])
@pytest.mark.parametrize("mnk", [(256, 384, 128), (130, 257, 200)])
def test_plain_k1_matches_pallas_interpret(rng, variant, mnk):
    """Above the dispatch threshold, on CPU tensors: the port's plain K1
    against the Pallas kernel in interpret mode, ragged shapes included."""
    m, k, n_ = mnk
    pa, pb = as_variant(rng.standard_normal((m, k)),
                        rng.standard_normal((k, n_)), variant)
    pa, pb = pa.astype(np.float32), pb.astype(np.float32)
    want = _pallas_mm(jnp.asarray(pa), jnp.asarray(pb), variant,
                      (128, 128, 128), jnp.float32)
    got = mm._dispatch(t(pa), t(pb), variant)
    assert got.dtype == torch.float32 and got.shape == (m, n_)
    np.testing.assert_allclose(n(got), n(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("variant", ["nn", "nt", "tn"])
@pytest.mark.parametrize("epilogue", [(False, None), (True, None),
                                      (True, "relu")])
def test_dispatch_f64_matches_jax(rng, variant, epilogue):
    use_bias, act = epilogue
    for m, k, n_ in [(17, 23, 9), (96, 80, 64)]:
        pa, pb = as_variant(rng.standard_normal((m, k)),
                            rng.standard_normal((k, n_)), variant)
        bias = rng.standard_normal((n_,)) if use_bias else None
        want = jax_dispatch(jnp.asarray(pa), jnp.asarray(pb), variant, None,
                            None, bias=None if bias is None
                            else jnp.asarray(bias), activation=act)
        got = mm._dispatch(t(pa), t(pb), variant,
                           bias=None if bias is None else t(bias),
                           activation=act)
        assert got.dtype == torch.float64
        np.testing.assert_allclose(n(got), n(want), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("m,k,n_,dtype", [(200, 300, 170, "float32"),
                                          (256, 512, 384, "bfloat16")])
def test_fused_bias_relu_epilogue(rng, m, k, n_, dtype):
    """As tests/test_matmul.py's epilogue test: fused bias+ReLU equals the
    composed ops (1e-6), and equals the JAX fused kernel (interpret mode)."""
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n_)).astype(np.float32)
    b = rng.standard_normal((n_,)).astype(np.float32)
    tdt = getattr(torch, dtype)
    tx, tw, tb = t(x, tdt), t(w, tdt), t(b, tdt)
    fused = mm._dispatch(tx, tw, "nn", torch.float32, bias=tb,
                         activation="relu")
    composed = torch.clamp_min(
        mm._dispatch(tx, tw, "nn", torch.float32) + tb.float()[None, :], 0.0)
    np.testing.assert_allclose(n(fused), n(composed), rtol=1e-6, atol=1e-6)
    jdt = getattr(jnp, dtype)
    want = jax_dispatch(jnp.asarray(x, jdt), jnp.asarray(w, jdt), "nn", None,
                        jnp.float32, bias=jnp.asarray(b, jdt),
                        activation="relu")
    np.testing.assert_allclose(n(fused), n(want), rtol=2e-4, atol=2e-4)


def test_public_variants_and_errors(rng):
    a = rng.standard_normal((5, 7))
    b = rng.standard_normal((7, 3))
    np.testing.assert_allclose(n(mm.matmul(t(a), t(b))), a @ b, rtol=1e-12)
    np.testing.assert_allclose(n(mm.matmul_nt(t(a), t(b.T))), a @ b,
                               rtol=1e-12)
    np.testing.assert_allclose(n(mm.matmul_tn(t(a.T), t(b))), a @ b,
                               rtol=1e-12)
    with pytest.raises(ValueError, match="incompatible shapes"):
        mm.matmul(torch.zeros(3, 4), torch.zeros(5, 6))
    with pytest.raises(ValueError, match="2-D"):
        mm.matmul(torch.zeros(3, 4, 1), torch.zeros(4, 6))
    with pytest.raises(ValueError, match="activation"):
        mm._dispatch(t(a), t(b), "nn", activation="gelu")


def test_requires_grad_raises_until_backward_is_ported(rng):
    a = t(rng.standard_normal((4, 6))).requires_grad_()
    b = t(rng.standard_normal((6, 2)))
    with pytest.raises(RuntimeError, match="forward-only"):
        mm.matmul(a, b)
    with torch.no_grad():
        np.testing.assert_allclose(n(mm.matmul(a, b)), n(a) @ n(b),
                                   rtol=1e-12)


def test_kernel_wrapper_rejects_cpu_tensors_and_missing_nvcc(monkeypatch):
    """The kernel path never takes a CPU tensor, and a missing compiler
    raises instead of falling back."""
    a = torch.zeros(256, 128)
    with pytest.raises(ValueError, match="CUDA device"):
        mm._kernel_mm(a, torch.zeros(128, 256), "nn", torch.float32)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_utils.nvcc()


def test_build_keeps_the_ptxas_log(monkeypatch, tmp_path):
    """``build`` passes ``-Xptxas -v`` and keeps what nvcc printed beside
    the library, where ``build_log`` reads it without rebuilding."""
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    fake = home / "bin" / "nvcc"
    fake.write_text('#!/bin/sh\ncase "$*" in *"-Xptxas -v"*) ;; *) exit 1;; '
                    'esac\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    ': > "$2"\necho "ptxas info    : Used 42 registers"\n')
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setattr(cuda_utils, "BUILD_DIR", tmp_path / "build")
    log = cuda_utils.build_log("flash_attn_bwd")
    assert "Used 42 registers" in log
    assert cuda_utils.library_path("flash_attn_bwd").is_file()
    fake.write_text("#!/bin/sh\nexit 1\n")  # a rebuild would now fail
    assert cuda_utils.build_log("flash_attn_bwd") == log


def test_build_hash_covers_the_headers(monkeypatch, tmp_path):
    """An edited ``csrc/*.cuh`` header changes the library path of every
    source (a stale library would otherwise load); an untouched one does
    not."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "kern.cu").write_text('#include "helpers.cuh"\n')
    header = csrc / "helpers.cuh"
    header.write_text("// v1\n")
    monkeypatch.setattr(cuda_utils, "CSRC", csrc)
    first = cuda_utils.library_path("kern")
    assert cuda_utils.library_path("kern") == first
    header.write_text("// v2\n")
    assert cuda_utils.library_path("kern") != first
    header.write_text("// v1\n")
    assert cuda_utils.library_path("kern") == first
