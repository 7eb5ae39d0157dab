"""The port's GEMM (K1) and its dispatch against the JAX package.

On the CPU the port's K1 takes its plain version; it is held against the
JAX Pallas kernel in interpret mode (f32, 2e-4 as tests/test_matmul.py) and
against the JAX dispatch in f64 (1e-10). The CUDA kernel itself runs only on
a card, where chip_smoke.py holds it against the plain version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from big_linear_algebra_tpu.ops.matmul import _dispatch as jax_dispatch
from big_linear_algebra_tpu.ops.matmul import _pallas_mm
from big_linear_algebra_tpu.ops.matmul import matmul, matmul_nt, matmul_tn
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
    """The backward is ported: ``matmul`` under autograd carries the
    hand-written gradient (g·Bᵀ, Aᵀ·g), while ``_dispatch`` itself, which
    records no graph, still raises under autograd and runs under
    ``torch.no_grad()``."""
    a = t(rng.standard_normal((4, 6))).requires_grad_()
    b = t(rng.standard_normal((6, 2))).requires_grad_()
    g = rng.standard_normal((4, 2))
    out = mm.matmul(a, b)
    assert out.requires_grad
    out.backward(t(g))
    np.testing.assert_allclose(n(a.grad), g @ n(b).T, rtol=1e-12)
    np.testing.assert_allclose(n(b.grad), n(a).T @ g, rtol=1e-12)
    with pytest.raises(RuntimeError, match="records no autograd graph"):
        mm._dispatch(a, b, "nn")
    with torch.no_grad():
        np.testing.assert_allclose(n(mm._dispatch(a, b, "nn")),
                                   n(a) @ n(b), rtol=1e-12)


# The variants ``_dispatch`` sees in each public op's backward (JAX's
# ``_matmul_bwd``): dA's GEMM, then dB's.
_BACKWARD_VARIANTS = {"nn": ["nt", "tn"], "nt": ["nn", "tn"],
                      "tn": ["nt", "nn"]}
_PORT_OPS = {"nn": mm.matmul, "nt": mm.matmul_nt, "tn": mm.matmul_tn}


def _vjp_both(variant, pa, pb, g):
    """(out, dA, dB) of the port's op through autograd and of the JAX op
    through ``jax.vjp``, on the same stored operands and cotangent."""
    jax_fn = {"nn": matmul, "nt": matmul_nt, "tn": matmul_tn}[variant]
    want, vjp = jax.vjp(jax_fn, jnp.asarray(pa), jnp.asarray(pb))
    wants = (want, *vjp(jnp.asarray(g)))
    a, b = (t(v).requires_grad_() for v in (pa, pb))
    out = _PORT_OPS[variant](a, b)
    out.backward(t(g))
    return (out, a.grad, b.grad), wants


@pytest.mark.parametrize("variant", ["nn", "nt", "tn"])
def test_backward_f64_matches_jax_vjp(rng, monkeypatch, variant):
    """Each op's hand-written gradients against ``jax.vjp`` of the JAX op in
    f64 (1e-10), at a shape past ``_SMALL_FLOPS`` (the rule keys on the
    dtype, so f64 takes the plain product); the backward's GEMMs reach
    ``_dispatch`` as the other two variants, in dA, dB order, and a gradient
    that is not asked for is not computed."""
    m, k, n_ = 96, 200, 130
    assert 2 * m * n_ * k >= mm._SMALL_FLOPS
    pa, pb = as_variant(rng.standard_normal((m, k)),
                        rng.standard_normal((k, n_)), variant)
    g = rng.standard_normal((m, n_))
    seen = []
    real = mm._dispatch

    def record(a, b, v, *rest, **kw):
        seen.append(v)
        return real(a, b, v, *rest, **kw)

    monkeypatch.setattr(mm, "_dispatch", record)
    got, wants = _vjp_both(variant, pa, pb, g)
    assert seen == [variant] + _BACKWARD_VARIANTS[variant]
    for x, w in zip(got, wants):
        assert x.dtype == torch.float64
        np.testing.assert_allclose(n(x), n(w), rtol=1e-10, atol=1e-10)
    seen.clear()
    b = t(pb).requires_grad_()
    _PORT_OPS[variant](t(pa), b).backward(t(g))
    assert seen == [variant, _BACKWARD_VARIANTS[variant][1]]


# The five K1 GEMMs of an mnist_nn train step at batch 64 (stored operand
# shapes, as ``_dispatch`` sees them): the forwards of layers 1 and 2, layer
# 2's data gradient, and the weight gradients of layers 1 and 2.
TRAIN_STEP_GEMMS = [("nn", (64, 784), (784, 256)),
                    ("nn", (64, 256), (256, 128)),
                    ("nt", (64, 128), (256, 128)),
                    ("tn", (64, 784), (64, 256)),
                    ("tn", (64, 256), (64, 128))]


@pytest.mark.parametrize("variant,a_shape,b_shape", TRAIN_STEP_GEMMS)
def test_backward_f32_train_step_shapes_match_pallas_interpret(
        rng, variant, a_shape, b_shape):
    """At each of the train step's K1 shapes, f32: the op and both of its
    gradients against ``jax.vjp`` of the JAX op, whose GEMMs there reach the
    Pallas kernel in interpret mode (2e-4, as tests/test_matmul.py); the
    port's go to its plain K1 on these CPU tensors."""
    a = rng.random(a_shape).astype(np.float32)
    b = ((rng.random(b_shape) * 2 - 1) * 0.1).astype(np.float32)
    m, n_, k = mm._VARIANTS[variant]["shapes"](a, b)
    assert 2 * m * n_ * k >= mm._SMALL_FLOPS
    g = (rng.standard_normal((m, n_)) * 0.01).astype(np.float32)
    got, wants = _vjp_both(variant, a, b, g)
    for x, w in zip(got, wants):
        assert x.dtype == torch.float32
        np.testing.assert_allclose(n(x), n(w), rtol=2e-4, atol=2e-4)


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
